"""Models of the port: the DDPM UNet, the ADM UNet, its classifier and
their primitives."""

from ddnm_tpu_torch.models.convert import params_from_flax
from ddnm_tpu_torch.models.nn import cast_torso, shard_spatially
from ddnm_tpu_torch.models.unet_adm import (
    ADMClassifier,
    ADMSuperResModel,
    ADMUNet,
    classifier_guidance_fn,
    classifier_guidance_from_params,
    init_like_flax,
)
from ddnm_tpu_torch.models.unet_ddpm import DDPMUNet

__all__ = ["ADMClassifier", "ADMSuperResModel", "ADMUNet", "DDPMUNet", "cast_torso",
           "classifier_guidance_fn", "classifier_guidance_from_params", "init_like_flax",
           "params_from_flax",
           "shard_spatially"]
