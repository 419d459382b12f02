"""Models of the port: the DDPM UNet, the ADM UNet and their primitives."""

from ddnm_tpu_torch.models.convert import params_from_flax
from ddnm_tpu_torch.models.nn import cast_torso
from ddnm_tpu_torch.models.unet_adm import ADMUNet
from ddnm_tpu_torch.models.unet_ddpm import DDPMUNet

__all__ = ["ADMUNet", "DDPMUNet", "cast_torso", "params_from_flax"]
