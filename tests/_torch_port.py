"""Shared set-up of the port's parity tests (tests/test_torch_*.py): the
JAX model and the port's model at one golden tier, built from the same
committed fixture."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests._golden import MID64, TOY32, _trainer, load_our_model

TIERS = {"toy32": TOY32, "mid64": MID64}


def port_arch(tier) -> dict:
    """DDPMUNet kwargs of a golden tier, read from its trainer module."""
    mod = _trainer(tier)
    if hasattr(mod, "DDPM_KW"):
        return dict(mod.DDPM_KW)
    return dict(ch=mod.CH, ch_mult=mod.CH_MULT, num_res_blocks=mod.NUM_RES_BLOCKS,
                attn_resolutions=mod.ATTN, resolution=mod.RES)


def port_model(tier, state_dict=None):
    """The port's DDPMUNet with the tier's fixture (or `state_dict`) loaded."""
    from ddnm_tpu_torch.models import DDPMUNet
    from ddnm_tpu_torch.runner import load_checkpoint

    model = DDPMUNet(**port_arch(tier)).eval()
    if state_dict is None:
        load_checkpoint(model, tier.fixture)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model


def jax_model(tier):
    """(model_fn(params, x, t), params) of the JAX package, fp32."""
    return load_our_model(tier)


def zero_noise_torch(gens, shape):
    return torch.zeros(shape, dtype=torch.float32)


def x_T(n: int, res: int) -> np.ndarray:
    """The golden protocol's shared initial noise, NHWC."""
    x = np.random.RandomState(42).randn(n, 3, res, res).astype(np.float32)
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's torch ops on one intra-op thread: toy sizes gain
    nothing from more, and the suite's workers share the machine's cores
    (idle OpenMP threads of one worker spin while the others wait)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# A cut of configs/imagenet_256_cc.yml (the class-conditional ADM guided by
# its classifier, in the same sections) at 64 px, the smallest size whose
# classifier channel_mult the reference's create_classifier defines: the
# UNet 32 channels wide, the classifier 64, one res block each, attention
# at 16 px, 3 steps, batch 1, the ImageNet folder exp/datasets/imagenet.
TOY_CC_CONFIG = """\
data: { dataset: ImageNet, image_size: 64, channels: 3, rescaled: true }
model:
  type: openai
  num_channels: 32
  num_res_blocks: 1
  num_heads: 4
  num_head_channels: 32
  attention_resolutions: "16"
  channel_mult: "1,2,2"
  use_scale_shift_norm: true
  resblock_updown: true
  learn_sigma: true
  class_cond: true
classifier:
  classifier_width: 64
  classifier_depth: 1
  classifier_attention_resolutions: "16"
  classifier_pool: attention
  classifier_resblock_updown: true
  classifier_use_scale_shift_norm: true
  classifier_scale: 1.0
diffusion: { beta_schedule: linear, beta_start: 1.0e-4, beta_end: 0.02, num_diffusion_timesteps: 1000 }
time_travel: { T_sampling: 3, travel_length: 1, travel_repeat: 1 }
sampling: { batch_size: 1 }
"""


def write_toy_cc_config(path):
    """TOY_CC_CONFIG written to `path`; returns the path."""
    path.write_text(TOY_CC_CONFIG)
    return path
