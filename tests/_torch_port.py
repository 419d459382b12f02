"""Shared set-up of the port's parity tests (tests/test_torch_*.py): the
JAX model and the port's model at one golden tier, built from the same
committed fixture."""

from __future__ import annotations

import numpy as np
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
