"""Shared NN primitives of the DDPM and ADM UNets (port of
ddnm_tpu/models/nn.py).

Public functions take NHWC tensors, as the JAX ones do. Modules inside the
UNet hold NCHW tensors in channels_last memory, which is the NHWC byte
order: `x.permute(0, 2, 3, 1)` of such a tensor is a contiguous NHWC view,
so the NHWC kernels and cuDNN's channels_last convolutions share buffers
without copies.

Gradients (classifier guidance differentiates the classifier with respect
to its input): with grad enabled and an input that requires grad,
`GroupNormF32` and `attention` go through `ops.GroupNormFunction` and
`ops.AttentionFunction`, whose backward runs the backward kernels on a
card. Under `torch.no_grad`, or when no input requires grad, they call the
forward alone and save nothing, as every sampler does. GroupNormFunction
gives dx only, so a GroupNorm whose affine or FiLM requires grad (a model
that is not frozen) raises on every route.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ddnm_tpu_torch.ops import AttentionFunction, GroupNormFunction, fused_attention, group_norm

__all__ = [
    "swish",
    "timestep_embedding_ddpm",
    "timestep_embedding_adm",
    "GroupNormF32",
    "avg_pool2",
    "nearest_upsample",
    "attention",
    "cast_torso",
]


def swish(x):
    return x * torch.sigmoid(x)


def timestep_embedding_ddpm(timesteps, embedding_dim: int):
    """Sin-first sinusoidal embedding (float32), the DDPM family's order."""
    half_dim = embedding_dim // 2
    emb = math.log(10000) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                 device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def timestep_embedding_adm(timesteps, dim: int, max_period: int = 10000):
    """Cos-first sinusoidal embedding (float32), the ADM family's order:
    frequencies exp(-log(max_period) * i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class GroupNormF32(nn.Module):
    """GroupNorm computed in fp32 whatever the input dtype, cast back.

    Takes and returns NCHW tensors; the work runs on the NHWC view through
    `ops.group_norm`. Its affine (`weight`, `bias`, named as the reference
    checkpoints name them) stays fp32 under a bf16 torso (`cast_torso`).
    `force` is handed to ops.group_norm (None: the kernel on a card).

    `swish=True` applies SiLU to the normalised value inside the same pass
    (the apply kernel's epilogue on a card, `_torch_group_norm(swish=True)`
    on the CPU): the JAX UNet's norm followed by `swish`. In fp32 that is
    the same function as `swish(norm(x))` (ddnm_tpu/ops/groupnorm.py
    `_xla_group_norm(swish=True)`), to about 1 ulp. In bf16 the SiLU runs in
    fp32 on the rounded norm and rounds once, where `x * torch.sigmoid(x)`
    on a bf16 tensor rounds the sigmoid and then the product: they differ by
    at most 1 bf16 ulp per element.

    `forward(x, film_scale, film_shift)` takes the ADM ResBlock's FiLM
    (B, C) scale and shift, applied after the normalisation as
    y * (1 + scale) + shift, before the SiLU, in the same two launches."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 swish: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.swish = swish
        self.force: str | None = None
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, film_scale=None, film_shift=None):
        nhwc = x.permute(0, 2, 3, 1)
        if not nhwc.is_contiguous():
            nhwc = nhwc.contiguous()
        if _needs_grad(nhwc, film_scale, film_shift):
            y = GroupNormFunction.apply(nhwc, self.weight, self.bias, film_scale, film_shift,
                                        self.num_groups, self.eps, self.swish,
                                        self.force or ("kernel" if nhwc.is_cuda else "torch"))
            return y.permute(0, 3, 1, 2)
        y = group_norm(nhwc, self.weight, self.bias, num_groups=self.num_groups,
                       eps=self.eps, swish=self.swish, film_scale=film_scale,
                       film_shift=film_shift, force=self.force)
        return y.permute(0, 3, 1, 2)


def avg_pool2(x):
    """2x2 mean pool of an NCHW tensor (the ADM ResBlock's down path)."""
    return torch.nn.functional.avg_pool2d(x, 2)


def nearest_upsample(x, factor: int = 2):
    """Nearest-neighbour upsample on NHWC (== F.interpolate nearest)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
    return x.reshape(b, h * factor, w * factor, c)


def attention(q, k, v, scale: float, force: str | None = None):
    """Scaled dot-product attention over (B*, T, C) token grids, fp32
    softmax; dispatches through ops.fused_attention, or through
    ops.AttentionFunction where a gradient is wanted."""
    if _needs_grad(q, k, v):
        return AttentionFunction.apply(q, k, v, scale,
                                       force or ("kernel" if q.is_cuda else "torch"))
    return fused_attention(q, k, v, scale, force=force)


def _needs_grad(*tensors) -> bool:
    """Grad mode is on and one of `tensors` (None allowed) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def cast_torso(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast floating parameters to `dtype` in place, EXCEPT GroupNorm
    affines, which stay fp32 (the fp32 GroupNorm of a bf16 torso), and the
    own parameters of a module marked `keep_fp32` (a layer that JAX
    computes in fp32 under a bf16 classifier)."""
    for module in model.modules():
        if isinstance(module, GroupNormF32) or getattr(module, "keep_fp32", False):
            continue
        for p in module.parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return model
