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
forward alone and save nothing, as every sampler does. In training (the
model's parameters require grad) GroupNormFunction also returns the
gradients of the norm's affine and FiLM (the backward finalize kernel
on a card); a sharded GroupNorm (ShardedGroupNormFunction) still gives dx only
and raises for an affine that requires grad.

Spatial shards (parallel/spatial.py): `shard_spatially(model, group)`
gives every 3x3 convolution, GroupNorm and attention of a UNet the
spatial group of its process, which then holds only its block of the
map's rows: a convolution takes its halo rows from its neighbours
(parallel/halo.py), a GroupNorm the whole map's statistics, an attention
the keys and values of every shard. The weights stay where they are.
With grad (a sharded classifier under guidance) each exchange carries its
gradient back: the halo rows' to their senders (`halo.HaloPad`), the
GroupNorm's through the whole map's sums (`ops.ShardedGroupNormFunction`),
the attention's dK and dV partials summed over the shards in rank order
(`parallel.spatial.gather_shards`), so each shard's input gradient is its
rows of the unsharded one.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from torch.nn import functional as F

from ddnm_tpu_torch.ops import AttentionFunction, GroupNormFunction, fused_attention, group_norm
from ddnm_tpu_torch.ops.groupnorm import ShardedGroupNormFunction
from ddnm_tpu_torch.parallel import halo
from ddnm_tpu_torch.parallel.spatial import gather_shards

__all__ = [
    "shard_spatially",
    "halo_conv3x3",
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
    y * (1 + scale) + shift, before the SiLU, in the same two launches.

    `spatial` (set by `shard_spatially`): x is this process's rows of a
    map split over that group, normalised with the whole map's
    statistics (ops.group_norm's spatial path; with grad
    ops.ShardedGroupNormFunction). `replicated` (a norm that runs on
    values every rank holds whole, as the spatial_v2 pool's): never
    sharded."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 swish: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.swish = swish
        self.force: str | None = None
        self.spatial = None
        self.replicated = False
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, film_scale=None, film_shift=None):
        nhwc = x.permute(0, 2, 3, 1)
        if not nhwc.is_contiguous():
            nhwc = nhwc.contiguous()
        if self.spatial is not None:
            if _needs_grad(nhwc, film_scale, film_shift):
                y = ShardedGroupNormFunction.apply(
                    nhwc, self.weight, self.bias, film_scale, film_shift, self.num_groups,
                    self.eps, self.swish, self.force or ("kernel" if nhwc.is_cuda else "torch"),
                    self.spatial)
                return y.permute(0, 3, 1, 2)
            y = group_norm(nhwc, self.weight, self.bias, num_groups=self.num_groups,
                           eps=self.eps, swish=self.swish, film_scale=film_scale,
                           film_shift=film_shift, force=self.force, spatial=self.spatial)
            return y.permute(0, 3, 1, 2)
        if _needs_grad(nhwc, film_scale, film_shift, self.weight, self.bias):
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


def attention(q, k, v, scale: float, force: str | None = None, spatial=None):
    """Scaled dot-product attention over (B*, T, C) token grids, fp32
    softmax; dispatches through ops.fused_attention, or through
    ops.AttentionFunction where a gradient is wanted. `spatial`: q, k, v
    are this process's tokens (a contiguous block of the row-major
    sequence) of a map split over that group; its queries attend to the
    keys and values of every shard, gathered in rank order (one
    all_gather), through the kernel's Tq != Tk launch; with grad, the
    shard's dq is its own and its dK, dV of every key are partials, which
    the gather's backward sums over the shards in rank order and then
    keeps this shard's block of."""
    if spatial is not None:
        kv = gather_shards(torch.stack([k, v]), spatial, 2, "attention", "attention_grad")
        k, v = (t.contiguous() for t in kv.unbind(0))
        if _needs_grad(q, k, v):
            return AttentionFunction.apply(q, k, v, scale,
                                           force or ("kernel" if q.is_cuda else "torch"))
        return fused_attention(q, k, v, scale, force=force)
    if _needs_grad(q, k, v):
        return AttentionFunction.apply(q, k, v, scale,
                                       force or ("kernel" if q.is_cuda else "torch"))
    return fused_attention(q, k, v, scale, force=force)


def _needs_grad(*tensors) -> bool:
    """Grad mode is on and one of `tensors` (None allowed) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def halo_conv3x3(x, weight, bias, spatial=None):
    """A stride-1 3x3 convolution with padding 1 of an NCHW map, or of
    this process's rows of a map split over `spatial`: F.conv2d(halo(x),
    w, b, padding=(0, 1))."""
    if spatial is None:
        return F.conv2d(x, weight, bias, padding=1)
    return F.conv2d(halo.pad(x, spatial, 1, 1), weight, bias, padding=(0, 1))


def _shard_conv(conv: nn.Conv2d, spatial) -> None:
    """Give a 3x3 convolution the halo rows of its shard (a forward
    pre-hook, and row padding 0: the halo holds the zero rows at the
    image's edges), or take them away (spatial None)."""
    state = conv.__dict__.pop("_spatial_halo", None)
    if state is not None:
        state["hook"].remove()
        conv.padding = state["padding"]
    if spatial is None:
        return
    above, below = halo.rows_needed(conv.stride[0], conv.padding[0])
    hook = conv.register_forward_pre_hook(
        lambda mod, args: (halo.pad(args[0], spatial, above, below),) + tuple(args[1:]))
    conv.__dict__["_spatial_halo"] = {"hook": hook, "padding": conv.padding}
    conv.padding = (0, conv.padding[1])


def shard_spatially(model: nn.Module, spatial) -> nn.Module:
    """Attach `spatial` (a parallel.spatial.SpatialGroup; None detaches)
    to every 3x3 convolution and every module that holds a `spatial`
    attribute (the GroupNorms, the attention blocks, the DDPM downsample's
    pad, the ADM head, the classifier's pool) of `model` but those marked
    `replicated`, in place, as set_op_force does for
    `force`: the model then maps this process's rows of a map to its rows
    of the output. The same parameters, no copy."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d) and tuple(m.kernel_size) == (3, 3):
            _shard_conv(m, spatial)
        elif hasattr(m, "spatial") and not getattr(m, "replicated", False):
            m.spatial = spatial
    return model


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
