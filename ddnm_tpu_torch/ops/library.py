"""The three forward kernels as torch.library custom ops (`ddnm::`).

A kernel wrapper launches its kernel through ctypes (ops/_build.py), which
no torch tracer can see. Registered as a custom op with a fake
implementation (shapes and types only), the same kernel is one node of a
traced graph: torch.export keeps it as `torch.ops.ddnm.<name>` where it
would otherwise fail on a FakeTensor's missing data pointer (serving.py).

  - `ddnm::gn_stats_affine(x, scale, bias, film_scale?, film_shift?,
    num_groups, eps) -> (2, B, C) fp32`: a and b of the GroupNorm stats
    kernel (groupnorm.py `_stats_affine`) in its one buffer, since an op's
    outputs may not alias each other; the caller selects a and b;
  - `ddnm::gn_apply(x, a, b, swish) -> y`: the apply kernel (`_apply`);
  - `ddnm::attention(q, k, v, scale) -> out`: the attention kernel
    (attention.py `_kernel_attention`).

Each op's CUDA implementation is the kernel, launch counting included, so
an exported program's launches count as the eager path's do. Its CPU
implementation is the kernel's plain version (`_torch_stats_affine`,
`_torch_apply`, `_torch_attention`). No other device has one: a CUDA
tensor never reaches a plain version, traced or not.

Eager code keeps the direct wrapper call: a call through the dispatcher
costs the host ~14 us more than the ctypes launch on an H100's host
(PERF.md §6). The wrappers take the ops while a tracer runs
(`_build.tracing`) or under `force="op"`. Importing `ddnm_tpu_torch.ops` registers them, as loading an
exported program needs (serving.py `load_exported`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ddnm_tpu_torch.ops import attention as _attention
from ddnm_tpu_torch.ops import groupnorm as _groupnorm

__all__ = ["gn_stats_affine", "gn_apply", "attention", "OPS"]

Tensor = torch.Tensor


@torch.library.custom_op("ddnm::gn_stats_affine", mutates_args=(), device_types="cpu")
def gn_stats_affine(x: Tensor, scale: Tensor, bias: Tensor, film_scale: Optional[Tensor],
                    film_shift: Optional[Tensor], num_groups: int, eps: float) -> Tensor:
    return torch.stack(_groupnorm._torch_stats_affine(x, scale, bias, num_groups, eps,
                                                      film_scale, film_shift))


@gn_stats_affine.register_kernel("cuda")
def _gn_stats_affine_cuda(x, scale, bias, film_scale, film_shift, num_groups, eps):
    return _groupnorm._stats_affine_buffer(x.contiguous(), scale, bias, num_groups, eps,
                                           film_scale, film_shift)


@gn_stats_affine.register_fake
def _gn_stats_affine_fake(x, scale, bias, film_scale, film_shift, num_groups, eps):
    return x.new_empty((2, x.shape[0], x.shape[-1]), dtype=torch.float32)


@torch.library.custom_op("ddnm::gn_apply", mutates_args=(), device_types="cpu")
def gn_apply(x: Tensor, a: Tensor, b: Tensor, swish: bool) -> Tensor:
    return _groupnorm._torch_apply(x, a, b, swish)


@gn_apply.register_kernel("cuda")
def _gn_apply_cuda(x, a, b, swish):
    return _groupnorm._apply(x.contiguous(), a.contiguous(), b.contiguous(), swish)


@gn_apply.register_fake
def _gn_apply_fake(x, a, b, swish):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op("ddnm::attention", mutates_args=(), device_types="cpu")
def attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    return _attention._torch_attention(q, k, v, scale)


@attention.register_kernel("cuda")
def _attention_cuda(q, k, v, scale):
    return _attention._kernel_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale)


@attention.register_fake
def _attention_fake(q, k, v, scale):
    return q.new_empty(q.shape)


# the ops' qualified names, as a traced graph's nodes name them
OPS = ("ddnm::gn_stats_affine", "ddnm::gn_apply", "ddnm::attention")
