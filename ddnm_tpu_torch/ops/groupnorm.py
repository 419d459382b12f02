"""GroupNorm (+ optional FiLM, + optional SiLU) for NHWC activations.

Port of `ddnm_tpu/ops/groupnorm.py`. On a CUDA tensor `group_norm` runs the
hand-written kernels of `csrc/groupnorm.cu` in three launches: partial
sums per (batch, channel block, row block), a fixed-order reduction that
folds them into a per-(B, C) affine a, b (the `_effective_affine` glue,
FiLM included), and y = x * a + b with an optional SiLU. On a CPU tensor it
runs `_torch_group_norm`, the plain PyTorch version that follows the JAX
package's `_xla_group_norm` line for line; the tests hold the two against
each other and against the JAX package. The two kernel wrappers, the stats
pair (`_stats_affine`, for the Pallas `_pallas_stats` with its glue) and
the apply pass (`_apply`, for `_pallas_group_norm`), each have a plain
version of their own (`_torch_stats_affine`, `_torch_apply`).

`force="torch"` selects the plain version on any device, `force="kernel"`
the kernels (and raises on a CPU tensor). There is no fallback: a kernel
that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from ddnm_tpu_torch.ops import _build

__all__ = ["group_norm", "LAUNCHES"]

# launches of each kernel wrapper since the last reset (ops.reset_launch_counts)
LAUNCHES = {"groupnorm_stats": 0, "groupnorm_apply": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 256  # pixels per stats block (32 per pixel lane)


def _torch_group_norm(x, scale, bias, num_groups, eps, swish,
                      film_scale=None, film_shift=None):
    """fp32 fast-variance GroupNorm, cast back to x.dtype, then SiLU on the
    cast value (ddnm_tpu/ops/groupnorm.py _xla_group_norm)."""
    dtype = x.dtype
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H * W, num_groups, C // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean,
                      min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(B, H, W, C) * scale.float() + bias.float()
    if film_scale is not None:
        y = (y * (1.0 + film_scale.float()[:, None, None, :])
             + film_shift.float()[:, None, None, :])
    y = y.to(dtype)
    if swish:
        f = y.float()
        y = (f * torch.sigmoid(f)).to(dtype)
    return y


def _torch_stats_affine(x, scale, bias, num_groups, eps,
                        film_scale=None, film_shift=None):
    """Per-(B, C) fp32 affine (a, b): fp32 sums over H*W as `_stats_kernel`
    takes them, folded as ddnm_tpu/ops/groupnorm.py `_effective_affine`."""
    B, H, W, C = x.shape
    xf = x.float()
    g1 = xf.sum(dim=(1, 2)).reshape(B, num_groups, -1).sum(-1)
    g2 = (xf * xf).sum(dim=(1, 2)).reshape(B, num_groups, -1).sum(-1)
    n = H * W * (C // num_groups)
    mean = g1 / n
    rstd = torch.rsqrt(torch.clamp(g2 / n - mean * mean, min=0.0) + eps)
    rep = C // num_groups
    a = torch.repeat_interleave(rstd, rep, dim=1) * scale.float()[None]
    b = bias.float()[None] - torch.repeat_interleave(mean, rep, dim=1) * a
    if film_scale is not None:
        fs = 1.0 + film_scale.float()
        a = a * fs
        b = b * fs + film_shift.float()
    return a, b


def _torch_apply(x, a, b, swish):
    """y = x * a + b in fp32, cast to x.dtype, then optional SiLU
    (ddnm_tpu/ops/groupnorm.py `_apply_kernel`)."""
    y = (x.float() * a[:, None, None, :] + b[:, None, None, :]).to(x.dtype)
    if swish:
        f = y.float()
        y = (f * torch.sigmoid(f)).to(x.dtype)
    return y


def _check_input(x, num_groups):
    if not x.is_cuda:
        raise ValueError("the GroupNorm kernel takes CUDA tensors only")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"GroupNorm kernel takes float32/bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("GroupNorm kernel takes a contiguous NHWC tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by {num_groups} groups")
    if H * W * C >= 2**31:
        raise ValueError("GroupNorm kernel takes H*W*C < 2^31 per image")
    if B > 65535 or -(-H * W // _ROWS_PER_BLOCK) > 65535:  # CUDA grid y/z limits
        raise ValueError(f"GroupNorm kernel takes B <= 65535 and H*W <= "
                         f"{65535 * _ROWS_PER_BLOCK}, got {tuple(x.shape)}")


def _vec(t, shape, device):
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if tuple(t.shape) != shape:
        raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
    return t


def _stats_affine(x, scale, bias, num_groups, eps, film_scale, film_shift):
    """Per-(B, C) fp32 affine (a, b) of the normalize pass: the stats kernel
    and the fixed-order finalize kernel."""
    _check_input(x, num_groups)
    lib = _build.load_library()
    B, H, W, C = x.shape
    hw = H * W
    rows = -(-hw // _ROWS_PER_BLOCK)
    dev = x.device
    scale = _vec(scale, (C,), dev)
    bias = _vec(bias, (C,), dev)
    if film_scale is not None:
        film_scale = _vec(film_scale, (B, C), dev)
        film_shift = _vec(film_shift, (B, C), dev)
    partial = torch.empty((B, rows, 2, C), device=dev, dtype=torch.float32)
    a = torch.empty((B, C), device=dev, dtype=torch.float32)
    b = torch.empty((B, C), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _build.check(lib.ddnm_gn_stats(
            x.data_ptr(), partial.data_ptr(), B, hw, C, _ROWS_PER_BLOCK,
            _DTYPE_CODE[x.dtype], stream), "ddnm_gn_stats")
        _build.check(lib.ddnm_gn_finalize(
            partial.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            film_scale.data_ptr() if film_scale is not None else None,
            film_shift.data_ptr() if film_shift is not None else None,
            a.data_ptr(), b.data_ptr(), B, rows, C, num_groups,
            float(hw * (C // num_groups)), float(eps), stream),
            "ddnm_gn_finalize")
    LAUNCHES["groupnorm_stats"] += 1
    return a, b


def _apply(x, a, b, swish):
    """y = x * a + b (fp32), cast to x.dtype, optional SiLU: the apply kernel."""
    lib = _build.load_library()
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        _build.check(lib.ddnm_gn_apply(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), B, H * W * C,
            C, int(bool(swish)), _DTYPE_CODE[x.dtype], stream), "ddnm_gn_apply")
    LAUNCHES["groupnorm_apply"] += 1
    return y


def _kernel_group_norm(x, scale, bias, num_groups, eps, swish,
                       film_scale=None, film_shift=None):
    a, b = _stats_affine(x, scale, bias, num_groups, eps, film_scale, film_shift)
    return _apply(x, a, b, swish)


def group_norm(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5,
               swish: bool = False, film_scale=None, film_shift=None,
               force: str | None = None):
    """NHWC GroupNorm with fp32 statistics, optional FiLM (B, C) scale/shift
    applied after normalization, and optional SiLU; returns x.dtype.

    `force`: None (the kernels for a CUDA tensor, the plain version for a
    CPU tensor), "kernel" or "torch"."""
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift go together")
    mode = force or ("kernel" if x.is_cuda else "torch")
    if mode == "torch":
        return _torch_group_norm(x, scale, bias, num_groups, eps, swish,
                                 film_scale, film_shift)
    if mode == "kernel":
        return _kernel_group_norm(x, scale, bias, num_groups, eps, swish,
                                  film_scale, film_shift)
    raise ValueError(f"force must be None, 'kernel' or 'torch', got {force!r}")
