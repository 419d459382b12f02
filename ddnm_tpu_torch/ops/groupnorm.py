"""GroupNorm (+ optional FiLM, + optional SiLU) for NHWC activations.

Port of `ddnm_tpu/ops/groupnorm.py`. On a CUDA tensor `group_norm` runs the
hand-written kernels of `csrc/groupnorm.cu` in two launches: the stats
kernel, which sums each image's pixels in blocks, combines the blocks' sums
in a fixed order in the last block to finish, and folds them into a
per-(B, C) affine a, b (the `_effective_affine` glue, FiLM included), then
the apply kernel, y = x * a + b with an optional SiLU epilogue (16-byte
loads and stores, a and b held in registers; the launch plan
`_apply_plan`). The UNet's norm -> swish pairs take that epilogue
(`GroupNormF32(swish=True)`). On a CPU tensor it runs
`_torch_group_norm`, the plain PyTorch version that follows the JAX
package's `_xla_group_norm` line for line; the tests hold the two against
each other and against the JAX package. The two kernel wrappers,
the stats (`_stats_affine`, for the Pallas `_pallas_stats` with its glue)
and the apply pass (`_apply`, for `_pallas_group_norm`), each have a plain
version of their own (`_torch_stats_affine`, `_torch_apply`).

`force="torch"` selects the plain version on any device, `force="kernel"`
the kernels (and raises on a CPU tensor). There is no fallback: a kernel
that fails to build or launch raises.

`GroupNormFunction` is the same forward with a gradient for x (the
classifier-guidance gradient; the affine and FiLM must be frozen). Its
backward runs two more kernels of csrc/groupnorm.cu on a CUDA tensor:
`gn_bwd_reduce` (one pass over x and dy for the per-(image, group) sums,
folded into a per-(B, C) affine of dy and x; the stats kernel's layout,
`_bwd_reduce_plan`) and `gn_bwd_dx` (the elementwise pass, the apply
kernel's layout), each beside its plain version (`_torch_bwd_reduce`,
`_torch_bwd_dx`); `_torch_group_norm_backward` is the whole formula in
plain PyTorch.
"""

from __future__ import annotations

import functools
import math

import torch

from ddnm_tpu_torch.ops import _build

__all__ = ["group_norm", "GroupNormFunction", "LAUNCHES"]

# launches of each kernel wrapper since the last reset (ops.reset_launch_counts)
LAUNCHES = {"groupnorm_stats": 0, "groupnorm_apply": 0, "gn_bwd_reduce": 0, "gn_bwd_dx": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the stats kernel's launch plan (`_stats_plan`; csrc/groupnorm.cu)
_STATS_UNROLL = 8           # kStatsUnroll: pixel loads in flight per thread
# an image of _STATS_WIDE_BYTES or more is read in whole pixel rows by blocks
# of 512 threads, one per _STATS_BLOCK_BYTES of it, at most _STATS_MAX_BLOCKS
# (the best of a sweep of block sizes at the DDPM UNet's maps on the H100)
_STATS_WIDE_BYTES = 2 << 20
_STATS_BLOCK_BYTES = 256 << 10
_STATS_MAX_BLOCKS = 32
STATS_MAX_SPAN = 4096       # channels of one span: bounds the shared memory
# the stats kernel's launch counters, per device: zeros that each launch
# leaves zero (csrc/groupnorm.cu)
_COUNTERS: dict = {}
# the apply kernel's launch plan (`_apply_plan`): threads a block (rounded
# down to a multiple of C / vec), resident threads an SM
_APPLY_THREADS = 256
_SM_THREADS = 2048


def _wide(t):
    """t in fp32 (the plain versions' arithmetic), or as it is in float64
    (gradcheck's type)."""
    return t if t.dtype == torch.float64 else t.float()


def _torch_group_norm(x, scale, bias, num_groups, eps, swish,
                      film_scale=None, film_shift=None):
    """fp32 fast-variance GroupNorm, cast back to x.dtype, then SiLU on the
    cast value (ddnm_tpu/ops/groupnorm.py _xla_group_norm)."""
    dtype = x.dtype
    B, H, W, C = x.shape
    xf = _wide(x).reshape(B, H * W, num_groups, C // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean,
                      min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(B, H, W, C) * scale.to(xf.dtype) + bias.to(xf.dtype)
    if film_scale is not None:
        y = (y * (1.0 + film_scale.to(xf.dtype)[:, None, None, :])
             + film_shift.to(xf.dtype)[:, None, None, :])
    y = y.to(dtype)
    if swish:
        f = _wide(y)
        y = (f * torch.sigmoid(f)).to(dtype)
    return y


def _torch_stats_affine(x, scale, bias, num_groups, eps,
                        film_scale=None, film_shift=None):
    """Per-(B, C) fp32 affine (a, b): fp32 sums over H*W as `_stats_kernel`
    takes them, folded as ddnm_tpu/ops/groupnorm.py `_effective_affine`."""
    B, H, W, C = x.shape
    xf = _wide(x)
    g1 = xf.sum(dim=(1, 2)).reshape(B, num_groups, -1).sum(-1)
    g2 = (xf * xf).sum(dim=(1, 2)).reshape(B, num_groups, -1).sum(-1)
    n = H * W * (C // num_groups)
    mean = g1 / n
    rstd = torch.rsqrt(torch.clamp(g2 / n - mean * mean, min=0.0) + eps)
    rep = C // num_groups
    a = torch.repeat_interleave(rstd, rep, dim=1) * scale.to(xf.dtype)[None]
    b = bias.to(xf.dtype)[None] - torch.repeat_interleave(mean, rep, dim=1) * a
    if film_scale is not None:
        fs = 1.0 + film_scale.to(xf.dtype)
        a = a * fs
        b = b * fs + film_shift.to(xf.dtype)
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
    if B > 65535:  # CUDA grid z limit
        raise ValueError(f"GroupNorm kernel takes B <= 65535, got {tuple(x.shape)}")


@functools.lru_cache(maxsize=256)
def _stats_plan(B: int, HW: int, C: int, G: int, elem_size: int,
                aligned: bool = True) -> dict:
    """The stats kernel's launch for (B, H*W, C) with G groups: channels per
    16-byte load (`vec`), the channel span of a block (whole groups),
    blocks per (image, span) (`n_blk`, each a contiguous run of pixels),
    threads (`lanes_c` channel lanes x pixel lanes), grid, dynamic
    shared-memory bytes, and the floats of partial sums and the launch
    counters it needs. `aligned`: x starts on 16 bytes. Raises ValueError
    for a shape the kernel does not take."""
    if C % G:
        raise ValueError(f"channels {C} not divisible by {G} groups")
    cpg = C // G
    if cpg > STATS_MAX_SPAN:
        raise ValueError(f"GroupNorm kernel takes C / G <= {STATS_MAX_SPAN}, got {cpg}")
    vec = 16 // elem_size if aligned else 1
    base = math.lcm(cpg, vec)
    if C % base or base > STATS_MAX_SPAN:
        vec, base = 1, cpg
    spans = [s for s in range(base, min(C, STATS_MAX_SPAN) + 1, base) if C % s == 0]
    image_bytes = HW * C * elem_size
    if image_bytes >= _STATS_WIDE_BYTES:
        # big maps: whole rows (contiguous streams), several blocks an image
        span, target = spans[-1], 512
        n_blk = min(_STATS_MAX_BLOCKS, max(1, image_bytes // _STATS_BLOCK_BYTES))
    else:
        # small maps: one block per (image, span), spans of 64 bytes of a
        # pixel or more, so that the grid still has many blocks
        span = next((s for s in spans if s * elem_size >= 64), spans[-1])
        target, n_blk = 256, 1
    if C // span > 65535:  # CUDA grid y limit
        raise ValueError(f"GroupNorm kernel takes C / span <= 65535, got {C} / {span}")
    lanes_c = min(span // vec, target)
    lanes_p = target // lanes_c
    threads = lanes_c * lanes_p
    n_blk = max(1, min(n_blk, HW // (2 * lanes_p)))
    smem = 4 * (2 * span + 2 * threads * vec + 2 * (span // cpg)) + 16
    return {"vec": vec, "span": span, "n_blk": n_blk, "threads": threads,
            "lanes_c": lanes_c, "grid": (n_blk, C // span, B), "smem": smem,
            "scratch": B * C * n_blk * 2 if n_blk > 1 else 0, "counters": B * (C // span)}


def _counters(device, n):
    """At least n launch counters (zeros) of `device`."""
    c = _COUNTERS.get(device.index)
    if c is None or c.numel() < n:
        c = _COUNTERS[device.index] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                                  device=device)
    return c


def _vec(t, shape, device):
    if (t.device == device and t.dtype == torch.float32 and t.is_contiguous()
            and tuple(t.shape) == shape):
        return t  # how GroupNormF32 keeps its affine: no conversion
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if tuple(t.shape) != shape:
        raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
    return t


def _stats_affine(x, scale, bias, num_groups, eps, film_scale, film_shift):
    """Per-(B, C) fp32 affine (a, b) of the normalize pass: one launch of
    the stats kernel; a, b in one (2, B, C) buffer."""
    _check_input(x, num_groups)
    B, H, W, C = x.shape
    plan = _stats_plan(B, H * W, C, num_groups, x.element_size(), x.data_ptr() % 16 == 0)
    lib = _build.load_library()
    dev = x.device
    scale = _vec(scale, (C,), dev)
    bias = _vec(bias, (C,), dev)
    if film_scale is not None:
        film_scale = _vec(film_scale, (B, C), dev)
        film_shift = _vec(film_shift, (B, C), dev)
    # a, b and the blocks' partial sums in one allocation
    if plan["scratch"]:
        buf = x.new_empty(2 * B * C + plan["scratch"], dtype=torch.float32)
        out = buf[:2 * B * C].view(2, B, C)
        scratch, counters = buf.data_ptr() + 8 * B * C, _counters(dev, plan["counters"])
    else:
        out = x.new_empty((2, B, C), dtype=torch.float32)
        scratch = counters = None
    with _build.device_guard(dev):
        _build.check(lib.ddnm_gn_stats_affine(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            film_scale.data_ptr() if film_scale is not None else None,
            film_shift.data_ptr() if film_shift is not None else None,
            out.data_ptr(), scratch, counters.data_ptr() if counters is not None else None,
            B, H * W, C, num_groups, float(eps), plan["vec"], plan["span"], plan["n_blk"],
            plan["threads"], plan["lanes_c"], plan["smem"], _DTYPE_CODE[x.dtype],
            _build.raw_stream(dev)), "ddnm_gn_stats_affine")
    LAUNCHES["groupnorm_stats"] += 1
    return out.select(0, 0), out.select(0, 1)  # cheaper on the host than unbind


@functools.lru_cache(maxsize=256)
def _apply_plan(B: int, HW: int, C: int, dtype: torch.dtype, aligned: bool = True,
                sms: int = 132) -> dict:
    """The apply kernel's launch for (B, H*W, C): channels per 16-byte load
    and store (`vec`; 1 where x is not on 16 bytes or C is not a multiple of
    the width), threads a block, and a row of `blocks` per image (grid
    (blocks, B)): whole blocks per SM times `sms` over the batch, at most one
    vector a thread, with blocks * threads a multiple of C / vec so that a
    thread's channels stay fixed along its stride through its image."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"GroupNorm kernel takes float32/bfloat16, got {dtype}")
    wide = 16 // (4 if dtype == torch.float32 else 2)
    vec = wide if aligned and C % wide == 0 else 1
    cv = C // vec
    if cv <= _APPLY_THREADS:
        threads, unit = _APPLY_THREADS // cv * cv, 1
    else:  # blocks a multiple of unit
        threads, unit = _APPLY_THREADS, cv // math.gcd(cv, _APPLY_THREADS)
    img_vec = HW * cv
    blocks = min(-(-img_vec // threads), -(-_SM_THREADS // threads * sms // B))
    blocks = -(-blocks // unit) * unit
    return {"vec": vec, "threads": threads, "blocks": blocks, "grid": (blocks, B), "cv": cv,
            "img_vec": img_vec}


def _apply(x, a, b, swish):
    """y = x * a + b (fp32), cast to x.dtype, optional SiLU: the apply kernel,
    one launch and one allocation."""
    lib = _build.load_library()
    B, H, W, C = x.shape
    dev = x.device
    plan = _apply_plan(B, H * W, C, x.dtype, x.data_ptr() % 16 == 0, _build.sm_count(dev))
    y = torch.empty_like(x)
    with _build.device_guard(dev):
        _build.check(lib.ddnm_gn_apply(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), B, H * W * C, C,
            int(bool(swish)), _DTYPE_CODE[x.dtype], plan["vec"], plan["threads"],
            plan["blocks"], _build.raw_stream(dev)), "ddnm_gn_apply")
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


# ------------------------------------------------------------------ backward


def _silu_grad(u, dtype):
    """SiLU'(f) at f = u rounded to `dtype` (the value the forward's SiLU
    took; the rounding passes the gradient through), in fp32."""
    f = _wide(u.to(dtype))
    sig = torch.sigmoid(f)
    return sig * (1.0 + f * (1.0 - sig))


def _torch_bwd_reduce(x, dy, scale, num_groups, eps, swish, a=None, b=None,
                      film_scale=None):
    """The per-(B, C) fp32 coefficients (3, B, C) of dx = A dy' + Bx x + Cx
    (`gn_bwd_reduce_kernel`): dy' is dy through the SiLU's derivative at
    a x + b when `swish`; mean and rstd are recomputed from x (the fast
    variance, as the forward), g = scale (1 + film_scale), and
    dx = rstd (g dy' - mean_g(g dy') - x^ mean_g(g dy' x^))."""
    B, H, W, C = x.shape
    xf, d = _wide(x), _wide(dy)
    if swish:
        d = d * _silu_grad(xf * a[:, None, None, :] + b[:, None, None, :], x.dtype)
    g = scale.to(xf.dtype)[None].expand(B, C)
    if film_scale is not None:
        g = g * (1.0 + film_scale.to(xf.dtype))
    rep = C // num_groups
    n = H * W * rep
    group = lambda t: t.reshape(B, num_groups, rep).sum(-1)
    mean = group(xf.sum(dim=(1, 2))) / n
    var = torch.clamp(group((xf * xf).sum(dim=(1, 2))) / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    c1 = group(g * d.sum(dim=(1, 2))) / n
    c2 = rstd * (group(g * (d * xf).sum(dim=(1, 2))) / n - mean * c1)
    per_c = lambda t: torch.repeat_interleave(t, rep, dim=1)
    return torch.stack([per_c(rstd) * g, per_c(-rstd * rstd * c2),
                        per_c(rstd * (mean * rstd * c2 - c1))])


def _torch_bwd_dx(x, dy, coef, swish, a=None, b=None):
    """dx = A dy' + Bx x + Cx in fp32, cast to x.dtype (`gn_bwd_dx_kernel`)."""
    xf, d = _wide(x), _wide(dy)
    if swish:
        d = d * _silu_grad(xf * a[:, None, None, :] + b[:, None, None, :], x.dtype)
    ca, cx, cc = (t[:, None, None, :] for t in coef)
    return (ca * d + cx * xf + cc).to(x.dtype)


def _torch_group_norm_backward(x, dy, scale, bias, num_groups, eps, swish,
                               film_scale=None, film_shift=None):
    """dL/dx of `_torch_group_norm` given dL/dy, by the explicit formula
    (not autograd): the plain version of the two backward kernels."""
    a = b = None
    if swish:
        a, b = _torch_stats_affine(x, scale, bias, num_groups, eps, film_scale, film_shift)
    coef = _torch_bwd_reduce(x, dy, scale, num_groups, eps, swish, a, b, film_scale)
    return _torch_bwd_dx(x, dy, coef, swish, a, b)


@functools.lru_cache(maxsize=256)
def _bwd_reduce_plan(B: int, HW: int, C: int, G: int, elem_size: int,
                     aligned: bool = True) -> dict:
    """The backward reduce kernel's launch: the stats kernel's blocks
    (`_stats_plan`: vec, span, blocks per image, threads, grid, counters)
    with four sums a channel (x, x^2, dy', dy' x): dynamic shared memory
    4 * (4 span + 4 threads vec + 3 span / cpg) + 16 bytes and 4 span
    floats of scratch a block. Raises ValueError for a shape the kernel
    does not take."""
    plan = dict(_stats_plan(B, HW, C, G, elem_size, aligned))
    span, threads, vec, cpg = plan["span"], plan["threads"], plan["vec"], C // G
    plan["smem"] = 4 * (4 * span + 4 * threads * vec + 3 * (span // cpg)) + 16
    plan["scratch"] = 2 * plan["scratch"]
    return plan


def _bwd_reduce(x, dy, scale, num_groups, eps, swish, a=None, b=None, film_scale=None):
    """The (3, B, C) fp32 coefficients of dx: one launch of the backward
    reduce kernel."""
    _check_input(x, num_groups)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("the GroupNorm backward takes a contiguous dy of x's shape and dtype")
    B, H, W, C = x.shape
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    plan = _bwd_reduce_plan(B, H * W, C, num_groups, x.element_size(), aligned)
    lib = _build.load_library()
    dev = x.device
    scale = _vec(scale, (C,), dev)
    if film_scale is not None:
        film_scale = _vec(film_scale, (B, C), dev)
    if swish:
        a, b = _vec(a, (B, C), dev), _vec(b, (B, C), dev)
    if plan["scratch"]:
        buf = x.new_empty(3 * B * C + plan["scratch"], dtype=torch.float32)
        out = buf[:3 * B * C].view(3, B, C)
        scratch, counters = buf.data_ptr() + 12 * B * C, _counters(dev, plan["counters"])
    else:
        out = x.new_empty((3, B, C), dtype=torch.float32)
        scratch = counters = None
    ptr = lambda t: t.data_ptr() if t is not None else None
    with _build.device_guard(dev):
        _build.check(lib.ddnm_gn_bwd_reduce(
            x.data_ptr(), dy.data_ptr(), scale.data_ptr(), ptr(film_scale),
            ptr(a) if swish else None, ptr(b) if swish else None, out.data_ptr(), scratch,
            counters.data_ptr() if counters is not None else None, B, H * W, C, num_groups,
            float(eps), int(bool(swish)), plan["vec"], plan["span"], plan["n_blk"],
            plan["threads"], plan["lanes_c"], plan["smem"], _DTYPE_CODE[x.dtype],
            _build.raw_stream(dev)), "ddnm_gn_bwd_reduce")
    LAUNCHES["gn_bwd_reduce"] += 1
    return out


def _bwd_dx(x, dy, coef, swish, a=None, b=None):
    """dx = A dy' + Bx x + Cx: one launch of the backward elementwise
    kernel (the apply kernel's plan)."""
    lib = _build.load_library()
    B, H, W, C = x.shape
    dev = x.device
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    plan = _apply_plan(B, H * W, C, x.dtype, aligned, _build.sm_count(dev))
    dx = torch.empty_like(x)
    with _build.device_guard(dev):
        _build.check(lib.ddnm_gn_bwd_dx(
            x.data_ptr(), dy.data_ptr(), a.data_ptr() if swish else None,
            b.data_ptr() if swish else None, coef.data_ptr(), dx.data_ptr(), B, H * W * C, C,
            int(bool(swish)), _DTYPE_CODE[x.dtype], plan["vec"], plan["threads"],
            plan["blocks"], _build.raw_stream(dev)), "ddnm_gn_bwd_dx")
    LAUNCHES["gn_bwd_dx"] += 1
    return dx


class GroupNormFunction(torch.autograd.Function):
    """`group_norm` with the gradient for x: apply(x, scale, bias,
    film_scale, film_shift, num_groups, eps, swish, mode), mode "kernel"
    (the two forward and two backward kernels) or "torch" (the plain
    versions). Only x may require grad: the affine and FiLM are frozen
    (the classifier's parameters under guidance), and a gradient for them
    raises rather than come back None."""

    @staticmethod
    def forward(ctx, x, scale, bias, film_scale, film_shift, num_groups, eps, swish, mode):
        if any(t is not None and t.requires_grad
               for t in (scale, bias, film_scale, film_shift)):
            raise ValueError("GroupNormFunction gives the gradient of x only: the scale, "
                             "bias and FiLM must not require grad")
        if mode == "kernel":
            a, b = _stats_affine(x, scale, bias, num_groups, eps, film_scale, film_shift)
            y = _apply(x, a, b, swish)
            ctx.save_for_backward(x, scale, film_scale, a, b)
        elif mode == "torch":
            y = _torch_group_norm(x, scale, bias, num_groups, eps, swish, film_scale, film_shift)
            ctx.save_for_backward(x, scale, bias, film_scale, film_shift)
        else:
            raise ValueError(f"mode must be 'kernel' or 'torch', got {mode!r}")
        ctx.conf = (num_groups, eps, swish, mode)
        return y

    @staticmethod
    def backward(ctx, dy):
        num_groups, eps, swish, mode = ctx.conf
        if mode == "kernel":
            x, scale, film_scale, a, b = ctx.saved_tensors
            dy = dy.to(x.dtype).contiguous()
            coef = _bwd_reduce(x, dy, scale, num_groups, eps, swish, a, b, film_scale)
            dx = _bwd_dx(x, dy, coef, swish, a, b)
        else:
            x, scale, bias, film_scale, film_shift = ctx.saved_tensors
            dx = _torch_group_norm_backward(x, dy.to(x.dtype), scale, bias, num_groups, eps,
                                            swish, film_scale, film_shift)
        return dx, None, None, None, None, None, None, None, None
