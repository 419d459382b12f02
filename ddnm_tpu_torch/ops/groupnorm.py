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

`group_norm(..., spatial=group)` normalises one spatial shard of a map
whose rows are split over processes (parallel/spatial.py): the stats
kernel in its partial mode sums this shard's pixels per channel
(`_stats_partial`, plain `_torch_stats_partial`), the group adds every
shard's (2, B, C) sums in rank order (`group.sum_shards`, one
all_gather), the finalize kernel folds them into a, b (`_finalize`, plain
`_torch_affine_from_sums`), and the apply kernel runs on the shard's rows.
Those launches count in `SPATIAL_LAUNCHES` (ops.spatial_launch_counts).

`GroupNormFunction` is the same forward with a gradient for x (the
classifier-guidance gradient; the affine and FiLM must be frozen). Its
backward runs two more kernels of csrc/groupnorm.cu on a CUDA tensor:
`gn_bwd_reduce` (one pass over x and dy for the per-(image, group) sums,
folded into a per-(B, C) affine of dy and x, in clusters of blocks that
combine their sums through distributed shared memory; its launch plan is
`_bwd_reduce_plan`) and `gn_bwd_dx` (the elementwise pass, the apply
kernel's layout), each beside its plain version (`_torch_bwd_reduce`,
`_torch_bwd_dx`); `_torch_group_norm_backward` is the whole formula in
plain PyTorch.

In training (the scale, bias or FiLM require grad) `GroupNormFunction`
also returns their gradients: the backward reduce kernel's partial mode
sums the map's x, x^2, dy' and dy' x per channel (`_bwd_sums`), the
backward finalize kernel below folds them into dx's coefficients and the
parameter gradients (`_bwd_finalize(bias=)`, plain `_torch_bwd_finalize`;
counted as `gn_bwd_param`), and `gn_bwd_dx` runs as before: three
backward launches a norm.

`ShardedGroupNormFunction` is the spatial path with that gradient (the
guidance gradient under spatial shards). Its forward is the spatial
forward above, saving the whole map's affine; its backward needs the
whole map's sums too: the backward reduce kernel in its partial mode
(`_bwd_partial`, plain `_torch_bwd_partial`) sums this shard's x, x^2, dy'
and dy' x per channel (dy' through the SiLU' at the whole map's a, b), the
group adds every shard's (4, B, C) sums in rank order (one all_gather),
`gn_bwd_finalize_kernel` folds them into the coefficients of dx with the
reduce kernel's own arithmetic (`_bwd_finalize`, plain
`_torch_bwd_finalize`), and `gn_bwd_dx` runs on the shard's rows. Those
two launches count in `SPATIAL_LAUNCHES` too.
"""

from __future__ import annotations

import functools
import math

import torch

from ddnm_tpu_torch.ops import _build

__all__ = ["group_norm", "GroupNormFunction", "ShardedGroupNormFunction", "LAUNCHES"]

# launches of each kernel wrapper since the last reset (ops.reset_launch_counts)
LAUNCHES = {"groupnorm_stats": 0, "groupnorm_apply": 0, "gn_bwd_reduce": 0, "gn_bwd_dx": 0,
            "gn_bwd_sums": 0, "gn_bwd_param": 0}
# the spatial path's: the stats kernel's partial mode and the finalize, and
# in the gradient the backward reduce kernel's partial mode and its finalize
SPATIAL_LAUNCHES = {"groupnorm_partial": 0, "groupnorm_finalize": 0, "gn_bwd_partial": 0,
                    "gn_bwd_finalize": 0}

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
# the stats and backward-reduce kernels' launch counters, per (device,
# stream): zeros that each launch leaves zero (csrc/groupnorm.cu; `_counters`)
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


def _torch_stats_partial(x):
    """(2, B, C) fp32 per-channel sums of x and of x^2 over H*W (the stats
    kernel's partial mode)."""
    xf = _wide(x)
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))])


def _torch_stats_affine(x, scale, bias, num_groups, eps,
                        film_scale=None, film_shift=None):
    """Per-(B, C) fp32 affine (a, b): fp32 sums over H*W as `_stats_kernel`
    takes them, folded as ddnm_tpu/ops/groupnorm.py `_effective_affine`."""
    B, H, W, C = x.shape
    return _torch_affine_from_sums(_torch_stats_partial(x), H * W, scale, bias, num_groups,
                                   eps, film_scale, film_shift)


def _torch_affine_from_sums(sums, hw, scale, bias, num_groups, eps,
                            film_scale=None, film_shift=None):
    """Per-(B, C) fp32 affine (a, b) from (2, B, C) per-channel sums over a
    map of `hw` pixels (the finalize kernel): group sums, mean, rstd by the
    fast variance, FiLM folded in."""
    _, B, C = sums.shape
    g1 = sums[0].reshape(B, num_groups, -1).sum(-1)
    g2 = sums[1].reshape(B, num_groups, -1).sum(-1)
    n = hw * (C // num_groups)
    mean = g1 / n
    rstd = torch.rsqrt(torch.clamp(g2 / n - mean * mean, min=0.0) + eps)
    rep = C // num_groups
    a = torch.repeat_interleave(rstd, rep, dim=1) * scale.to(sums.dtype)[None]
    b = bias.to(sums.dtype)[None] - torch.repeat_interleave(mean, rep, dim=1) * a
    if film_scale is not None:
        fs = 1.0 + film_scale.to(sums.dtype)
        a = a * fs
        b = b * fs + film_shift.to(sums.dtype)
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


def _counters(device, n, stream=None):
    """At least n launch counters (zeros) of `device` for the launches of
    one stream: `stream`, or the thread's current stream of `device` (a
    stand-in key on the CPU). Launches on one stream run in order, so each
    finds the zeros its predecessor left; two streams (the shards of a
    mesh on one card) must not share a buffer. A buffer that grows is
    allocated on that stream, so the allocator hands the old one out again
    only to later work of the same stream, after the launches that read it.
    A launch that a CUDA graph warms up or captures takes the graph's own
    counters, allocated before its capture (sampling/graphs.py), so that no
    eager launch shares a buffer with a replay."""
    cap = _build._capture
    if cap is not None and cap.owns_stream():
        return cap.counters(device, n)
    key = (device.index, _build.raw_stream(device) if stream is None else stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        c = _COUNTERS[key] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
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
    out = _stats_affine_buffer(x, scale, bias, num_groups, eps, film_scale, film_shift)
    return out.select(0, 0), out.select(0, 1)  # cheaper on the host than unbind


def _stats_affine_buffer(x, scale, bias, num_groups, eps, film_scale, film_shift):
    """The (2, B, C) fp32 buffer of `_stats_affine`'s a and b (the
    ddnm::gn_stats_affine op returns it whole: an op's outputs may not
    alias each other)."""
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
    _build.count_launch(LAUNCHES, "groupnorm_stats")
    return out


def _stats_partial(x, num_groups):
    """(2, B, C) fp32 per-channel sums of x and x^2 over this shard's H*W:
    one launch of the stats kernel in its partial mode (the same plan)."""
    _check_input(x, num_groups)
    B, H, W, C = x.shape
    plan = _stats_plan(B, H * W, C, num_groups, x.element_size(), x.data_ptr() % 16 == 0)
    lib = _build.load_library()
    dev = x.device
    if plan["scratch"]:
        buf = x.new_empty(2 * B * C + plan["scratch"], dtype=torch.float32)
        out = buf[:2 * B * C].view(2, B, C)
        scratch, counters = buf.data_ptr() + 8 * B * C, _counters(dev, plan["counters"])
    else:
        out = x.new_empty((2, B, C), dtype=torch.float32)
        scratch = counters = None
    with _build.device_guard(dev):
        _build.check(lib.ddnm_gn_stats_partial(
            x.data_ptr(), out.data_ptr(), scratch,
            counters.data_ptr() if counters is not None else None, B, H * W, C, num_groups,
            plan["vec"], plan["span"], plan["n_blk"], plan["threads"], plan["lanes_c"],
            plan["smem"], _DTYPE_CODE[x.dtype], _build.raw_stream(dev)), "ddnm_gn_stats_partial")
    _build.count_launch(SPATIAL_LAUNCHES, "groupnorm_partial")
    return out


def _finalize(sums, hw, scale, bias, num_groups, eps, film_scale=None, film_shift=None):
    """Per-(B, C) fp32 affine (a, b) from the shards' added (2, B, C) sums
    over a map of `hw` pixels: one launch of the finalize kernel."""
    if not sums.is_cuda:
        raise ValueError("the GroupNorm finalize kernel takes CUDA tensors only")
    _, B, C = sums.shape
    if C % num_groups or not 1 <= B <= 65535 or 8 * num_groups > 48 * 1024:
        raise ValueError(f"GroupNorm finalize takes (2, B <= 65535, C) sums with C % G == 0, "
                         f"got {tuple(sums.shape)} and {num_groups} groups")
    dev = sums.device
    sums = _vec(sums, (2, B, C), dev)
    scale, bias = _vec(scale, (C,), dev), _vec(bias, (C,), dev)
    if film_scale is not None:
        film_scale = _vec(film_scale, (B, C), dev)
        film_shift = _vec(film_shift, (B, C), dev)
    lib = _build.load_library()
    out = sums.new_empty((2, B, C))
    with _build.device_guard(dev):
        _build.check(lib.ddnm_gn_finalize(
            sums.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            film_scale.data_ptr() if film_scale is not None else None,
            film_shift.data_ptr() if film_shift is not None else None, out.data_ptr(), B,
            int(hw), C, num_groups, float(eps), _build.raw_stream(dev)), "ddnm_gn_finalize")
    _build.count_launch(SPATIAL_LAUNCHES, "groupnorm_finalize")
    return out.select(0, 0), out.select(0, 1)


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
    _build.count_launch(LAUNCHES, "groupnorm_apply")
    return y


def _kernel_group_norm(x, scale, bias, num_groups, eps, swish,
                       film_scale=None, film_shift=None):
    a, b = _stats_affine(x, scale, bias, num_groups, eps, film_scale, film_shift)
    return _apply(x, a, b, swish)


def _sharded_affine(x, scale, bias, num_groups, eps, film_scale, film_shift, spatial, mode):
    """The whole map's (a, b) of one spatial shard's rows x: partial sums,
    every shard's added in rank order, the finalize."""
    B, H, W, C = x.shape
    hw = H * W * spatial.size
    if mode == "kernel":
        sums = spatial.sum_shards(_stats_partial(x, num_groups))
        return _finalize(sums, hw, scale, bias, num_groups, eps, film_scale, film_shift)
    sums = spatial.sum_shards(_torch_stats_partial(x))
    return _torch_affine_from_sums(sums, hw, scale, bias, num_groups, eps, film_scale,
                                   film_shift)


def _sharded_group_norm(x, scale, bias, num_groups, eps, swish, film_scale, film_shift,
                        spatial, mode):
    """GroupNorm of one spatial shard of a map (module docstring): partial
    sums, every shard's added in rank order, the finalize, the apply."""
    a, b = _sharded_affine(x, scale, bias, num_groups, eps, film_scale, film_shift, spatial,
                           mode)
    return _apply(x, a, b, swish) if mode == "kernel" else _torch_apply(x, a, b, swish)


def group_norm(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5,
               swish: bool = False, film_scale=None, film_shift=None,
               force: str | None = None, spatial=None):
    """NHWC GroupNorm with fp32 statistics, optional FiLM (B, C) scale/shift
    applied after normalization, and optional SiLU; returns x.dtype.

    `force`: None (the kernels for a CUDA tensor, the plain version for a
    CPU tensor), "kernel", "torch" or "op": the ddnm::gn_stats_affine and
    ddnm::gn_apply custom ops (ops/library.py), whose CUDA implementations
    are the kernels and whose CPU implementations the two plain versions
    `_torch_stats_affine` and `_torch_apply`. Traced code (torch.export)
    takes the ops under None and "kernel". `spatial`: x is this process's
    rows of a map split over a spatial group (parallel/spatial.py
    `SpatialGroup`); the statistics are the whole map's."""
    if (film_scale is None) != (film_shift is None):
        raise ValueError("film_scale and film_shift go together")
    mode = force or ("kernel" if x.is_cuda else "torch")
    if mode == "op" or (mode == "kernel" or force is None) and _build.tracing(x):
        if spatial is not None:
            raise ValueError("the spatial GroupNorm has no ddnm:: op route")
        ab = torch.ops.ddnm.gn_stats_affine(x, scale, bias, film_scale, film_shift,
                                            num_groups, eps)
        return torch.ops.ddnm.gn_apply(x, ab[0], ab[1], swish)
    if spatial is not None and mode in ("kernel", "torch"):
        return _sharded_group_norm(x, scale, bias, num_groups, eps, swish, film_scale,
                                   film_shift, spatial, mode)
    if mode == "torch":
        return _torch_group_norm(x, scale, bias, num_groups, eps, swish,
                                 film_scale, film_shift)
    if mode == "kernel":
        return _kernel_group_norm(x, scale, bias, num_groups, eps, swish,
                                  film_scale, film_shift)
    raise ValueError(f"force must be None, 'kernel', 'torch' or 'op', got {force!r}")


# ------------------------------------------------------------------ backward


def _silu_grad(u, dtype):
    """SiLU'(f) at f = u rounded to `dtype` (the value the forward's SiLU
    took; the rounding passes the gradient through), in fp32."""
    f = _wide(u.to(dtype))
    sig = torch.sigmoid(f)
    return sig * (1.0 + f * (1.0 - sig))


def _torch_bwd_partial(x, dy, swish, a=None, b=None):
    """(4, B, C) fp32 per-channel sums over H*W of x, x^2, dy' and dy' x
    (the backward reduce kernel's partial mode): dy' is dy through the
    SiLU's derivative at a x + b when `swish`."""
    xf, d = _wide(x), _wide(dy)
    if swish:
        d = d * _silu_grad(xf * a[:, None, None, :] + b[:, None, None, :], x.dtype)
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2)), d.sum(dim=(1, 2)),
                        (d * xf).sum(dim=(1, 2))])


def _torch_bwd_finalize(sums, hw, scale, num_groups, eps, film_scale=None, bias=None):
    """The (3, B, C) coefficients of dx = A dy' + Bx x + Cx from (4, B, C)
    per-channel sums (`_torch_bwd_partial`'s) over a map of `hw` pixels
    (gn_bwd_finalize_kernel): mean and rstd from the sums of x (the fast
    variance, as the forward), g = scale (1 + film_scale), and
    dx = rstd (g dy' - mean_g(g dy') - x^ mean_g(g dy' x^)).

    With `bias` (training) returns (coef, d_scale, d_bias, d_film_scale,
    d_film_shift): with sum dy' x^ = rstd (S_dyx - mean S_dy) per (image,
    channel), d film_shift = S_dy, d film_scale = scale sum dy' x^ + bias
    S_dy, d scale = sum_b (1 + film_scale) sum dy' x^, d bias = sum_b (1 +
    film_scale) S_dy (the FiLM pair None without FiLM)."""
    _, B, C = sums.shape
    g = scale.to(sums.dtype)[None].expand(B, C)
    if film_scale is not None:
        g = g * (1.0 + film_scale.to(sums.dtype))
    rep = C // num_groups
    n = hw * rep
    group = lambda t: t.reshape(B, num_groups, rep).sum(-1)
    mean = group(sums[0]) / n
    var = torch.clamp(group(sums[1]) / n - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    c1 = group(g * sums[2]) / n
    c2 = rstd * (group(g * sums[3]) / n - mean * c1)
    per_c = lambda t: torch.repeat_interleave(t, rep, dim=1)
    coef = torch.stack([per_c(rstd) * g, per_c(-rstd * rstd * c2),
                        per_c(rstd * (mean * rstd * c2 - c1))])
    if bias is None:
        return coef
    s_dy = sums[2]
    s_xhat = per_c(rstd) * (sums[3] - per_c(mean) * s_dy)
    if film_scale is None:
        return coef, s_xhat.sum(0), s_dy.sum(0), None, None
    f1 = 1.0 + film_scale.to(sums.dtype)
    d_fs = scale.to(sums.dtype)[None] * s_xhat + bias.to(sums.dtype)[None] * s_dy
    return coef, (f1 * s_xhat).sum(0), (f1 * s_dy).sum(0), d_fs, s_dy


def _torch_bwd_reduce(x, dy, scale, num_groups, eps, swish, a=None, b=None,
                      film_scale=None):
    """The per-(B, C) fp32 coefficients (3, B, C) of dx = A dy' + Bx x + Cx
    (`gn_bwd_reduce_kernel`): the partial sums of the whole map, folded."""
    B, H, W, C = x.shape
    return _torch_bwd_finalize(_torch_bwd_partial(x, dy, swish, a, b), H * W, scale,
                               num_groups, eps, film_scale)


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


# the backward reduce kernel's launch plan (`_bwd_reduce_plan`; csrc/groupnorm.cu)
_BWD_THREADS = 256          # kBwdThreads
_BWD_UNROLL = 4             # kBwdUnroll: pixels of x and of dy a thread copies a stage
_BWD_STAGES = 3             # kBwdStages: the ring's stages, all but one in flight
_BWD_RING_BYTES = _BWD_STAGES * _BWD_UNROLL * 2 * 16 * _BWD_THREADS  # kBwdRingBytes
_BWD_MAX_CLUSTER = 8        # kBwdMaxCluster
_BWD_MAX_SPAN = 2048        # channels of one span at most, where whole groups allow
_BWD_BLOCKS_PER_SM = 2      # __launch_bounds__(256, 2); two rings fit an SM
_BWD_BLOCK_BYTES = 8 << 10  # bytes of x a block reads, about: 2 vectors a thread
# bytes of a pixel a span keeps: where only channels are split, where runs of
# pixels are cut too, and where the map fills a wave (tools/sweep_gn_bwd_reduce.py)
_BWD_SPLIT_BYTES, _BWD_RUN_BYTES, _BWD_WAVE_BYTES = 32, 64, 128


def _bwd_reduce_smem(span: int, vec: int, cpg: int, elem_size: int) -> int:
    """Dynamic shared-memory bytes of the backward reduce kernel
    (csrc/groupnorm.cu `bwd_smem_bytes`): the block's sums [4][span] and
    the span's gamma and film_scale [2][span], then the larger of the
    16-byte path's ring (none at vec 1) and what overlays it once the
    pixels are summed: a work area for every thread's sums [4][256 vec]
    and then the sums the block finalises [4][span], the per-group rstd,
    Bx, Cx [3][span / cpg], and 16 bytes for the last-CTA flag."""
    work = max(4 * _BWD_THREADS * vec, 4 * span)
    tail = 4 * (work + 3 * (span // cpg)) + 16
    ring = _BWD_RING_BYTES if vec * elem_size == 16 else 0
    return 24 * span + max(ring, tail)


def _bwd_reduce_layout(B: int, HW: int, C: int, cpg: int, elem_size: int, vec: int,
                       span: int, runs: int, cluster: int) -> dict:
    """The launch of the backward reduce kernel for a chosen channel span,
    runs of pixels and cluster size: channel lanes, grid, shared memory,
    scratch and counters, as the C entry checks them."""
    lanes_c = min(1 << (span // vec - 1).bit_length(), _BWD_THREADS)
    clusters = runs // cluster
    per_run = B * (C // span)
    return {"vec": vec, "span": span, "threads": _BWD_THREADS, "lanes_c": lanes_c,
            "runs": runs, "cluster": cluster, "clusters": clusters,
            "grid": (runs, C // span, B),
            "smem": _bwd_reduce_smem(span, vec, cpg, elem_size),
            "scratch": 4 * B * C * clusters if clusters > 1 else 0,
            "counters": per_run * cluster if clusters > 1 else 0}


@functools.lru_cache(maxsize=256)
def _bwd_reduce_plan(B: int, HW: int, C: int, G: int, elem_size: int,
                     aligned: bool = True, sms: int = 132, partial: bool = False) -> dict:
    """The backward reduce kernel's launch for (B, H*W, C) with G groups;
    `partial`: its partial mode (a spatial shard's sums), the same launch
    with `out_rows` 4 per-(B, C) rows of output (sums of x, x^2, dy', dy'
    x) in place of 3 (A, Bx, Cx).

    Channels go 16 bytes a load (`vec`; 1 where x or dy is off 16 bytes or
    C is not a multiple), 256 threads a block: `lanes_c` channel lanes
    (the power of two at or above span / vec, at most 256; a wider span is
    walked in slots) times 256 / lanes_c pixel lanes. Each (image, channel
    span of whole groups) is cut into `runs` contiguous runs of pixels,
    one block each, in clusters of `cluster` CTAs.

    The grid is sized by bytes (`tools/sweep_gn_bwd_reduce.py` times other
    layouts at every classifier shape; PERF.md): `blocks` =
    x's bytes / _BWD_BLOCK_BYTES, at least one and at most one wave of
    _BWD_BLOCKS_PER_SM x sms blocks (rounded down to 32). A map has
    **enough work** to fill the card when its bytes make _BWD_BLOCKS_PER_SM
    x sms such blocks; it then takes spans of _BWD_WAVE_BYTES of a pixel,
    runs of pixels in clusters of 2 (8-CTA clusters measured slower there),
    and the grid holds at least `sms` blocks. A smaller map gets its blocks by channels
    alone where it can (spans of _BWD_SPLIT_BYTES or more, runs = 1: no
    combine across blocks), else takes spans of _BWD_RUN_BYTES and up to
    8 runs in one cluster. Where an (image, span) has several clusters,
    their sums meet in `scratch` (4 x B x C x clusters floats) and
    `counters` (B x spans x cluster integer counters, left zero); each CTA
    of the last cluster adds its half of the columns of every cluster sum
    (up to 64 of them at batch 1: fewer, larger runs measured slower). The
    whole row where C is too narrow to split.

    Also `threads`, `grid` (runs, spans, B) and `smem` (bytes, as the C
    entry checks them). Raises ValueError for a shape the kernel does not
    take."""
    if C % G:
        raise ValueError(f"channels {C} not divisible by {G} groups")
    cpg = C // G
    if cpg > STATS_MAX_SPAN:
        raise ValueError(f"GroupNorm kernel takes C / G <= {STATS_MAX_SPAN}, got {cpg}")
    if not 1 <= B <= 65535:  # CUDA grid z limit
        raise ValueError(f"GroupNorm backward takes 1 <= B <= 65535, got {B}")
    if HW < 1:
        raise ValueError(f"GroupNorm backward takes H*W >= 1, got {HW}")
    vec = 16 // elem_size if aligned else 1
    base = math.lcm(cpg, vec)
    if C % base or base > STATS_MAX_SPAN:
        vec, base = 1, cpg
    spans = [s for s in range(base, min(C, _BWD_MAX_SPAN) + 1, base) if C % s == 0] or [base]
    if C // spans[0] > 65535:  # CUDA grid y limit
        raise ValueError(f"GroupNorm kernel takes C / span <= 65535, got {C} / {spans[0]}")
    enough = B * HW * C * elem_size // _BWD_BLOCK_BYTES >= _BWD_BLOCKS_PER_SM * sms
    wave = _BWD_BLOCKS_PER_SM * sms // 32 * 32  # 256 on the H100: 264 measured slower
    blocks = max(1, min(wave, B * HW * C * elem_size // _BWD_BLOCK_BYTES))
    per_image = -(-blocks // B)
    at_least = lambda nbytes: next((s for s in spans if s * elem_size >= nbytes), spans[-1])
    split = at_least(_BWD_SPLIT_BYTES)
    if not enough and per_image <= C // split:  # channels alone
        span = max(s for s in spans if s >= split and C // s >= per_image)
        runs = cluster = 1
    else:
        span = at_least(_BWD_WAVE_BYTES if enough else _BWD_RUN_BYTES)
        runs = max(1, min(-(-per_image // (C // span)), HW))
        per_run = B * (C // span)
        if not enough or (runs <= _BWD_MAX_CLUSTER and per_run * runs <= sms):
            runs = cluster = 1 << (min(runs, _BWD_MAX_CLUSTER).bit_length() - 1)
        else:  # pairs
            cluster = 2
            fill = -(-min(blocks, sms) // per_run)
            runs = min(max(runs, fill + fill % 2), HW)
            runs -= runs % 2
            if runs < 2:
                runs = cluster = 1
    return {**_bwd_reduce_layout(B, HW, C, cpg, elem_size, vec, span, runs, cluster),
            "enough_work": enough, "out_rows": 4 if partial else 3}


def _bwd_launch(x, dy, scale, num_groups, eps, swish, a, b, film_scale, partial):
    """One launch of the backward reduce kernel, whole (the (3, B, C)
    coefficients of dx) or in its partial mode (the (4, B, C) sums)."""
    _check_input(x, num_groups)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("the GroupNorm backward takes a contiguous dy of x's shape and dtype")
    B, H, W, C = x.shape
    dev = x.device
    aligned = x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    plan = _bwd_reduce_plan(B, H * W, C, num_groups, x.element_size(), aligned,
                            _build.sm_count(dev), partial)
    lib = _build.load_library()
    if not partial:
        scale = _vec(scale, (C,), dev)
        if film_scale is not None:
            film_scale = _vec(film_scale, (B, C), dev)
    if swish:
        a, b = _vec(a, (B, C), dev), _vec(b, (B, C), dev)
    rows = plan["out_rows"]
    if plan["scratch"]:
        buf = x.new_empty(rows * B * C + plan["scratch"], dtype=torch.float32)
        out = buf[:rows * B * C].view(rows, B, C)
        scratch, counters = buf.data_ptr() + 4 * rows * B * C, _counters(dev, plan["counters"])
    else:
        out = x.new_empty((rows, B, C), dtype=torch.float32)
        scratch = counters = None
    ptr = lambda t: t.data_ptr() if t is not None else None
    tail = (int(bool(swish)), plan["vec"], plan["span"], plan["runs"], plan["cluster"],
            plan["lanes_c"], plan["smem"], _DTYPE_CODE[x.dtype], _build.raw_stream(dev))
    counts = counters.data_ptr() if counters is not None else None
    with _build.device_guard(dev):
        if partial:
            _build.check(lib.ddnm_gn_bwd_partial(
                x.data_ptr(), dy.data_ptr(), ptr(a) if swish else None,
                ptr(b) if swish else None, out.data_ptr(), scratch, counts, B, H * W, C,
                num_groups, *tail), "ddnm_gn_bwd_partial")
        else:
            _build.check(lib.ddnm_gn_bwd_reduce(
                x.data_ptr(), dy.data_ptr(), scale.data_ptr(), ptr(film_scale),
                ptr(a) if swish else None, ptr(b) if swish else None, out.data_ptr(), scratch,
                counts, B, H * W, C, num_groups, float(eps), *tail), "ddnm_gn_bwd_reduce")
    return out


def _bwd_reduce(x, dy, scale, num_groups, eps, swish, a=None, b=None, film_scale=None):
    """The (3, B, C) fp32 coefficients of dx: one launch of the backward
    reduce kernel."""
    out = _bwd_launch(x, dy, scale, num_groups, eps, swish, a, b, film_scale, False)
    _build.count_launch(LAUNCHES, "gn_bwd_reduce")
    return out


def _bwd_partial(x, dy, num_groups, swish, a=None, b=None):
    """(4, B, C) fp32 per-channel sums of x, x^2, dy' and dy' x over this
    shard's H*W: one launch of the backward reduce kernel in its partial
    mode (the same plan)."""
    out = _bwd_launch(x, dy, None, num_groups, 0.0, swish, a, b, None, True)
    _build.count_launch(SPATIAL_LAUNCHES, "gn_bwd_partial")
    return out


def _bwd_sums(x, dy, num_groups, swish, a=None, b=None):
    """(4, B, C) fp32 per-channel sums of x, x^2, dy' and dy' x over the
    whole map: the backward reduce kernel's partial mode, in training."""
    out = _bwd_launch(x, dy, None, num_groups, 0.0, swish, a, b, None, True)
    _build.count_launch(LAUNCHES, "gn_bwd_sums")
    return out


def _bwd_finalize(sums, hw, scale, num_groups, eps, film_scale=None, bias=None):
    """The (3, B, C) fp32 coefficients of dx from (4, B, C) sums over a map
    of `hw` pixels (the shards' added, or in training the whole map's):
    one launch of gn_bwd_finalize_kernel. With `bias` (training) returns
    (coef, d_scale, d_bias, d_film_scale, d_film_shift) from the same
    launch, every output in one fp32 allocation (the FiLM pair None without
    FiLM). Counted as "gn_bwd_finalize" in SPATIAL_LAUNCHES, or in training
    as "gn_bwd_param" in LAUNCHES."""
    if not sums.is_cuda:
        raise ValueError("the GroupNorm backward finalize kernel takes CUDA tensors only")
    _, B, C = sums.shape
    if C % num_groups or B < 1:
        raise ValueError(f"GroupNorm backward finalize takes (4, B, C) sums with C % G == 0, "
                         f"got {tuple(sums.shape)} and {num_groups} groups")
    dev = sums.device
    sums = _vec(sums, (4, B, C), dev)
    scale = _vec(scale, (C,), dev)
    params = bias is not None
    film = film_scale is not None
    if film:
        film_scale = _vec(film_scale, (B, C), dev)
    if params:
        bias = _vec(bias, (C,), dev)
    buf = sums.new_empty(3 * B * C + (2 * C + (2 * B * C if film else 0) if params else 0))
    coef = buf[:3 * B * C].view(3, B, C)
    d_scale = d_bias = d_fs = d_ft = None
    if params:
        d_scale, d_bias = buf[3 * B * C:3 * B * C + 2 * C].view(2, C).unbind(0)
        if film:
            d_fs, d_ft = buf[3 * B * C + 2 * C:].view(2, B, C).unbind(0)
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = _build.load_library()
    with _build.device_guard(dev):
        _build.check(lib.ddnm_gn_bwd_finalize(
            sums.data_ptr(), scale.data_ptr(), ptr(bias), ptr(film_scale), coef.data_ptr(),
            ptr(d_scale), ptr(d_bias), ptr(d_fs), ptr(d_ft), B, int(hw), C, num_groups,
            float(eps), _build.raw_stream(dev)), "ddnm_gn_bwd_finalize")
    if not params:
        _build.count_launch(SPATIAL_LAUNCHES, "gn_bwd_finalize")
        return coef
    _build.count_launch(LAUNCHES, "gn_bwd_param")
    return coef, d_scale, d_bias, d_fs, d_ft


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
    _build.count_launch(LAUNCHES, "gn_bwd_dx")
    return dx


class GroupNormFunction(torch.autograd.Function):
    """`group_norm` with its gradients: apply(x, scale, bias, film_scale,
    film_shift, num_groups, eps, swish, mode), mode "kernel" (the two
    forward kernels, then in the backward the reduce and dx kernels, or in
    training the reduce kernel's partial mode, the finalize and dx) or
    "torch" (the plain versions). dx always; the gradients of scale, bias,
    film_scale and film_shift where they require grad (training), from the
    same sums; a frozen affine (the classifier under guidance) takes the
    two-launch dx path."""

    @staticmethod
    def forward(ctx, x, scale, bias, film_scale, film_shift, num_groups, eps, swish, mode):
        if mode == "kernel":
            a, b = _stats_affine(x, scale, bias, num_groups, eps, film_scale, film_shift)
            y = _apply(x, a, b, swish)
        elif mode == "torch":
            y = _torch_group_norm(x, scale, bias, num_groups, eps, swish, film_scale, film_shift)
            a = b = None
            if swish:
                a, b = _torch_stats_affine(x, scale, bias, num_groups, eps, film_scale,
                                           film_shift)
        else:
            raise ValueError(f"mode must be 'kernel' or 'torch', got {mode!r}")
        ctx.save_for_backward(x, scale, bias, film_scale, a, b)
        ctx.conf = (num_groups, eps, swish, mode)
        return y

    @staticmethod
    def backward(ctx, dy):
        num_groups, eps, swish, mode = ctx.conf
        x, scale, bias, film_scale, a, b = ctx.saved_tensors
        params = ctx.needs_input_grad[1:5]
        B, H, W, C = x.shape
        dy = dy.to(x.dtype)
        grads = [None] * 4
        if mode == "kernel":
            dy = dy.contiguous()
            if any(params):
                sums = _bwd_sums(x, dy, num_groups, swish, a, b)
                coef, *grads = _bwd_finalize(sums, H * W, scale, num_groups, eps, film_scale,
                                             bias)
            else:
                coef = _bwd_reduce(x, dy, scale, num_groups, eps, swish, a, b, film_scale)
            dx = _bwd_dx(x, dy, coef, swish, a, b)
        else:
            sums = _torch_bwd_partial(x, dy, swish, a, b)
            coef, *grads = _torch_bwd_finalize(sums, H * W, scale, num_groups, eps,
                                               film_scale, bias)
            dx = _torch_bwd_dx(x, dy, coef, swish, a, b)
        grads = [g.to(t.dtype) if need and g is not None else None
                 for g, need, t in zip(grads, params, (scale, bias, film_scale, film_scale))]
        return (dx, *grads, None, None, None, None)


class ShardedGroupNormFunction(torch.autograd.Function):
    """GroupNormFunction over one spatial shard's rows of a map split over
    `spatial` (module docstring): apply(x, scale, bias, film_scale,
    film_shift, num_groups, eps, swish, mode, spatial). The forward is
    `group_norm(spatial=)`; the backward sums the shards' partial sums of
    x, x^2, dy' and dy' x in rank order (one all_gather, counted under
    "groupnorm_grad") and folds them, so that each shard's dx is its rows
    of the whole map's. Only x may require grad."""

    @staticmethod
    def forward(ctx, x, scale, bias, film_scale, film_shift, num_groups, eps, swish, mode,
                spatial):
        if any(t is not None and t.requires_grad
               for t in (scale, bias, film_scale, film_shift)):
            raise ValueError("ShardedGroupNormFunction gives the gradient of x only: the "
                             "scale, bias and FiLM must not require grad (training under "
                             "spatial shards is not ported)")
        if mode not in ("kernel", "torch"):
            raise ValueError(f"mode must be 'kernel' or 'torch', got {mode!r}")
        a, b = _sharded_affine(x, scale, bias, num_groups, eps, film_scale, film_shift, spatial,
                               mode)
        y = _apply(x, a, b, swish) if mode == "kernel" else _torch_apply(x, a, b, swish)
        ctx.save_for_backward(x, scale, film_scale, a, b)
        ctx.conf = (num_groups, eps, swish, mode, spatial)
        return y

    @staticmethod
    def backward(ctx, dy):
        num_groups, eps, swish, mode, spatial = ctx.conf
        x, scale, film_scale, a, b = ctx.saved_tensors
        B, H, W, C = x.shape
        hw = H * W * spatial.size
        if mode == "kernel":
            dy = dy.to(x.dtype).contiguous()
            sums = spatial.sum_shards(_bwd_partial(x, dy, num_groups, swish, a, b),
                                      "groupnorm_grad")
            coef = _bwd_finalize(sums, hw, scale, num_groups, eps, film_scale)
            dx = _bwd_dx(x, dy, coef, swish, a, b)
        else:
            dy = dy.to(x.dtype)
            sums = spatial.sum_shards(_torch_bwd_partial(x, dy, swish, a, b), "groupnorm_grad")
            coef = _torch_bwd_finalize(sums, hw, scale, num_groups, eps, film_scale)
            dx = _torch_bwd_dx(x, dy, coef, swish, a, b)
        return dx, None, None, None, None, None, None, None, None, None
