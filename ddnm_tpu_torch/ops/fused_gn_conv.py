"""Fused GroupNorm affine -> SiLU -> 3x3 SAME convolution over NHWC bf16.

Port of the fused GN+SiLU+conv experiment (tools/experiments/fused_gn_conv.py
and fused_gn_conv_ablations.py), which is an experiment and not a route of
the UNet. Three modes share one kernel entry point:

  - "full": the Pallas `_pallas_raw` / `_call(_kernel)`: per-(B, C) affine
    a, b from the GroupNorm statistics, then silu(x * a + b) in fp32, zeroed
    outside the image (the convolution's zero padding is the activation's),
    rounded once to bf16, then the 3x3 SAME convolution with fp32
    accumulation, rounded once to bf16;
  - "conv": `_call(_kernel_noact)`: the 3x3 SAME convolution of the raw x;
  - "act": `_call(_kernel_nodot)`: silu(x * a + b) in fp32, one rounding.

On a CUDA tensor the affine comes from the ported GroupNorm stats kernel
(`groupnorm._stats_affine`, 1 launch; the counterpart of the experiment's
`gn_stats_affine`), then one launch of `csrc/fused_gn_conv.cu`: 2 launches
for "full" and "act", 1 for "conv". "full" and "conv" run the wgmma + TMA
implicit-GEMM kernel with the launch plan of `_conv_plan`. On a CPU tensor
`_torch_fused_gn_conv` runs the same arithmetic in plain PyTorch.
`force="torch"` selects the plain version on any device, `force="kernel"`
the kernel (and raises on a CPU tensor). There is no fallback.

Shapes follow the JAX experiment: x (B, H, W, C) bf16, w HWIO (3, 3, C, C)
bf16, gamma and beta (C,) fp32, C a multiple of 32. The GroupNorm
statistics take one pass (sum and sum of squares, clamped), where the
experiment takes a two-pass variance.
"""

from __future__ import annotations

import functools

import torch
from torch.nn import functional as F

from ddnm_tpu_torch.ops import _build
from ddnm_tpu_torch.ops.groupnorm import _stats_affine, _torch_stats_affine

__all__ = ["fused_gn_conv", "LAUNCHES"]

# launches of the kernel wrapper since the last reset (ops.reset_launch_counts)
LAUNCHES = {"fused_gn_conv": 0}

_MODE_CODE = {"full": 0, "conv": 1, "act": 2}

# the conv kernel's launch plan (`_conv_plan`; csrc/fused_gn_conv.cu)
_TILE = 16                    # output tile: 16 x 16 pixels of one image
_HALO_PIX = (_TILE + 2) ** 2  # its halo
_EPI_BYTES = 2 * 2 * 64 * 64 * 2  # two staging buffers (64 px x 64 ch) per consumer
_HALO_STAGES = 2              # kHaloStages
_MAX_W_STAGES = 8             # kMaxWStages
_BAR_BYTES = 8 * (3 * _HALO_STAGES + 2 * _MAX_W_STAGES)  # the rings' mbarriers


def _torch_act(x, a, b):
    """silu(x * a + b) in fp32, one rounding to bf16."""
    xn = x.float() * a[:, None, None, :] + b[:, None, None, :]
    return (xn * torch.sigmoid(xn)).to(torch.bfloat16)


def _torch_conv3x3(h, w):
    """3x3 SAME convolution of bf16 h (NHWC) by bf16 w (HWIO), computed in
    fp32 on the bf16 values and rounded once to bf16 (the kernel's
    arithmetic; on a card the caller turns TF32 off)."""
    out = F.conv2d(h.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def _torch_fused_gn_conv(x, w, gamma, beta, num_groups, eps, mode):
    """The plain version of each mode. The conv's zero padding pads the
    activation, so the border is the mask after the SiLU."""
    if mode == "conv":
        return _torch_conv3x3(x, w)
    a, b = _torch_stats_affine(x, gamma, beta, num_groups, eps)
    h = _torch_act(x, a, b)
    return h if mode == "act" else _torch_conv3x3(h, w)


def _check(x, w, num_groups, mode):
    if not x.is_cuda:
        raise ValueError("the fused GN+SiLU+conv kernel takes CUDA tensors only")
    if x.dtype != torch.bfloat16 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("the fused GN+SiLU+conv kernel takes a contiguous NHWC bf16 "
                         f"x, got {x.dtype} {tuple(x.shape)} strides {x.stride()}")
    B, H, W, C = x.shape
    if C % 32 or C % num_groups:
        raise ValueError(f"channels {C}: the kernel takes C % 32 == 0 and "
                         f"C % num_groups == 0 ({num_groups} groups)")
    if H * W * C >= 2**31 or B > 65535:
        raise ValueError(f"the kernel takes H*W*C < 2^31 and B <= 65535, got {tuple(x.shape)}")
    if mode != "act":
        if w is None or tuple(w.shape) != (3, 3, C, C) or w.dtype != torch.bfloat16:
            raise ValueError(f"w must be HWIO (3, 3, {C}, {C}) bf16, got "
                             f"{None if w is None else (w.dtype, tuple(w.shape))}")
        if w.device != x.device:
            raise ValueError("x and w must be on the same device")


@functools.lru_cache(maxsize=256)
def _conv_plan(B: int, H: int, W: int, C: int, sms: int = 132) -> dict:
    """The conv kernel's launch (modes "full" and "conv") for NHWC
    (B, H, W, C): channels per K chunk (`kc`: 64, or 32 where C % 64 != 0;
    also the swizzle, 128 or 64 bytes), output channels per tile (`bn`: 64
    up to C = 64, else 128, or 64 where 128 leaves SMs idle), 16 x 16-pixel
    tiles, the weights ring's stages (as many as fit beside the two halo
    stages and the epilogue's buffers, at most 8), the persistent
    grid (at most one block per SM) and the dynamic shared-memory bytes
    (csrc/fused_gn_conv.cu conv_layout). Raises ValueError for a shape the
    kernel does not take."""
    if C % 32 or C <= 0:
        raise ValueError(f"channels {C}: the conv kernel takes C % 32 == 0")
    if min(B, H, W) < 1:
        raise ValueError(f"the conv kernel takes a non-empty map, got {(B, H, W, C)}")
    kc = 64 if C % 64 == 0 else 32
    spatial = B * -(-H // _TILE) * -(-W // _TILE)
    bn = 64 if C <= 64 or (C % 64 == 0 and spatial * -(-C // 128) < sms) else 128
    tiles = spatial * -(-C // bn)
    if tiles >= 2**31:
        raise ValueError(f"the conv kernel takes fewer than 2^31 tiles, got {tiles}")
    halo_stage = -(-_HALO_PIX * kc * 2 // 1024) * 1024
    w_stage = kc * bn * 2
    fixed = 1024 + _HALO_STAGES * halo_stage + _EPI_BYTES + _BAR_BYTES
    w_stages = min(_MAX_W_STAGES, (_build.SMEM_PER_BLOCK - fixed) // w_stage)
    return {"kc": kc, "bn": bn, "tile": (_TILE, _TILE), "w_stages": w_stages, "tiles": tiles,
            "grid": min(tiles, sms), "threads": 384, "smem": fixed + w_stages * w_stage}


def _kernel_fused_gn_conv(x, w, gamma, beta, num_groups, eps, mode):
    _check(x, w, num_groups, mode)
    lib = _build.load_library()
    B, H, W, C = x.shape
    dev = x.device
    a = b = None
    if mode != "conv":
        a, b = _stats_affine(x, gamma, beta, num_groups, eps, None, None)
    plan = {"kc": 0, "bn": 0, "w_stages": 0, "grid": 0, "smem": 0}
    w2 = None
    if mode != "act":
        plan = _conv_plan(B, H, W, C, _build.sm_count(dev))
        # rows (dy, dx, c_in), as tools/experiments/fused_gn_conv.py:113
        w2 = w.reshape(9 * C, C)
        if not w2.is_contiguous():
            w2 = w2.contiguous()
    y = torch.empty_like(x)
    for t in (x, w2, y):  # TMA tensor maps and 16-byte vector loads
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the fused GN+SiLU+conv kernel needs 16-byte aligned tensors")
    ptr = lambda t: None if t is None else t.data_ptr()
    with _build.device_guard(dev):
        _build.check(lib.ddnm_fused_gn_conv(
            x.data_ptr(), ptr(w2), ptr(a), ptr(b), y.data_ptr(), B, H, W, C,
            _MODE_CODE[mode], plan["kc"], plan["bn"], plan["w_stages"], plan["grid"],
            plan["smem"], _build.raw_stream(dev)), "ddnm_fused_gn_conv")
    _build.count_launch(LAUNCHES, "fused_gn_conv")
    return y


def fused_gn_conv(x, w, gamma, beta, *, num_groups: int = 32, eps: float = 1e-5,
                  mode: str = "full", force: str | None = None):
    """GroupNorm affine -> SiLU -> 3x3 SAME conv ("full"), the conv alone
    ("conv", gamma and beta unused) or the activation alone ("act", w
    unused); NHWC bf16 in and out, HWIO weights, no conv bias.

    `force`: None (the kernel for a CUDA tensor, the plain version for a CPU
    tensor), "kernel" or "torch"."""
    if mode not in _MODE_CODE:
        raise ValueError(f"mode must be one of {tuple(_MODE_CODE)}, got {mode!r}")
    route = force or ("kernel" if x.is_cuda else "torch")
    if route == "torch":
        return _torch_fused_gn_conv(x, w, gamma, beta, num_groups, eps, mode)
    if route == "kernel":
        return _kernel_fused_gn_conv(x, w, gamma, beta, num_groups, eps, mode)
    raise ValueError(f"force must be None, 'kernel' or 'torch', got {force!r}")
