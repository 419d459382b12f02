"""Attention over flat token grids (B*, T, C) with an fp32 softmax.

Port of `ddnm_tpu/ops/attention.py`. On a CUDA tensor `fused_attention`
runs the hand-written kernels of `csrc/attention.cu`: for bf16 a
tensor-core kernel (mma.sync, whole-row softmax up to T = 1024, online
softmax above), for fp32 a CUDA-core FMA kernel. On a CPU tensor it runs
`_torch_attention`, the plain PyTorch version that follows the JAX
package's `_xla_attention`: scores in the input dtype, softmax in fp32,
probabilities cast back to the input dtype before P V.

`force="torch"` selects the plain version on any device, `force="kernel"`
the kernel (and raises on a CPU tensor). There is no fallback.
"""

from __future__ import annotations

import functools

import torch

from ddnm_tpu_torch.ops import _build

__all__ = ["fused_attention", "LAUNCHES"]

LAUNCHES = {"attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 512  # kMaxC in csrc/attention.cu

# the bf16 tensor-core kernel's launch constants (csrc/attention.cu)
_Q_ROWS = 16                # kQ: query rows per block
_THREADS = 128              # kMmaThreads: 4 warps
_STAGES = 2                 # kStages: K / V tiles in the ring
WHOLE_ROW_MAX_T = 1024      # kWholeRowMaxT: longest T with the whole-row softmax
_ROW_PAD, _SCORE_PAD = 8, 8  # kRowPad (bf16), kScorePad (fp32)
# the fp32 FMA kernel's (csrc/attention.cu kBQ, kThreads; 45.4 KB static)
_FMA_Q_ROWS, _FMA_THREADS = 16, 256


def _key_tile(C: int) -> int:
    """key_tile() in csrc/attention.cu: keys per K / V tile (32-68 KB)."""
    return 64 if C > 256 else (128 if C > 128 else 256)


def _torch_attention(q, k, v, scale):
    """ddnm_tpu/ops/attention.py _xla_attention in PyTorch."""
    w = torch.einsum("btc,bsc->bts", q, k) * scale
    w = torch.softmax(w.float(), dim=-1).to(q.dtype)
    return torch.einsum("bts,bsc->btc", w, v)


@functools.lru_cache(maxsize=256)
def _attention_plan(B: int, T: int, C: int, dtype: torch.dtype) -> dict:
    """The kernel launch for (B, T, C) in `dtype`: kernel, grid, threads,
    dynamic shared-memory bytes and, for bf16, the softmax path. Raises
    ValueError for a shape the kernels do not take."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32/bfloat16, got {dtype}")
    if B > 65535:  # CUDA grid y limit
        raise ValueError(f"attention kernel takes B* <= 65535, got {B}")
    if C % 32 or C > _MAX_C:
        raise ValueError(f"attention kernel takes C % 32 == 0 and C <= {_MAX_C}, got {C}")
    if T < 1:
        raise ValueError(f"attention kernel takes T >= 1, got {T}")
    if dtype == torch.float32:
        return {"kernel": "fma", "grid": (-(-T // _FMA_Q_ROWS), B), "threads": _FMA_THREADS,
                "smem": 0, "whole": False, "key_tile": 0, "tma": False}
    whole = T <= WHOLE_ROW_MAX_T
    kt, tma = _key_tile(C), C % 64 == 0  # uses_tma() in csrc/attention.cu
    row = C + _ROW_PAD
    score_cols = (-(-T // kt) * kt if whole else kt) + _SCORE_PAD
    stage = kt * (C if tma else row) * 2
    smem = ((1024 if tma else 0) + _STAGES * stage + 8 * _STAGES + _Q_ROWS * row * 2
            + _Q_ROWS * score_cols * 4 + 3 * _Q_ROWS * 4)  # mma_layout() in csrc/attention.cu
    return {"kernel": "mma", "grid": (-(-T // _Q_ROWS), B), "threads": _THREADS,
            "smem": smem, "whole": whole, "key_tile": kt, "tma": tma}


def _aligned(t):
    """t itself, or a copy when its data does not start on 16 bytes (the
    bf16 kernel copies rows in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_attention(q, k, v, scale):
    if not q.is_cuda:
        raise ValueError("the attention kernel takes CUDA tensors only")
    shape, dtype, dev = q.shape, q.dtype, q.device
    for t in (k, v):
        if t.shape != shape or t.dtype != dtype or t.device != dev:
            raise ValueError("q, k and v must share shape, dtype and device")
    if len(shape) != 3:
        raise ValueError(f"attention kernel takes (B, T, C), got {tuple(shape)}")
    B, T, C = shape
    plan = _attention_plan(B, T, C, dtype)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel takes contiguous q, k and v")
    if plan["kernel"] == "mma":
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lib = _build.load_library()
    out = torch.empty_like(q)
    with _build.device_guard(dev):
        _build.check(lib.ddnm_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, C,
            float(scale), _DTYPE_CODE[dtype], int(plan["whole"]), plan["smem"],
            _build.raw_stream(dev)), "ddnm_attention")
    LAUNCHES["attention"] += 1
    return out


def fused_attention(q, k, v, scale: float, *, force: str | None = None):
    """softmax(q k^T * scale) v over (B*, T, C); fp32 softmax.

    `force`: None (the kernel for a CUDA tensor, the plain version for a CPU
    tensor), "kernel" or "torch"."""
    mode = force or ("kernel" if q.is_cuda else "torch")
    if mode == "torch":
        return _torch_attention(q, k, v, scale)
    if mode == "kernel":
        return _kernel_attention(q, k, v, scale)
    raise ValueError(f"force must be None, 'kernel' or 'torch', got {force!r}")
