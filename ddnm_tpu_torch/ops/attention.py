"""Attention over flat token grids (B*, T, C) with an fp32 softmax.

Port of `ddnm_tpu/ops/attention.py`. On a CUDA tensor `fused_attention`
runs the hand-written flash-style kernel of `csrc/attention.cu`; on a CPU
tensor it runs `_torch_attention`, the plain PyTorch version that follows
the JAX package's `_xla_attention`: scores in the input dtype, softmax in
fp32, probabilities cast back to the input dtype before P V.

`force="torch"` selects the plain version on any device, `force="kernel"`
the kernel (and raises on a CPU tensor). There is no fallback.
"""

from __future__ import annotations

import torch

from ddnm_tpu_torch.ops import _build

__all__ = ["fused_attention", "LAUNCHES"]

LAUNCHES = {"attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 512  # kMaxC in csrc/attention.cu


def _torch_attention(q, k, v, scale):
    """ddnm_tpu/ops/attention.py _xla_attention in PyTorch."""
    w = torch.einsum("btc,bsc->bts", q, k) * scale
    w = torch.softmax(w.float(), dim=-1).to(q.dtype)
    return torch.einsum("bts,bsc->btc", w, v)


def _kernel_attention(q, k, v, scale):
    if not q.is_cuda:
        raise ValueError("the attention kernel takes CUDA tensors only")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32/bfloat16, got {q.dtype}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share shape, dtype and device")
    if q.ndim != 3:
        raise ValueError(f"attention kernel takes (B, T, C), got {tuple(q.shape)}")
    B, T, C = q.shape
    if B > 65535:  # CUDA grid y limit
        raise ValueError(f"attention kernel takes B* <= 65535, got {B}")
    if C % 32 or C > _MAX_C:
        raise ValueError(f"attention kernel takes C % 32 == 0 and C <= {_MAX_C}, got {C}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel takes contiguous q, k and v")
    lib = _build.load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _build.check(lib.ddnm_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, C,
            float(scale), _DTYPE_CODE[q.dtype], stream), "ddnm_attention")
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
