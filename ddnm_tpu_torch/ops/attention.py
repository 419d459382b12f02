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

`AttentionFunction` is the same forward with the gradients for q, k and v
(the classifier-guidance gradient). Its backward runs two more kernels of
csrc/attention.cu on a CUDA tensor, fp32 FMA on the CUDA cores in both
types: `attn_bwd_dq` (one block per 32 query rows: each row's log-sum-exp
and D = rowsum(dO o O) recomputed, dQ written, LSE and D stored) and
`attn_bwd_dkdv` (one block per 32 keys over all query tiles: dK and dV),
each beside its plain version (`_torch_attn_bwd_dq`, `_torch_attn_bwd_dkdv`;
`_torch_attention_backward` is both in plain PyTorch). Head dimensions
32, 64 and 128 (`_bwd_plan`).
"""

from __future__ import annotations

import functools

import torch

from ddnm_tpu_torch.ops import _build

__all__ = ["fused_attention", "AttentionFunction", "LAUNCHES"]

LAUNCHES = {"attention": 0, "attn_bwd_dq": 0, "attn_bwd_dkdv": 0}

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
# the backward kernels' (csrc/attention.cu kBwd*): 256 threads; the dq
# kernel takes 32 query rows a block and 64 keys a tile, the dkdv kernel 32
# keys a block and 64 query rows a tile; head dimensions it is built for
_BWD_THREADS, _BWD_Q, _BWD_K, _BWD_KV, _BWD_QT = 256, 32, 64, 32, 64
BWD_HEAD_DIMS = (32, 64, 128)


def _key_tile(C: int) -> int:
    """key_tile() in csrc/attention.cu: keys per K / V tile (32-68 KB)."""
    return 64 if C > 256 else (128 if C > 128 else 256)


def _wide(t):
    """t in fp32 (the softmax's and the backward's arithmetic), or as it is
    in float64 (gradcheck's type)."""
    return t if t.dtype == torch.float64 else t.float()


def _torch_attention(q, k, v, scale):
    """ddnm_tpu/ops/attention.py _xla_attention in PyTorch."""
    w = torch.einsum("btc,bsc->bts", q, k) * scale
    w = torch.softmax(_wide(w), dim=-1).to(q.dtype)
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


# ------------------------------------------------------------------ backward


def _torch_attn_bwd_dq(q, k, v, o, do, scale):
    """(dq, lse, dsum) in fp32 arithmetic, dq cast to q.dtype
    (`attn_bwd_dq_kernel`): lse the log-sum-exp of each row's scaled
    scores, dsum = rowsum(do o o), dq = (P o (do v^T - dsum)) k scale."""
    qf, kf, vf, of, dof = (_wide(t) for t in (q, k, v, o, do))
    s = torch.einsum("btc,bsc->bts", qf, kf) * scale
    lse = torch.logsumexp(s, dim=-1)
    dsum = (dof * of).sum(-1)
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.einsum("btc,bsc->bts", dof, vf) - dsum[..., None])
    return (torch.einsum("bts,bsc->btc", ds, kf) * scale).to(q.dtype), lse, dsum


def _torch_attn_bwd_dkdv(q, k, v, do, lse, dsum, scale):
    """(dk, dv) in fp32 arithmetic, cast to k.dtype (`attn_bwd_dkdv_kernel`),
    with P recomputed from the stored lse and dS from the stored dsum."""
    qf, kf, vf, dof = (_wide(t) for t in (q, k, v, do))
    p = torch.exp(torch.einsum("btc,bsc->bts", qf, kf) * scale - lse[..., None])
    ds = p * (torch.einsum("btc,bsc->bts", dof, vf) - dsum[..., None])
    dk = torch.einsum("bts,btc->bsc", ds, qf) * scale
    dv = torch.einsum("bts,btc->bsc", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def _torch_attention_backward(q, k, v, o, do, scale):
    """(dq, dk, dv) of softmax(q k^T scale) v given o and do, by the
    explicit formula (not autograd): the plain version of the two backward
    kernels."""
    dq, lse, dsum = _torch_attn_bwd_dq(q, k, v, o, do, scale)
    return (dq, *_torch_attn_bwd_dkdv(q, k, v, do, lse, dsum, scale))


@functools.lru_cache(maxsize=256)
def _bwd_plan(B: int, T: int, C: int, dtype: torch.dtype) -> dict:
    """The two backward kernels' launches for (B, T, C): grid, threads and
    dynamic shared-memory bytes of each (rows padded to C + 1 floats; the
    kernels' bwd_*_smem_floats). Raises ValueError for a shape they do not
    take."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"attention backward takes float32/bfloat16, got {dtype}")
    if C not in BWD_HEAD_DIMS:
        raise ValueError(f"attention backward takes C in {BWD_HEAD_DIMS}, got {C}")
    if B < 1 or B > 65535:  # CUDA grid y limit
        raise ValueError(f"attention backward takes 1 <= B* <= 65535, got {B}")
    if T < 1:
        raise ValueError(f"attention backward takes T >= 1, got {T}")
    dq = 4 * ((2 * _BWD_Q + 2 * _BWD_K) * (C + 1) + _BWD_Q * (_BWD_K + 1) + _BWD_Q)
    dkdv = 4 * ((2 * _BWD_KV + 2 * _BWD_QT) * (C + 1) + 2 * _BWD_KV * (_BWD_QT + 1)
                + 2 * _BWD_QT)
    return {"threads": _BWD_THREADS,
            "dq": {"grid": (-(-T // _BWD_Q), B), "smem": dq},
            "dkdv": {"grid": (-(-T // _BWD_KV), B), "smem": dkdv}}


def _check_bwd(tensors, names):
    shape, dtype, dev = tensors[0].shape, tensors[0].dtype, tensors[0].device
    if not tensors[0].is_cuda:
        raise ValueError("the attention backward kernels take CUDA tensors only")
    for t, name in zip(tensors, names):
        if t.shape != shape or t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"attention backward: {name} must be a contiguous tensor of "
                             f"q's shape {tuple(shape)}, dtype and device")
    if len(shape) != 3:
        raise ValueError(f"attention backward takes (B, T, C), got {tuple(shape)}")
    return _bwd_plan(*shape, dtype)


def _attn_bwd_dq(q, k, v, o, do, scale):
    """(dq, lse, dsum): one launch of the dq kernel; lse and dsum are the
    (B, T) fp32 rows the dkdv kernel reads."""
    plan = _check_bwd((q, k, v, o, do), ("q", "k", "v", "o", "do"))
    B, T, C = q.shape
    lib = _build.load_library()
    dq = torch.empty_like(q)
    rows = q.new_empty((2, B, T), dtype=torch.float32)
    dev = q.device
    with _build.device_guard(dev):
        _build.check(lib.ddnm_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(), B, T, C, float(scale),
            _DTYPE_CODE[q.dtype], plan["dq"]["smem"], _build.raw_stream(dev)),
            "ddnm_attention_bwd_dq")
    LAUNCHES["attn_bwd_dq"] += 1
    return dq, rows[0], rows[1]


def _attn_bwd_dkdv(q, k, v, do, lse, dsum, scale):
    """(dk, dv): one launch of the dkdv kernel."""
    plan = _check_bwd((q, k, v, do), ("q", "k", "v", "do"))
    B, T, C = q.shape
    for t in (lse, dsum):
        if t.shape != (B, T) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("attention backward: lse and dsum are contiguous (B, T) fp32")
    lib = _build.load_library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dev = q.device
    with _build.device_guard(dev):
        _build.check(lib.ddnm_attention_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, C, float(scale),
            _DTYPE_CODE[q.dtype], plan["dkdv"]["smem"], _build.raw_stream(dev)),
            "ddnm_attention_bwd_dkdv")
    LAUNCHES["attn_bwd_dkdv"] += 1
    return dk, dv


class AttentionFunction(torch.autograd.Function):
    """`fused_attention` with the gradients for q, k and v: apply(q, k, v,
    scale, mode), mode "kernel" (the forward kernel and the two backward
    kernels) or "torch" (the plain versions)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mode):
        if mode == "kernel":
            o = _kernel_attention(q, k, v, scale)
        elif mode == "torch":
            o = _torch_attention(q, k, v, scale)
        else:
            raise ValueError(f"mode must be 'kernel' or 'torch', got {mode!r}")
        ctx.save_for_backward(q, k, v, o)
        ctx.conf = (float(scale), mode)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        scale, mode = ctx.conf
        do = do.to(q.dtype).contiguous()
        if mode == "kernel":
            dq, lse, dsum = _attn_bwd_dq(q, k, v, o, do, scale)
            dk, dv = _attn_bwd_dkdv(q, k, v, do, lse, dsum, scale)
        else:
            dq, dk, dv = _torch_attention_backward(q, k, v, o, do, scale)
        return dq, dk, dv, None, None
