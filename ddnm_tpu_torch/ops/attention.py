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

q may hold fewer tokens than k and v (Tq != Tk): one spatial shard's
queries against the keys and values gathered from every shard
(models/nn.py `attention(..., spatial=)`). The kernels then launch through
`ddnm_attention_kv`, with the launch plan of the keys' length, and count
in `SPATIAL_LAUNCHES["attention_gathered"]`; Tq == Tk keeps the launch it
had.

`AttentionFunction` is the same forward with the gradients for q, k and v
(the classifier-guidance gradient). Its backward runs two more kernels of
csrc/attention.cu on a CUDA tensor: `attn_bwd_dq` (dQ; each row's
log-sum-exp and D = rowsum(dO o O) recomputed and stored) and
`attn_bwd_dkdv` (dK and dV from the stored LSE and D), each beside its
plain version (`_torch_attn_bwd_dq`, `_torch_attn_bwd_dkdv`;
`_torch_attention_backward` is both in plain PyTorch). For bf16 both run on
the tensor cores (mma.sync; 64 resident rows a block, the other operand
pair streamed by TMA, P and dS rounded to bf16 as mma operands); for fp32
both are FMA kernels on the CUDA cores (32 rows a block), which keep the
fp32 gates. Head dimensions 32, 64 and 128 (`_bwd_plan`), and in fp32 also
256 and 512 (the DDPM UNet's single-head AttnBlocks in training; at 512
the fp32 kernels take 16 rows a block, so that their padded rows fit a
block's shared memory). What holds the
bf16 pair back (2.3x SDPA's autograd backward at (32, 1024, 64) on an
H100): registers bound the blocks an SM, every warp reads the whole
streamed tile for its 16 rows, and the dq pass sweeps K twice (the LSE).

The backward takes Tq != Tk as the forward does (a spatial shard's queries
against the gathered keys, under grad): both kernels launch through
`ddnm_attention_bwd_dq_kv` / `ddnm_attention_bwd_dkdv_kv` and count in
`SPATIAL_LAUNCHES["attn_bwd_dq_gathered"]` / `["attn_bwd_dkdv_gathered"]`.
Their dk and dv are then this shard's partials of every key's gradient.
"""

from __future__ import annotations

import functools

import torch

from ddnm_tpu_torch.ops import _build

__all__ = ["fused_attention", "AttentionFunction", "LAUNCHES"]

LAUNCHES = {"attention": 0, "attn_bwd_dq": 0, "attn_bwd_dkdv": 0}
# the forward and the two backward passes with Tq != Tk (a spatial shard's
# queries, every shard's keys)
SPATIAL_LAUNCHES = {"attention_gathered": 0, "attn_bwd_dq_gathered": 0,
                    "attn_bwd_dkdv_gathered": 0}

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
# the bf16 backward kernels' (kBwdRows, kBwdMmaThreads): 64 resident rows
# and 4 warps a block
_BWD_ROWS, _BWD_MMA_THREADS = 64, 128
# head dimensions the fp32 backward kernels are built for (256 and 512: the
# DDPM UNet's single-head AttnBlocks in training), and the bf16 ones
BWD_HEAD_DIMS = (32, 64, 128, 256, 512)
BWD_BF16_HEAD_DIMS = (32, 64, 128)


def _fp32_bwd_tiles(C: int) -> tuple[int, int]:
    """csrc/attention.cu bwd_rows(C) and 8 * bwd_per_lane(C): the fp32
    backward kernels' rows a block (the dq kernel's queries, the dkdv
    kernel's keys; 8 threads each) and the rows of a streamed tile (32 and
    64 up to C = 256; 16 and 32 at C = 512, where the padded rows would
    not fit a block's shared memory)."""
    return (16, 32) if C > 256 else (32, 64)


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
def _attention_plan(B: int, T: int, C: int, dtype: torch.dtype, Tk: int | None = None
                    ) -> dict:
    """The kernel launch for (B, T, C) queries against (B, Tk, C) keys and
    values (Tk = T by default) in `dtype`: kernel, grid (by the queries),
    threads, dynamic shared-memory bytes and, for bf16, the softmax path
    (both by the keys). Raises ValueError for a shape the kernels do not
    take."""
    Tk = T if Tk is None else Tk
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32/bfloat16, got {dtype}")
    if B > 65535:  # CUDA grid y limit
        raise ValueError(f"attention kernel takes B* <= 65535, got {B}")
    if C % 32 or C > _MAX_C:
        raise ValueError(f"attention kernel takes C % 32 == 0 and C <= {_MAX_C}, got {C}")
    if T < 1 or Tk < 1:
        raise ValueError(f"attention kernel takes T >= 1, got {T} queries and {Tk} keys")
    if dtype == torch.float32:
        return {"kernel": "fma", "grid": (-(-T // _FMA_Q_ROWS), B), "threads": _FMA_THREADS,
                "smem": 0, "whole": False, "key_tile": 0, "tma": False}
    whole = Tk <= WHOLE_ROW_MAX_T
    kt, tma = _key_tile(C), C % 64 == 0  # uses_tma() in csrc/attention.cu
    row = C + _ROW_PAD
    score_cols = (-(-Tk // kt) * kt if whole else kt) + _SCORE_PAD
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
    if len(shape) != 3:
        raise ValueError(f"attention kernel takes (B, T, C), got {tuple(shape)}")
    if k.shape != v.shape or k.ndim != 3 or (k.shape[0], k.shape[2]) != (shape[0], shape[2]):
        raise ValueError(f"attention kernel takes q (B, Tq, C) and k, v (B, Tk, C), got "
                         f"{tuple(shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    for t in (k, v):
        if t.dtype != dtype or t.device != dev:
            raise ValueError("q, k and v must share dtype and device")
    B, T, C = shape
    Tk = k.shape[1]
    plan = _attention_plan(B, T, C, dtype, Tk)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel takes contiguous q, k and v")
    if plan["kernel"] == "mma":
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    lib = _build.load_library()
    out = torch.empty_like(q)
    with _build.device_guard(dev):
        if Tk == T:
            _build.check(lib.ddnm_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, C,
                float(scale), _DTYPE_CODE[dtype], int(plan["whole"]), plan["smem"],
                _build.raw_stream(dev)), "ddnm_attention")
        else:
            _build.check(lib.ddnm_attention_kv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, Tk, C,
                float(scale), _DTYPE_CODE[dtype], int(plan["whole"]), plan["smem"],
                _build.raw_stream(dev)), "ddnm_attention_kv")
    if Tk == T:
        _build.count_launch(LAUNCHES, "attention")
    else:
        _build.count_launch(SPATIAL_LAUNCHES, "attention_gathered")
    return out


def fused_attention(q, k, v, scale: float, *, force: str | None = None):
    """softmax(q k^T * scale) v over (B*, Tq, C) queries and (B*, Tk, C)
    keys and values; fp32 softmax.

    `force`: None (the kernel for a CUDA tensor, the plain version for a CPU
    tensor), "kernel", "torch" or "op": the ddnm::attention custom op
    (ops/library.py), whose CUDA implementation is the kernel and whose
    CPU implementation the plain version. Traced code (torch.export)
    takes the op under None and "kernel"."""
    mode = force or ("kernel" if q.is_cuda else "torch")
    if mode == "op" or (mode == "kernel" or force is None) and _build.tracing(q):
        return torch.ops.ddnm.attention(q, k, v, scale)
    if mode == "torch":
        return _torch_attention(q, k, v, scale)
    if mode == "kernel":
        return _kernel_attention(q, k, v, scale)
    raise ValueError(f"force must be None, 'kernel', 'torch' or 'op', got {force!r}")


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


def _bwd_stream_rows(C: int, dkdv: bool) -> int:
    """bwd_stream_rows() in csrc/attention.cu: rows of a streamed tile of a
    bf16 backward kernel (the dq kernel's keys, the dkdv kernel's queries)."""
    return 32 if dkdv and C > 64 else 64


def _bwd_mma_smem(C: int, dkdv: bool) -> int:
    """bwd_layout().total in csrc/attention.cu: the ring of streamed tiles
    (an X and a Y tile a stage; TMA: 1024 bytes of alignment slack), its
    mbarriers, two arrays of resident padded rows, the fp32 row statistics."""
    rows, tma, row = _bwd_stream_rows(C, dkdv), C % 64 == 0, C + _ROW_PAD
    tile = rows * (C if tma else row) * 2
    stats = 2 * _STAGES * rows if dkdv else _BWD_ROWS
    return ((1024 if tma else 0) + _STAGES * 2 * tile + 8 * _STAGES + 2 * _BWD_ROWS * row * 2
            + 4 * stats)


@functools.lru_cache(maxsize=256)
def _bwd_plan(B: int, T: int, C: int, dtype: torch.dtype, Tk: int | None = None) -> dict:
    """The two backward kernels' launches for (B, T, C) queries against (B,
    Tk, C) keys and values (Tk = T by default) in `dtype`: kernel, threads,
    and each kernel's grid (dq by the queries, dkdv by the keys) and
    dynamic shared-memory bytes (fp32: rows padded to C + 1 floats, the
    kernels' bwd_*_smem_floats; bf16: `_bwd_mma_smem`, with the rows of its
    streamed tiles and whether they come by TMA). Raises ValueError for a
    shape they do not take."""
    Tk = T if Tk is None else Tk
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"attention backward takes float32/bfloat16, got {dtype}")
    dims = BWD_HEAD_DIMS if dtype == torch.float32 else BWD_BF16_HEAD_DIMS
    if C not in dims:
        raise ValueError(f"attention backward takes C in {dims} for {dtype}, got {C}")
    if B < 1 or B > 65535:  # CUDA grid y limit
        raise ValueError(f"attention backward takes 1 <= B* <= 65535, got {B}")
    if T < 1 or Tk < 1:
        raise ValueError(f"attention backward takes T >= 1, got {T} queries and {Tk} keys")
    if dtype == torch.bfloat16:
        return {"kernel": "mma", "threads": _BWD_MMA_THREADS, "tma": C % 64 == 0,
                **{name: {"grid": (-(-rows // _BWD_ROWS), B), "smem": _bwd_mma_smem(C, dkdv),
                          "stream_rows": _bwd_stream_rows(C, dkdv)}
                   for name, dkdv, rows in (("dq", False, T), ("dkdv", True, Tk))}}
    rows, tile = _fp32_bwd_tiles(C)
    dq = 4 * ((2 * rows + 2 * tile) * (C + 1) + rows * (tile + 1) + rows)
    dkdv = 4 * ((2 * rows + 2 * tile) * (C + 1) + 2 * rows * (tile + 1) + 2 * tile)
    return {"kernel": "fma", "threads": 8 * rows,
            "dq": {"grid": (-(-T // rows), B), "smem": dq},
            "dkdv": {"grid": (-(-Tk // rows), B), "smem": dkdv}}


def _check_bwd(queries, keys):
    """The backward plan and the tensors: `queries` (name, tensor) of q's
    shape (B, Tq, C) and `keys` of k's (B, Tk, C), all of one dtype and
    device and contiguous; each copied where the bf16 kernels' 16-byte
    copies need it (`_aligned`)."""
    q, k = queries[0][1], keys[0][1]
    shape, dtype, dev = q.shape, q.dtype, q.device
    if not q.is_cuda:
        raise ValueError("the attention backward kernels take CUDA tensors only")
    if len(shape) != 3 or k.ndim != 3 or (k.shape[0], k.shape[2]) != (shape[0], shape[2]):
        raise ValueError(f"attention backward takes q (B, Tq, C) and k (B, Tk, C), got "
                         f"{tuple(shape)}, {tuple(k.shape)}")
    for group, ref in ((queries, "q"), (keys, "k")):
        want = shape if ref == "q" else k.shape
        for name, t in group:
            if t.shape != want or t.dtype != dtype or t.device != dev or not t.is_contiguous():
                raise ValueError(f"attention backward: {name} must be a contiguous tensor of "
                                 f"{ref}'s shape {tuple(want)}, q's dtype and device")
    plan = _bwd_plan(*shape, dtype, k.shape[1])
    tensors = [t for _, t in queries + keys]
    if plan["kernel"] == "mma":
        tensors = [_aligned(t) for t in tensors]
    return plan, tensors


def _attn_bwd_dq(q, k, v, o, do, scale):
    """(dq, lse, dsum): one launch of the dq kernel; lse and dsum are the
    (B, Tq) fp32 rows the dkdv kernel reads."""
    plan, (q, o, do, k, v) = _check_bwd((("q", q), ("o", o), ("do", do)), (("k", k), ("v", v)))
    B, T, C = q.shape
    Tk = k.shape[1]
    lib = _build.load_library()
    dq = torch.empty_like(q)
    rows = q.new_empty((2, B, T), dtype=torch.float32)
    dev = q.device
    with _build.device_guard(dev):
        if Tk == T:
            _build.check(lib.ddnm_attention_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                dq.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(), B, T, C, float(scale),
                _DTYPE_CODE[q.dtype], plan["dq"]["smem"], _build.raw_stream(dev)),
                "ddnm_attention_bwd_dq")
        else:
            _build.check(lib.ddnm_attention_bwd_dq_kv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                dq.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(), B, T, Tk, C,
                float(scale), _DTYPE_CODE[q.dtype], plan["dq"]["smem"], _build.raw_stream(dev)),
                "ddnm_attention_bwd_dq_kv")
    if Tk == T:
        _build.count_launch(LAUNCHES, "attn_bwd_dq")
    else:
        _build.count_launch(SPATIAL_LAUNCHES, "attn_bwd_dq_gathered")
    return dq, rows[0], rows[1]


def _attn_bwd_dkdv(q, k, v, do, lse, dsum, scale):
    """(dk, dv): one launch of the dkdv kernel."""
    plan, (q, do, k, v) = _check_bwd((("q", q), ("do", do)), (("k", k), ("v", v)))
    B, T, C = q.shape
    Tk = k.shape[1]
    for t in (lse, dsum):
        if t.shape != (B, T) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("attention backward: lse and dsum are contiguous (B, Tq) fp32")
    lib = _build.load_library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dev = q.device
    with _build.device_guard(dev):
        if Tk == T:
            _build.check(lib.ddnm_attention_bwd_dkdv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, C, float(scale),
                _DTYPE_CODE[q.dtype], plan["dkdv"]["smem"], _build.raw_stream(dev)),
                "ddnm_attention_bwd_dkdv")
        else:
            _build.check(lib.ddnm_attention_bwd_dkdv_kv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, Tk, C, float(scale),
                _DTYPE_CODE[q.dtype], plan["dkdv"]["smem"], _build.raw_stream(dev)),
                "ddnm_attention_bwd_dkdv_kv")
    if Tk == T:
        _build.count_launch(LAUNCHES, "attn_bwd_dkdv")
    else:
        _build.count_launch(SPATIAL_LAUNCHES, "attn_bwd_dkdv_gathered")
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
