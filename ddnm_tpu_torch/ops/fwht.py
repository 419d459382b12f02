"""Walsh-Hadamard transform along the last axis (port of ddnm_tpu/ops/fwht.py).

For x of shape (..., P), P a power of two, `fwht(x, norm)` is the
natural-order (Sylvester) Hadamard transform H_P x divided by `norm`; with
norm = sqrt(P) it is self-inverse. H_P = H_a (x) H_b for P = a b, so with x
reshaped row-major to (a, b) the transform is H_a X H_b.

On a CUDA tensor `fwht` runs the hand-written butterfly kernel of
`csrc/fwht.cu` in one launch: each CTA holds a tile of 2^S floats in its
threads' registers and shared memory and runs the stages of the index bits
it holds; a slab wider than a tile is split over a thread-block cluster,
whose last log2(K) stages read the peers' shared memory (DSMEM) on the way
out. The launch plan is `_fwht_plan`. On a CPU tensor it runs
`_torch_fwht`, the plain version: the JAX package's default algebra, one
fp32 einsum H_a X H_b, then the division.

`force="torch"` selects the plain version on any device, `force="kernel"`
the kernel (and raises on a CPU tensor). There is no fallback.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ddnm_tpu_torch.ops import _build

__all__ = ["fwht", "hadamard_matrix", "LAUNCHES"]

LAUNCHES = {"fwht": 0}

_MAX_P = 65536  # kMaxP in csrc/fwht.cu
# the kernel's tiles (csrc/fwht.cu): 2^11..2^13 floats a CTA, 64 a thread,
# at most 8 CTAs a cluster (the portable limit)
_TILE_MIN, _TILE_MAX = 11, 13
_FLOATS_PER_THREAD = 64
_MAX_CLUSTER = 8
# CTAs an SM that the plan aims for before it grows the tile
_CTAS_PER_SM = 2


def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix H_n (n a power of two), entries +-1, in the
    natural order of the butterfly."""
    assert n & (n - 1) == 0 and n > 0, "n must be a power of two"
    h = np.array([[1.0]], dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def _factor(p: int) -> tuple[int, int]:
    """p = a*b with a, b powers of two as close as possible (a >= b)."""
    m = p.bit_length() - 1
    a = 1 << ((m + 1) // 2)
    return a, p // a


def _check_length(p: int) -> None:
    if p <= 0 or p & (p - 1):
        raise ValueError(f"fwht takes a power-of-two last axis, got {p}")


@functools.lru_cache(maxsize=None)
def _hadamard_tensor(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hadamard_matrix(n)).to(device)


def _torch_fwht(x: torch.Tensor, norm: float) -> torch.Tensor:
    """The plain version: fp32 einsum H_a X H_b over (N, a, b), / norm."""
    shape = x.shape
    _check_length(shape[-1])
    a, b = _factor(shape[-1])
    ha, hb = _hadamard_tensor(a, x.device), _hadamard_tensor(b, x.device)
    x3 = x.reshape(-1, a, b).to(torch.float32)
    out = torch.einsum("ij,njk,kl->nil", ha, x3, hb)
    return (out / norm).reshape(shape)


@functools.lru_cache(maxsize=256)
def _fwht_plan(n: int, p: int, sms: int = 132) -> dict:
    """The kernel's launch for n slabs of p floats on a card of `sms` SMs.

    A CTA holds a tile of 2^log_tile floats (`threads` x 64): a slab wider
    than a tile is split over a cluster of `cluster` CTAs (p = cluster x
    tile), a narrower one shares a tile (`slabs_per_cta` = tile / p). Of
    the tiles that fit, the plan takes the largest that still gives
    `_CTAS_PER_SM` CTAs an SM, else the one with the most CTAs (the
    smaller tile on a tie). Raises ValueError for what the kernel does not
    take."""
    _check_length(p)
    if p > _MAX_P:
        raise ValueError(f"fwht kernel takes P <= {_MAX_P}, got {p}")
    if not 0 < n < 2**31:
        raise ValueError(f"fwht kernel takes 1 <= n < 2**31 slabs, got {n}")
    m = p.bit_length() - 1
    options = []
    for s in range(_TILE_MIN, _TILE_MAX + 1):
        k = 1 << max(0, m - s)
        if k <= _MAX_CLUSTER:
            options.append((s, k, n * k if k > 1 else -(-n * p >> s)))
    wide = [o for o in options if o[2] >= _CTAS_PER_SM * sms]
    s, k, ctas = wide[-1] if wide else max(options, key=lambda o: (o[2], -o[0]))
    if ctas >= 2**31:
        raise ValueError(f"fwht kernel takes fewer than 2**31 CTAs, got {ctas}")
    return {"log_tile": s, "cluster": k, "slabs_per_cta": max(1, (1 << s) // p),
            "threads": (1 << s) // _FLOATS_PER_THREAD, "floats_per_thread": _FLOATS_PER_THREAD,
            "grid": (ctas,), "smem": 4 << s}


def _kernel_fwht(x: torch.Tensor, norm: float) -> torch.Tensor:
    """The CUDA butterfly. A contiguous fp32 input is read in place; any
    other (another dtype, a strided view) is first copied once into a
    contiguous fp32 tensor. The output is a new contiguous fp32 tensor of
    x's shape."""
    if not x.is_cuda:
        raise ValueError("the fwht kernel takes CUDA tensors only")
    shape = x.shape
    p = shape[-1]
    _check_length(p)
    if p > _MAX_P:
        raise ValueError(f"fwht kernel takes P <= {_MAX_P}, got {p}")
    n = x.numel() // p
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    plan = _fwht_plan(n, p, _build.sm_count(x.device))
    src = x.to(torch.float32).contiguous()
    if src.data_ptr() % 16:  # 16-byte loads
        src = src.clone()
    lib = _build.load_library()
    with _build.device_guard(x.device):
        _build.check(lib.ddnm_fwht(src.data_ptr(), out.data_ptr(), n, p, plan["log_tile"],
                                   plan["cluster"], float(norm),
                                   _build.raw_stream(x.device)), "ddnm_fwht")
    _build.count_launch(LAUNCHES, "fwht")
    return out


def fwht(x: torch.Tensor, norm: float, *, force: str | None = None) -> torch.Tensor:
    """Walsh-Hadamard transform of x (..., P) along the last axis, / norm.

    `force`: None (the kernel for a CUDA tensor, the plain version for a CPU
    tensor), "kernel" or "torch". The result is fp32."""
    mode = force or ("kernel" if x.is_cuda else "torch")
    if mode == "torch":
        return _torch_fwht(x, norm)
    if mode == "kernel":
        return _kernel_fwht(x, norm)
    raise ValueError(f"force must be None, 'kernel' or 'torch', got {force!r}")
