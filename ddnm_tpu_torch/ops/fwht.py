"""Walsh-Hadamard transform along the last axis (port of ddnm_tpu/ops/fwht.py).

For x of shape (..., P), P a power of two, `fwht(x, norm)` is the
natural-order (Sylvester) Hadamard transform H_P x divided by `norm`; with
norm = sqrt(P) it is self-inverse. H_P = H_a (x) H_b for P = a b, so with x
reshaped row-major to (a, b) the transform is H_a X H_b.

On a CUDA tensor `fwht` runs the hand-written butterfly kernel of
`csrc/fwht.cu` (two launches: the log2(b) stages along each row, then the
log2(a) stages along each column, divided by `norm` on the way out). On a
CPU tensor it runs `_torch_fwht`, the plain version: the JAX package's
default algebra, one fp32 einsum H_a X H_b, then the division.

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
    src = x.to(torch.float32).contiguous()
    n = src.numel() // p
    if n > 2**31 - 1:
        raise ValueError(f"fwht kernel takes fewer than 2**31 slabs, got {n}")
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        _build.check(lib.ddnm_fwht(src.data_ptr(), out.data_ptr(), n, p, float(norm),
                                   stream), "ddnm_fwht")
    LAUNCHES["fwht"] += 1
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
