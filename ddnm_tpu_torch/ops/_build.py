"""Build and load the port's CUDA kernels.

All `csrc/*.cu` are compiled by one `nvcc` call into a shared library with
a plain C interface, loaded with ctypes. The library lands in
`ddnm_tpu_torch/_build/` (ignored by git), named by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads at once.
The build runs at first use: nothing here runs at import.

PyTorch's `cpp_extension` is deliberately not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C interface seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load_library", "check"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (every pointer and the stream are
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int).
_SIGNATURES = {
    "ddnm_gn_stats": [_P, _P, _I, _I, _I, _I, _I, _P],
    "ddnm_gn_finalize": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "ddnm_gn_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ddnm_attention": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "ddnm_fwht": [_P, _P, _I, _I, _F, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libddnm_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, seconds spent in nvcc; 0.0 when it was built
    already). Raises with nvcc's output if the compile fails."""
    lib = _library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ddnm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ddnm_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = _lib.ddnm_cuda_error_string(rc).decode() if _lib else "?"
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
