"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` is compiled to an object by its own `nvcc` process, all
started together, and one more `nvcc` links the objects into a shared
library with a plain C interface, loaded with ctypes. The library lands in
`ddnm_tpu_torch/_build/` (ignored by git), named by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one loads at once.
The build runs at first use: nothing here runs at import.

PyTorch's `cpp_extension` is deliberately not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C interface seconds.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SMEM_PER_BLOCK", "build", "load_library",
           "check", "device_guard", "ptxas_report", "raw_stream", "sm_count"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# dynamic shared memory one H100 block can take (each kernel's plan stays below it)
SMEM_PER_BLOCK = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (every pointer and the stream are
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int).
_SIGNATURES = {
    "ddnm_gn_stats_affine": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                             _I, _I, _I, _I, _I, _P],
    "ddnm_gn_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ddnm_gn_bwd_reduce": [_P] * 9 + [_I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ddnm_gn_bwd_dx": [_P] * 6 + [_I] * 8 + [_P],
    "ddnm_attention": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P],
    "ddnm_attention_bwd_dq": [_P] * 8 + [_I, _I, _I, _F, _I, _I, _P],
    "ddnm_attention_bwd_dkdv": [_P] * 8 + [_I, _I, _I, _F, _I, _I, _P],
    "ddnm_fwht": [_P, _P, _I, _I, _I, _I, _F, _P],
    "ddnm_fused_gn_conv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
_SMS: dict = {}


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

    Returns (library path, seconds spent in nvcc, compiles and link; 0.0
    when it was built already). Raises with nvcc's output if a step fails."""
    lib = _library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    failed, logs = [], []
    for _, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    objs = [str(obj) for obj, _, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        lib.with_suffix(".log").write_text("".join(logs))  # ptxas -v: registers, spills
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    return lib, time.perf_counter() - t0


def ptxas_report(*names: str) -> list[str]:
    """The `-Xptxas -v` lines (registers, spills, stack, wgmma notes) of the
    kernels whose mangled names contain one of `names`, from the log of the
    current build (empty when the library was built elsewhere)."""
    log = _library_path().with_suffix(".log")
    if not log.exists():
        return []
    out, keep = [], False
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = any(n in line for n in names)
        if keep or ("wgmma" in line and any(n in line for n in names)):
            out.append(line.strip())
    return out


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


def device_guard(device):
    """Make `device` current for a launch: a no-op when it already is (the
    common case, and the cheap one on the host)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device) -> int:
    """The cudaStream_t of PyTorch's current stream on a CUDA `device`, as an
    int (what torch.cuda.current_stream(device).cuda_stream gives, without
    building a Stream object on every launch)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA `device` (cached: the launch plans
    size their grids to the card)."""
    n = _SMS.get(device.index)
    if n is None:
        index = torch.cuda.current_device() if device.index is None else device.index
        n = _SMS[device.index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n
