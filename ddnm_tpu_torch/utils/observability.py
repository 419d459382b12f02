"""Observability: key-value metrics logging and device profiling (port of
ddnm_tpu/utils/observability.py).

`MetricsLogger` keeps the JAX module's API and its JSONL line,
{"ts": <unix time>, **metrics in sorted key order}. `profile(trace_dir)`
wraps `torch.profiler.profile` (CPU activities, and CUDA where a card is
present) and writes a Chrome trace under trace_dir, viewable in Perfetto
or chrome://tracing. `StepTimer` times steps on the host clock and syncs
on the device of the tensor a step hands it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from pathlib import Path
from typing import Optional

import torch

logger = logging.getLogger("ddnm_tpu_torch")

__all__ = ["MetricsLogger", "profile", "StepTimer"]


class MetricsLogger:
    """Accumulate per-step metrics; dump to the log and an optional JSONL
    file. logkv / logkv_mean / dumpkvs as the JAX package's (the
    reference logger's public API, guided_diffusion/logger.py:212-243)."""

    def __init__(self, jsonl_path: Optional[str | Path] = None):
        self._vals: dict = {}
        self._counts: dict = {}
        self._file = None
        if jsonl_path is not None:
            Path(jsonl_path).parent.mkdir(parents=True, exist_ok=True)
            self._file = open(jsonl_path, "a")

    def logkv(self, key: str, val) -> None:
        self._vals[key] = val
        self._counts[key] = 1

    def logkv_mean(self, key: str, val) -> None:
        n = self._counts.get(key, 0)
        old = self._vals.get(key, 0.0)
        self._vals[key] = (old * n + float(val)) / (n + 1)
        self._counts[key] = n + 1

    def dumpkvs(self) -> dict:
        out = {k: self._vals[k] for k in sorted(self._vals)}
        if out:
            logger.info(
                "metrics | %s",
                " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                         for k, v in out.items()),
            )
            if self._file is not None:
                self._file.write(json.dumps({"ts": time.time(), **out}) + "\n")
                self._file.flush()
        self._vals.clear()
        self._counts.clear()
        return out

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


@contextlib.contextmanager
def profile(trace_dir: Optional[str | Path]):
    """torch.profiler over the block; its Chrome trace is written to
    <trace_dir>/trace_<pid>_<ms>.json. Yields the profiler (None, and no-op,
    when trace_dir is None)."""
    if trace_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = out / f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"
    prof.export_chrome_trace(str(path))
    logger.info("profiler trace written to %s", path)


class StepTimer:
    """Wall-clock step timing that waits for the device (images/s, the
    port's throughput number)."""

    def __init__(self):
        self.t0 = None
        self.steps = 0
        self.items = 0
        self.elapsed = 0.0

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self, out, items: int = 0):
        """End a step whose result is `out`: a tensor, or a sequence or dict
        of them (the first is waited for; its device's queue is drained)."""
        first = out
        while isinstance(first, (list, tuple, dict)) and first:
            first = next(iter(first.values())) if isinstance(first, dict) else first[0]
        if torch.is_tensor(first) and first.device.type == "cuda":
            torch.cuda.synchronize(first.device)
        self.elapsed += time.perf_counter() - self.t0
        self.steps += 1
        self.items += items

    def items_per_sec(self) -> float:
        return self.items / self.elapsed if self.elapsed > 0 else 0.0
