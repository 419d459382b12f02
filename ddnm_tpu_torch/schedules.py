"""Diffusion noise schedules and time-travel jump schedules (host NumPy).

Port of `ddnm_tpu/schedules.py` for the simplified path: beta schedules,
the padded alpha-bar table ("t = -1 maps to alpha_bar = 1"), the RePaint
jump schedule and its conversion into per-step diffusion timesteps. Pure
NumPy, bit-equal to the JAX package's versions.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "get_beta_schedule",
    "alpha_bar_table",
    "get_schedule_jump",
    "check_times",
    "TimePairs",
    "build_time_pairs",
]


def get_beta_schedule(
    beta_schedule: str,
    *,
    beta_start: float,
    beta_end: float,
    num_diffusion_timesteps: int,
) -> np.ndarray:
    """Beta array in float64, one of quad/linear/const/jsd/sigmoid."""
    n = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, n, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, n, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(n, dtype=np.float64)
    elif beta_schedule == "jsd":
        betas = 1.0 / np.linspace(n, 1, n, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, n)
        betas = 1.0 / (np.exp(-x) + 1.0) * (beta_end - beta_start) + beta_start
    else:
        raise NotImplementedError(beta_schedule)
    return betas


def alpha_bar_table(betas: np.ndarray) -> np.ndarray:
    """Padded cumulative product: entry [t+1] = prod_{s<=t}(1-beta_s), so
    that t = -1 maps to alpha_bar = 1 exactly."""
    return np.concatenate([[1.0], np.cumprod(1.0 - betas)])


def get_schedule_jump(
    t_sampling: int, travel_length: int, travel_repeat: int
) -> list[int]:
    """RePaint time-travel schedule: descend one step at a time; every
    `travel_length` steps re-ascend `travel_length` steps, `travel_repeat - 1`
    times. Returns a +/-1-step list of sampling-time indices ending at -1."""
    jumps = {}
    for j in range(0, t_sampling - travel_length, travel_length):
        jumps[j] = travel_repeat - 1

    t = t_sampling
    ts = []
    while t >= 1:
        t = t - 1
        ts.append(t)
        if jumps.get(t, 0) > 0:
            jumps[t] = jumps[t] - 1
            for _ in range(travel_length):
                t = t + 1
                ts.append(t)
    ts.append(-1)
    check_times(ts, -1, t_sampling)
    return ts


def check_times(times: Sequence[int], t_0: int, t_max: int) -> None:
    """Validate a jump schedule: starts descending, ends at -1, unit steps,
    values within [t_0, t_max]. Raises ValueError otherwise."""
    if len(times) < 2 or not times[0] > times[1]:
        raise ValueError(f"schedule must start descending: {list(times[:2])}")
    if times[-1] != -1:
        raise ValueError(f"schedule must end at -1, got {times[-1]}")
    for t_last, t_cur in zip(times[:-1], times[1:]):
        if abs(t_last - t_cur) != 1:
            raise ValueError(f"non-unit schedule step {t_last} -> {t_cur}")
    for t in times:
        if not t_0 <= t <= t_max:
            raise ValueError(f"schedule value {t} outside [{t_0}, {t_max}]")


@dataclasses.dataclass(frozen=True)
class TimePairs:
    """Per-step arrays of the sampling loop, all of shape (num_steps,).

    `t_cur`/`t_next` are diffusion-space timesteps (already multiplied by
    `skip`, the final step clamped to -1); `is_travel` marks re-noising
    steps (t_next > t_cur)."""

    t_cur: np.ndarray  # int32
    t_next: np.ndarray  # int32
    is_travel: np.ndarray  # bool

    @property
    def num_steps(self) -> int:
        return len(self.t_cur)


def build_time_pairs(times: Sequence[int], skip: int) -> TimePairs:
    """Scale sampling-space jump-schedule indices into diffusion timesteps."""
    times = np.asarray(list(times), dtype=np.int64)
    i = times[:-1] * skip
    j = times[1:] * skip
    j = np.where(j < 0, -1, j)
    return TimePairs(
        t_cur=i.astype(np.int32),
        t_next=j.astype(np.int32),
        is_travel=(j > i),
    )
