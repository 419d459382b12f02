"""Diffusion noise schedules and time-travel jump schedules (host NumPy).

Port of `ddnm_tpu/schedules.py`: beta schedules (the main path's and the
hq pipeline's named ADM ones), the padded alpha-bar table ("t = -1 maps to
alpha_bar = 1"), the RePaint jump schedule and its conversion into per-step
diffusion timesteps, the hq pipeline's three-level jump schedule and the
respacing subsets. Pure NumPy, bit-equal to the JAX package's versions.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "get_beta_schedule",
    "named_beta_schedule",
    "alpha_bar_table",
    "get_schedule_jump",
    "get_schedule_jump_hq",
    "space_timesteps",
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


def named_beta_schedule(
    name: str, num_diffusion_timesteps: int, use_scale: bool = True
) -> np.ndarray:
    """The ADM family's named schedules ('linear', 'cosine') of the hq
    pipeline; use_scale=True scales the linear endpoints by 1000/T."""
    if name == "linear":
        scale = (1000 / num_diffusion_timesteps) if use_scale else 1.0
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if name == "cosine":
        def f(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        steps = np.arange(num_diffusion_timesteps + 1) / num_diffusion_timesteps
        alpha_bar = f(steps)
        betas = np.minimum(1 - alpha_bar[1:] / alpha_bar[:-1], 0.999)
        return betas.astype(np.float64)
    raise NotImplementedError(name)


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


def get_schedule_jump_hq(
    t_T: int,
    n_sample: int = 1,
    jump_length: int = 10,
    jump_n_sample: int = 10,
    jump2_length: int = 1,
    jump2_n_sample: int = 1,
    jump3_length: int = 1,
    jump3_n_sample: int = 1,
    start_resampling: int = 100_000_000,
) -> list[int]:
    """The hq pipeline's three-level RePaint jump schedule: nested jump
    bookkeeping at three granularities plus repeated sampling below
    `start_resampling`."""
    def fresh(length, n):
        return {j: n - 1 for j in range(0, t_T - length, length)}

    jumps = fresh(jump_length, jump_n_sample)
    jumps2 = fresh(jump2_length, jump2_n_sample)
    jumps3 = fresh(jump3_length, jump3_n_sample)

    t = t_T
    ts = []
    while t >= 1:
        t = t - 1
        ts.append(t)

        if t + 1 < t_T - 1 and t <= start_resampling:
            for _ in range(n_sample - 1):
                t = t + 1
                ts.append(t)
                if t >= 0:
                    t = t - 1
                    ts.append(t)

        if jumps3.get(t, 0) > 0 and t <= start_resampling - jump3_length:
            jumps3[t] = jumps3[t] - 1
            for _ in range(jump3_length):
                t = t + 1
                ts.append(t)

        if jumps2.get(t, 0) > 0 and t <= start_resampling - jump2_length:
            jumps2[t] = jumps2[t] - 1
            for _ in range(jump2_length):
                t = t + 1
                ts.append(t)
            jumps3 = fresh(jump3_length, jump3_n_sample)

        if jumps.get(t, 0) > 0 and t <= start_resampling - jump_length:
            jumps[t] = jumps[t] - 1
            for _ in range(jump_length):
                t = t + 1
                ts.append(t)
            jumps2 = fresh(jump2_length, jump2_n_sample)
            jumps3 = fresh(jump3_length, jump3_n_sample)

    ts.append(-1)
    check_times(ts, -1, t_T)
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


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """The retained subset of the original timesteps for respaced sampling:
    "ddimN" (a fixed integer stride) or per-section step counts
    ("250", "10,20", [100]). A single count above `num_timesteps` keeps the
    integral points of linspace(0, num_timesteps, count) below it."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride"
            )
        section_counts = [int(x) for x in section_counts.split(",")]
    if len(section_counts) == 1 and section_counts[0] > num_timesteps:
        lin = np.linspace(start=0, stop=num_timesteps, num=section_counts[0])
        return {int(v) for v in lin if v == int(v) and v < num_timesteps}
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)
