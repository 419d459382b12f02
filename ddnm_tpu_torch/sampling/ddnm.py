"""DDNM / DDNM+ samplers (port of ddnm_tpu/sampling/ddnm.py).

  - simplified mode (`sample_simplified`): per step, Eq. 12 x0|t from the
    model's epsilon, Eq. 19 lambda_t / gamma_t gating, the Eq. 17 null-space
    projection through the operator's A / A+, then the DDIM update with
    gamma-gated noise;
  - SVD mode (`sample_svd`): noise-free DDNM (exact A+ projection through
    the SVD operator's range_correction) and noisy DDNM+ (Eq. 17 Lambda
    range-space scaling and Eq. 51 spectral noise, via noisy_update).

Time-travel steps re-noise the last x0 prediction (RePaint). The
reference's quirks are kept as the JAX package keeps them: the simplified
path uses sigma_t = sqrt(1 - alpha_bar_next^2) (squared) and compares
against alpha_bar_next * sigma_y, the SVD path sigma_t = sqrt(1 - alpha_bar)
and a = sqrt(alpha_bar_next); the final step lands on t = -1 where
alpha_bar = 1 exactly.

The JAX package's host loop becomes an eager Python loop over the static
schedule. Per-step scalars live on the device from the start, so the loop
never waits for the card and kernels queue ahead.

The multistep solver is a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.operators.base import SVDOperator
from ddnm_tpu_torch.operators.functional import FunctionalOperator
from ddnm_tpu_torch.sampling.rng import NoiseFn, default_noise, draw_noise

__all__ = ["DDNMSchedule", "build_schedule", "sample_simplified", "sample_svd"]

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x_nhwc, t[B]) -> eps
# (x_nhwc, t[B], alpha_bar_t) -> grad log p(y | x), the guidance correction
GuidanceFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DDNMSchedule:
    """Per-run sampling schedule, precomputed on the host."""

    alpha_bar: np.ndarray  # float32 padded table, [t+1] = prod_{s<=t}(1-beta_s)
    t_cur: np.ndarray  # (S,) int32, diffusion-space timestep i
    t_next: np.ndarray  # (S,) int32, diffusion-space timestep j (or -1)
    is_travel: np.ndarray  # (S,) bool

    @property
    def num_steps(self) -> int:
        return len(self.t_cur)


def build_schedule(
    *,
    betas: np.ndarray,
    t_sampling: int,
    travel_length: int = 1,
    travel_repeat: int = 1,
) -> DDNMSchedule:
    """The sampling schedule from betas and the time-travel parameters."""
    num_t = len(betas)
    times = sch.get_schedule_jump(t_sampling, travel_length, travel_repeat)
    pairs = sch.build_time_pairs(times, skip=num_t // t_sampling)
    return DDNMSchedule(
        alpha_bar=sch.alpha_bar_table(betas).astype(np.float32),
        t_cur=pairs.t_cur,
        t_next=pairs.t_next,
        is_travel=pairs.is_travel,
    )


def _travel_step(x0_pred, at_next, noise):
    """RePaint re-noising of the last x0 prediction."""
    return torch.sqrt(at_next) * x0_pred + noise * torch.sqrt(1.0 - at_next)


def _simplified_update(operator, eta, sigma_y, x, y, et, at, at_next, noise,
                       op_ctx=None):
    """The DDNM+ update given the model's eps prediction (Eq. 12 / 19 / 17
    and the gamma-gated DDIM step). `at`, `at_next`: 0-dim fp32 tensors."""
    et = et[..., :3] if et.shape[-1] == 6 else et
    # Eq. 12
    x0_t = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
    # Eq. 19 (the reference uses sigma_t = sqrt(1 - at_next^2))
    sigma_t = torch.sqrt(1.0 - at_next**2)
    keep = sigma_t >= at_next * sigma_y
    lambda_t = torch.where(keep, 1.0, sigma_t / (at_next * sigma_y))
    gamma_t = torch.where(
        keep,
        torch.sqrt(torch.clamp(sigma_t**2 - (at_next * sigma_y) ** 2, min=0.0)),
        0.0,
    )
    # Eq. 17
    proj = (operator.Ap_ctx(operator.A_ctx(x0_t, op_ctx) - y, op_ctx)
            if op_ctx is not None
            else operator.Ap(operator.A(x0_t) - y))
    x0_t_hat = x0_t - lambda_t * proj
    c1 = torch.sqrt(1.0 - at_next) * eta
    c2 = torch.sqrt(1.0 - at_next) * (1.0 - eta**2) ** 0.5
    x_next = torch.sqrt(at_next) * x0_t_hat + gamma_t * (c1 * noise + c2 * et)
    return x_next, x0_t


@torch.no_grad()
def sample_simplified(
    model_fn: ModelFn,
    x_init: torch.Tensor,
    y: torch.Tensor,
    operator: FunctionalOperator,
    sched: DDNMSchedule,
    gens: Sequence[torch.Generator],
    *,
    eta: float = 0.85,
    sigma_y: float = 0.0,
    noise_fn: NoiseFn = default_noise,
    op_ctx=None,
    solver: str = "ddim",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Simplified DDNM+ over NHWC images. Returns (x_final, x0_pred_final).

    `gens`: one torch.Generator per image (sampling/rng.py); every step
    draws `noise_fn(gens, x.shape)`, travel steps included, as the JAX
    sampler does. `sigma_y` is the *scaled* measurement noise (the runner
    doubles the CLI value for the [-1, 1] domain). `op_ctx`: a runtime
    operator context (e.g. a per-image mask) for A_ctx / Ap_ctx."""
    _multistep_not_ported(solver)
    if op_ctx is not None and not operator.has_ctx:
        raise ValueError(
            f"operator {operator.name!r} has no A_ctx/Ap_ctx forms; "
            "op_ctx requires a context-parameterised operator"
        )

    def step(x, t_f, at, at_next, noise):
        et = model_fn(x, t_f)
        return _simplified_update(operator, eta, sigma_y, x, y, et, at, at_next,
                                  noise, op_ctx)

    return _drive(step, x_init, sched, gens, noise_fn)


def _multistep_not_ported(solver: str) -> None:
    if solver == "multistep":
        raise NotImplementedError(
            "solver='multistep' is not ported yet (ROADMAP.md Queue 1, later "
            "slice D: solvers and acceleration)"
        )
    if solver != "ddim":
        raise ValueError(f"unknown solver {solver!r} (ddim | multistep)")


def _drive(step, x_init, sched: DDNMSchedule, gens, noise_fn):
    """The eager loop over the static schedule: every step draws
    `noise_fn(gens, x.shape)`, travel steps included, as the JAX sampler
    does; a travel step re-noises the last x0 prediction, any other runs
    `step(x, t_f[B], at, at_next, noise) -> (x_next, x0_pred)`."""
    dev = x_init.device
    n = x_init.shape[0]
    abar = torch.as_tensor(sched.alpha_bar, dtype=torch.float32, device=dev)
    t_cur = torch.as_tensor(sched.t_cur.astype(np.int64), device=dev)
    t_next = torch.as_tensor(sched.t_next.astype(np.int64), device=dev)
    at_all = abar[t_cur + 1]
    at_next_all = abar[t_next + 1]
    t_f_all = t_cur.float()

    x, x0_pred = x_init, torch.zeros_like(x_init)
    for i, travel in enumerate(sched.is_travel.tolist()):
        noise = draw_noise(noise_fn, gens, x.shape, dev)
        if travel:
            x = _travel_step(x0_pred, at_next_all[i], noise)
        else:
            x, x0_pred = step(x, t_f_all[i].expand(n), at_all[i], at_next_all[i], noise)
    return x, x0_pred


def _nhwc_to_vec(x: torch.Tensor) -> torch.Tensor:
    """NHWC image -> channel-major flattened vector (the operator layout)."""
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def _vec_to_nhwc(v: torch.Tensor, shape: tuple) -> torch.Tensor:
    b, h, w, c = shape
    return v.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _svd_update(operator, eta, sigma_y, guidance_fn, x, y_spec, et, t_f, at,
                at_next, noise):
    """The SVD-mode DDNM / DDNM+ update given the model's eps prediction.
    `y_spec` is operator.prepare_measurement(y); `at`, `at_next`: 0-dim fp32
    tensors; `sigma_y`, `eta`: Python floats."""
    et = et[..., :3] if et.shape[-1] == 6 else et
    if guidance_fn is not None:
        et = et - torch.sqrt(1.0 - at) * guidance_fn(x, t_f, at)
    x0_t = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)

    x0_vec = _nhwc_to_vec(x0_t)
    if sigma_y == 0.0:
        # noise-free DDNM: exact range-space correction, then DDIM
        x0_hat = x0_vec - operator.range_correction(x0_vec, y_spec)
        c1 = torch.sqrt(1.0 - at_next) * eta
        c2 = torch.sqrt(1.0 - at_next) * (1.0 - eta**2) ** 0.5
        x_next = (torch.sqrt(at_next) * _vec_to_nhwc(x0_hat, x.shape)
                  + c1 * noise + c2 * et)
    else:
        # DDNM+: Eq. 17 via Lambda, Eq. 51 via Lambda_noise
        a = torch.sqrt(at_next)
        sigma_t = torch.sqrt(1.0 - at_next)
        lam_corr, spectral_noise = operator.noisy_update(
            x0_vec, y_spec, a, sigma_y, sigma_t, eta,
            _nhwc_to_vec(noise), _nhwc_to_vec(et))
        x0_hat = x0_vec - lam_corr
        x_next = (torch.sqrt(at_next) * _vec_to_nhwc(x0_hat, x.shape)
                  + _vec_to_nhwc(spectral_noise, x.shape))
    return x_next, x0_t


@torch.no_grad()
def sample_svd(
    model_fn: ModelFn,
    x_init: torch.Tensor,
    y: torch.Tensor,
    operator: SVDOperator,
    sched: DDNMSchedule,
    gens: Sequence[torch.Generator],
    *,
    eta: float = 0.85,
    sigma_y: float = 0.0,
    noise_fn: NoiseFn = default_noise,
    guidance_fn: GuidanceFn | None = None,
    solver: str = "ddim",
) -> tuple[torch.Tensor, torch.Tensor]:
    """SVD-mode DDNM (sigma_y == 0) / DDNM+ (sigma_y > 0) over NHWC images.
    Returns (x_final, x0_pred_final).

    `y` is the measurement in the operator's flattened layout (B, M); its
    per-image constant `operator.prepare_measurement(y)` is computed once,
    before the loop. `guidance_fn(x, t, at) -> grad log p(y|x)` applies
    classifier guidance as et <- et - sqrt(1 - at) * g, conditioned on the
    current state as the JAX package does. `gens`, `noise_fn`: as in
    sample_simplified."""
    _multistep_not_ported(solver)
    y_spec = operator.prepare_measurement(y)

    def step(x, t_f, at, at_next, noise):
        et = model_fn(x, t_f)
        return _svd_update(operator, eta, sigma_y, guidance_fn, x, y_spec, et,
                           t_f, at, at_next, noise)

    return _drive(step, x_init, sched, gens, noise_fn)
