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

Two loop drivers run one trajectory body, as in the JAX package (`loop`):
"host" (`_run_host`) is an eager Python loop over the static schedule,
whose per-step scalars live on the device from the start, so the loop
never waits for the card and kernels queue ahead; "scan" (`_run_scan`)
makes the same body, unrolled over the schedule, one CUDA graph that is
captured once per key and replayed (sampling/graphs.py; eagerly on the
CPU). "auto", the default, resolves as JAX's `_resolve_loop` does on a
local backend: to "scan" (`_resolve_loop`). Both drivers draw the same
noise in the same order, and leave the caller's generators or key in the
same state.

`solver="multistep"` runs the second-order deterministic solver of
sampling/solvers.py (noise-free only: sigma_y != 0 raises ValueError, as
in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.operators.base import SVDOperator
from ddnm_tpu_torch.operators.functional import FunctionalOperator
from ddnm_tpu_torch.sampling import graphs
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
    loop: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Simplified DDNM+ over NHWC images. Returns (x_final, x0_pred_final).

    `gens`: one torch.Generator per image (sampling/rng.py); every step
    draws `noise_fn(gens, x.shape)`, travel steps included, as the JAX
    sampler does. A `threefry.KeyNoise` in their place draws JAX's own
    noise from a JAX key, split before every step as the JAX scan splits
    it (serving.py's trajectories). `sigma_y` is the *scaled* measurement noise (the runner
    doubles the CLI value for the [-1, 1] domain). `op_ctx`: a runtime
    operator context (e.g. a per-image mask) for A_ctx / Ap_ctx.

    `solver`: "ddim" (the reference's first-order update) or "multistep"
    (second-order, deterministic, noise-free only; `eta` is ignored;
    sampling/solvers.py). `loop`: "auto" | "host" | "scan" (module
    docstring; another value raises ValueError)."""
    if solver == "multistep":
        from ddnm_tpu_torch.sampling.solvers import sample_simplified_multistep

        if sigma_y != 0.0:
            raise ValueError(
                "solver='multistep' is deterministic and supports noise-free DDNM "
                "only (sigma_y == 0); the noisy DDNM+ gamma_t noise injection is "
                "tied to the DDIM kernel")
        return sample_simplified_multistep(model_fn, x_init, y, operator, sched, gens,
                                           noise_fn=noise_fn, op_ctx=op_ctx, loop=loop)
    _check_solver(solver)
    if op_ctx is not None and not operator.has_ctx:
        raise ValueError(
            f"operator {operator.name!r} has no A_ctx/Ap_ctx forms; "
            "op_ctx requires a context-parameterised operator"
        )

    def step(x, t_f, at, at_next, noise, y, op_ctx):
        et = model_fn(x, t_f)
        return _simplified_update(operator, eta, sigma_y, x, y, et, at, at_next,
                                  noise, op_ctx)

    parts = ("simplified", model_fn, operator, sched, eta, sigma_y, noise_fn)
    return _drive(loop, parts, step, x_init, (y, op_ctx), sched, gens, noise_fn)


def _check_solver(solver: str) -> None:
    if solver != "ddim":
        raise ValueError(f"unknown solver {solver!r} (ddim | multistep)")


def _resolve_loop(loop: str) -> str:
    """JAX's `_resolve_loop` on a local backend: "auto" is "scan" (the port
    has no remote-compile backend, so `_AUTO_SCAN_PARAM_BYTES` has no
    counterpart), in a data mesh's shards and a spatial grid's ranks too,
    except on a gloo spatial group on a card, where it is "host" and
    "scan" raises ValueError (sampling/graphs.py `resolve_loop`)."""
    return graphs.resolve_loop(loop)


def _trajectory(step, sched: DDNMSchedule, noise_fn, scalars):
    """The trajectory body both drivers run: every step draws
    `noise_fn(gens, x.shape)` (or the next draw of a KeyNoise), travel
    steps included, as the JAX sampler does; a travel step re-noises the
    last x0 prediction, any other runs `step(x, t_f[B], at, at_next,
    noise, *inputs) -> (x_next, x0_pred)`. `scalars`: `_step_scalars`.
    torch.export unrolls it (serving.py): the schedule's scalars become
    the program's constants."""
    t_f_all, at_all, at_next_all = scalars
    travel = sched.is_travel.tolist()

    def body(x_init, *inputs, noise, steps=None):
        dev = x_init.device
        n = x_init.shape[0]
        x, x0_pred = x_init, torch.zeros_like(x_init)
        for i in range(len(travel)) if steps is None else steps:
            eps = draw_noise(noise_fn, noise, x.shape, dev)
            if travel[i]:
                x = _travel_step(x0_pred, at_next_all[i], eps)
            else:
                x, x0_pred = step(x, t_f_all[i].expand(n), at_all[i], at_next_all[i], eps,
                                  *inputs)
        return x, x0_pred

    return body


def _drive(loop, parts, step, x_init, inputs, sched: DDNMSchedule, gens, noise_fn):
    """The trajectory through the driver `loop` resolves to. `inputs`: the
    step's tensor inputs (None where absent), which the scan driver copies
    into its graph's static buffers; `parts`: what `step` closes over."""
    def make_body():
        return _trajectory(step, sched, noise_fn, _step_scalars(sched, x_init.device))

    if _resolve_loop(loop) == "scan":
        return _run_scan(parts, make_body, x_init, inputs, gens, sched.is_travel)
    return _run_host(make_body(), x_init, inputs, gens)


def _run_host(body, x_init, inputs, gens):
    """The host driver (JAX `_run_host`): the body's eager loop, every
    launch queued from the host step by step."""
    return body(x_init, *inputs, noise=gens)


def _run_scan(parts, make_body, x_init, inputs, gens, kinds):
    """The scan driver (JAX `_run_scan`): the body unrolled into one CUDA
    graph, captured at the first call of its key and replayed
    (sampling/graphs.py); the warm-up runs the first step of each kind."""
    return graphs.run(parts, make_body, (x_init, *inputs), gens, np.asarray(kinds).tolist())


def _step_scalars(sched: DDNMSchedule, device):
    """Every step's device scalars, fp32: (t_i, alpha_bar_i, alpha_bar_j)."""
    abar = torch.as_tensor(sched.alpha_bar, dtype=torch.float32, device=device)
    t_cur = torch.as_tensor(sched.t_cur.astype(np.int64), device=device)
    t_next = torch.as_tensor(sched.t_next.astype(np.int64), device=device)
    return t_cur.float(), abar[t_cur + 1], abar[t_next + 1]


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
    loop: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """SVD-mode DDNM (sigma_y == 0) / DDNM+ (sigma_y > 0) over NHWC images.
    Returns (x_final, x0_pred_final).

    `y` is the measurement in the operator's flattened layout (B, M); its
    per-image constant `operator.prepare_measurement(y)` is computed once,
    before the loop. `guidance_fn(x, t, at) -> grad log p(y|x)` applies
    classifier guidance as et <- et - sqrt(1 - at) * g, conditioned on the
    current state as the JAX package does. `gens`, `noise_fn`, `solver`,
    `loop`: as in sample_simplified."""
    if solver == "multistep":
        from ddnm_tpu_torch.sampling.solvers import sample_svd_multistep

        if sigma_y != 0.0:
            raise ValueError("solver='multistep' is deterministic and supports "
                             "noise-free DDNM only (sigma_y == 0)")
        return sample_svd_multistep(model_fn, x_init, y, operator, sched, gens,
                                    noise_fn=noise_fn, guidance_fn=guidance_fn, loop=loop)
    _check_solver(solver)
    y_spec = operator.prepare_measurement(y)

    def step(x, t_f, at, at_next, noise, y_spec):
        et = model_fn(x, t_f)
        return _svd_update(operator, eta, sigma_y, guidance_fn, x, y_spec, et,
                           t_f, at, at_next, noise)

    parts = ("svd", model_fn, operator, sched, eta, sigma_y, noise_fn, guidance_fn)
    return _drive(loop, parts, step, x_init, (y_spec,), sched, gens, noise_fn)
