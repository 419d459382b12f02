"""Second-order multistep DDNM solver (port of ddnm_tpu/sampling/solvers.py).

A deterministic DPM-Solver++(2M)-style update in data-prediction form,
applied to the null-space-projected x0|t: the DDNM projection (Eq. 17)
plays the role of the data prediction, so the range-space constraint holds
at every step while the null-space component integrates the
probability-flow ODE at second order. The JAX package measures the regime
split on its trained fixtures: at <= ~10 model calls it beats the
reference's first-order update by several dB, at 25-100 steps the
reference's contractive update scores higher, so "ddim" stays the default.

Math (log-SNR lambda = log(alpha / sigma), alpha = sqrt(abar), sigma =
sqrt(1 - abar); a step t_i -> t_j, h = lambda_j - lambda_i):

    first order   x_j = (sigma_j / sigma_i) x_i + alpha_j (1 - e^{-h}) x0_i
    second order  D   = x0_i + (h / 2 h_prev) (x0_i - x0_prev)
                  x_j = (sigma_j / sigma_i) x_i + alpha_j (1 - e^{-h}) D

e^{-h} is the stable ratio (alpha_i sigma_j) / (alpha_j sigma_i). The
final step (abar_j = 1) and the step after a time-travel jump (which
drops the history) are first order.

Deterministic, so noise-free DDNM only (sigma_y == 0; the posterior form
refuses tables with any lambda_t != 1). Only time-travel steps draw noise:
the simplified form re-noises the last raw x0 prediction, the posterior
form undoes at beta[t + shift], each from the image's (or tile's)
generator; a `threefry.KeyNoise` splits its key at every step, as JAX's
solver splits its carried key. The posterior form's guidance is applied in eps space, the JAX
package's stated divergence from the stochastic posterior sampler.

The step coefficients are computed on the device in fp32 for every step
before the loop (the JAX package passes Python floats into a float32 jit;
a float64 host computation would drift from it at the 1e-6 level); which
steps are second order is known from the static schedule, so the loop
never waits for the card. `loop` picks the driver as in sampling/ddnm.py:
"host" is the eager loop, "scan" ("auto") one CUDA graph of it
(`_run_scan_ms`, `_run_scan_pms`; JAX's names), eagerly on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ddnm_tpu_torch.sampling import graphs
from ddnm_tpu_torch.sampling.ddnm import (
    DDNMSchedule,
    _nhwc_to_vec,
    _resolve_loop,
    _step_scalars,
    _travel_step,
    _vec_to_nhwc,
)
from ddnm_tpu_torch.sampling.posterior import (
    PosteriorTables,
    _check_sampler_args,
    _DeviceTables,
    _resolve_posterior_loop,
    _x0_hat,
)
from ddnm_tpu_torch.sampling.rng import NoiseFn, default_noise, draw_noise, skip_noise

__all__ = [
    "sample_simplified_multistep",
    "sample_svd_multistep",
    "sample_posterior_multistep",
]

_TINY = 1e-20  # clamp of 1 - abar at the abar = 1 endpoint


def _lam(abar: torch.Tensor) -> torch.Tensor:
    """log-SNR lambda = 0.5 (log abar - log(1 - abar)), endpoint-clamped."""
    return 0.5 * (torch.log(abar) - torch.log(torch.clamp(1.0 - abar, min=_TINY)))


class _Coefs:
    """Every normal step's update coefficients, fp32 on the device, and which
    steps are second order (host booleans).

    `abar_i`, `abar_j`: (S,) float32 numpy; `is_travel`: (S,) bool. A step
    is second order when the step before it was a normal step (no travel
    in between: a jump drops the history) and it does not land on
    abar_j >= 1 (the final step)."""

    def __init__(self, abar_i: np.ndarray, abar_j: np.ndarray, is_travel: np.ndarray, device):
        travel = np.asarray(is_travel, bool)
        # travel rows get a harmless 0.5 (their coefficients are never read)
        ai = torch.as_tensor(np.where(travel, 0.5, abar_i).astype(np.float32), device=device)
        aj = torch.as_tensor(np.where(travel, 0.5, abar_j).astype(np.float32), device=device)
        a_i, a_j = torch.sqrt(ai), torch.sqrt(aj)
        s_i = torch.sqrt(torch.clamp(1.0 - ai, min=_TINY))
        s_j = torch.sqrt(torch.clamp(1.0 - aj, min=_TINY))
        lam_i = _lam(ai)
        h = _lam(aj) - lam_i
        e_mh = (a_i * s_j) / (a_j * s_i)  # exp(-h), stable ratio form
        self.ratio = s_j / s_i
        self.coef = a_j * (1.0 - e_mh)
        lam_prev = torch.cat([lam_i[:1], lam_i[:-1]])
        self.c = h / (2.0 * torch.clamp(lam_i - lam_prev, min=1e-8))
        self.second_order = [second for _, second in self.kinds(travel, abar_j)]

    @staticmethod
    def kinds(is_travel, abar_j) -> list:
        """Each step's kind for a warm-up: travel, first or second order."""
        travel = np.asarray(is_travel, bool)
        is_last = np.asarray(abar_j, np.float32) >= np.float32(1.0 - 1e-8)
        prev_normal = np.concatenate([[False], ~travel[:-1]])
        return list(zip(travel.tolist(), (prev_normal & ~travel & ~is_last).tolist()))

    def step(self, k: int, x, x0_hat, x0_prev):
        """x_j from x_i, the projected prediction and the history."""
        d = (x0_hat + self.c[k] * (x0_hat - x0_prev)) if self.second_order[k] else x0_hat
        return self.ratio[k] * x + self.coef[k] * d


# ------------------------------------------------------------ predict bodies
# Each returns (x0_raw, x0_hat): the unprojected Eq. 12 prediction (carried
# for time-travel re-noising) and the null-space-projected prediction the
# ODE integrates.


def _simplified_predict(model_fn, operator, x, t_f, at, y, op_ctx=None):
    et = model_fn(x, t_f)
    et = et[..., :3] if et.shape[-1] == 6 else et
    x0_t = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
    # Eq. 17 at sigma_y = 0: lambda_t = 1, the full projection
    proj = (operator.Ap_ctx(operator.A_ctx(x0_t, op_ctx) - y, op_ctx)
            if op_ctx is not None
            else operator.Ap(operator.A(x0_t) - y))
    return x0_t, x0_t - proj


def _svd_predict(model_fn, operator, guidance_fn, x, t_f, at, y_spec):
    et = model_fn(x, t_f)
    et = et[..., :3] if et.shape[-1] == 6 else et
    if guidance_fn is not None:
        et = et - torch.sqrt(1.0 - at) * guidance_fn(x, t_f, at)
    x0_t = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
    x0_vec = _nhwc_to_vec(x0_t)
    x0_hat = x0_vec - operator.range_correction(x0_vec, y_spec)
    return x0_t, _vec_to_nhwc(x0_hat, x.shape)


def _drive_ddnm(loop, parts, predict, x_init, inputs, sched: DDNMSchedule, gens, noise_fn):
    """The multistep loop over a DDNM schedule: `predict(x, t_f[B], at,
    *inputs) -> (x0_raw, x0_hat)`; a travel step re-noises the last x0_raw
    with noise from `gens`. Returns (x_final, x0_raw_final), through the
    driver `loop` resolves to."""
    abar = np.asarray(sched.alpha_bar, np.float32)
    abar_i = abar[np.asarray(sched.t_cur, np.int64) + 1]
    abar_j = abar[np.asarray(sched.t_next, np.int64) + 1]
    travel = sched.is_travel.tolist()

    def make_body():
        dev = x_init.device
        co = _Coefs(abar_i, abar_j, sched.is_travel, dev)
        t_f_all, at_all, at_next_all = _step_scalars(sched, dev)

        def body(x_init, *inputs, noise, steps=None):
            n = x_init.shape[0]
            x, x0_raw = x_init, torch.zeros_like(x_init)
            x0_prev = torch.zeros_like(x_init)
            for k in range(len(travel)) if steps is None else steps:
                if travel[k]:
                    eps = draw_noise(noise_fn, noise, x.shape, x_init.device)
                    x = _travel_step(x0_raw, at_next_all[k], eps)
                else:
                    skip_noise(noise)
                    x0_raw, x0_hat = predict(x, t_f_all[k].expand(n), at_all[k], *inputs)
                    x = co.step(k, x, x0_hat, x0_prev)
                    x0_prev = x0_hat
            return x, x0_raw

        return body

    if _resolve_loop(loop) == "scan":
        return _run_scan_ms(parts, make_body, (x_init, *inputs), gens,
                            _Coefs.kinds(sched.is_travel, abar_j))
    return make_body()(x_init, *inputs, noise=gens)


def _run_scan_ms(parts, make_body, inputs, gens, kinds):
    """The multistep scan driver over a DDNM schedule (JAX `_run_scan_ms`):
    one CUDA graph (sampling/graphs.py)."""
    return graphs.run(parts, make_body, inputs, gens, kinds)


@torch.no_grad()
def sample_simplified_multistep(
    model_fn,
    x_init: torch.Tensor,
    y: torch.Tensor,
    operator,
    sched: DDNMSchedule,
    gens: Sequence[torch.Generator],
    *,
    noise_fn: NoiseFn = default_noise,
    op_ctx=None,
    loop: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Simplified-mode noise-free DDNM with the second-order multistep
    update. Deterministic (no eta: only time-travel steps draw noise).
    Returns (x_final, x0_pred_final) like sample_simplified; `loop` as
    there."""
    _check_sampler_args(operator, None, None, op_ctx)

    def predict(x, t_f, at, y, op_ctx):
        return _simplified_predict(model_fn, operator, x, t_f, at, y, op_ctx)

    parts = ("simplified_multistep", model_fn, operator, sched, noise_fn)
    return _drive_ddnm(loop, parts, predict, x_init, (y, op_ctx), sched, gens, noise_fn)


@torch.no_grad()
def sample_svd_multistep(
    model_fn,
    x_init: torch.Tensor,
    y: torch.Tensor,
    operator,
    sched: DDNMSchedule,
    gens: Sequence[torch.Generator],
    *,
    noise_fn: NoiseFn = default_noise,
    guidance_fn: Optional[Callable] = None,
    loop: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """SVD-mode noise-free DDNM with the second-order multistep update. `y`
    is the measurement in the operator's flattened layout (B, M); classifier
    guidance composes as in sample_svd; `loop` as in sample_svd."""
    y_spec = operator.prepare_measurement(y)

    def predict(x, t_f, at, y_spec):
        return _svd_predict(model_fn, operator, guidance_fn, x, t_f, at, y_spec)

    parts = ("svd_multistep", model_fn, operator, sched, noise_fn, guidance_fn)
    return _drive_ddnm(loop, parts, predict, x_init, (y_spec,), sched, gens, noise_fn)


# ------------------------------------------- posterior (hq) multistep form


def _posterior_predict(model_fn, operator, guidance_fn, clip_denoised, x, apy,
                       paste_mask, paste_content, t_b, s):
    """The posterior data prediction: the DDNM core up to and including the
    Mask-Shift paste, without the stochastic posterior transition. The
    learned-range variance head is unused (the ODE injects no noise).
    Guidance is applied in eps space (the score correction), as the JAX
    package does here, where the stochastic sampler shifts the mean;
    sqrt(1 - abar) = sqrt_recipm1 / sqrt_recip."""
    out = model_fn(x, t_b)
    eps = out[..., :x.shape[-1]]
    if guidance_fn is not None:
        eps = eps - (s["sqrt_recipm1"] / s["sqrt_recip"]) * guidance_fn(x, t_b)
    return _x0_hat(operator, clip_denoised, x, apy, paste_mask, paste_content, eps, s)


def _posterior_abar(tables: PosteriorTables) -> tuple[np.ndarray, np.ndarray]:
    """(abar, abar_prev) over the respaced grid, float32, from the tables'
    1 / sqrt form (abar_prev[0] = 1: the final step lands on clean data)."""
    abar = 1.0 / (np.asarray(tables.sqrt_recip_alphas_cumprod, np.float32) ** 2)
    return abar, np.concatenate([np.ones(1, np.float32), abar[:-1]])


@torch.no_grad()
def sample_posterior_multistep(
    model_fn,
    x_init: torch.Tensor,
    apy: torch.Tensor,
    operator,
    tables: PosteriorTables,
    gens: Sequence[torch.Generator],
    *,
    paste_mask: Optional[torch.Tensor] = None,
    paste_content: Optional[torch.Tensor] = None,
    guidance_fn: Optional[Callable] = None,
    clip_denoised: bool = True,
    noise_fn: NoiseFn = default_noise,
    op_ctx: Optional[torch.Tensor] = None,
    loop: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior-regime (hq / Mask-Shift) DDNM with the second-order
    multistep update: sample_posterior's arguments (paste masks, op_ctx,
    one generator per image or tile, `loop`), deterministic between undo
    jumps.

    Noise-free DDNM only: the tables must be built with sigma_y == 0 (every
    lambda_t == 1). Returns (x_final, x0_hat_final) like sample_posterior."""
    if not np.all(np.asarray(tables.lambda_t) == 1.0):
        raise ValueError(
            "solver='multistep' supports noise-free posterior DDNM only "
            "(sigma_y == 0); rebuild the tables with sigma_y=0 or use the "
            "ddim posterior sampler for noisy measurements")
    _check_sampler_args(operator, paste_mask, paste_content, op_ctx)
    t_cur = np.asarray(tables.t_cur, np.int64)
    abar, abar_prev = _posterior_abar(tables)
    travel = tables.is_travel.tolist()

    def make_body():
        dev = x_init.device
        tb = _DeviceTables(tables, dev)
        co = _Coefs(abar[t_cur], abar_prev[t_cur], tables.is_travel, dev)

        def body(x_init, apy, paste_mask, paste_content, op_ctx, *, noise, steps=None):
            n = x_init.shape[0]
            x, x0_hat = x_init, torch.zeros_like(x_init)
            x0_prev = torch.zeros_like(x_init)
            for k in range(len(travel)) if steps is None else steps:
                t = int(t_cur[k])
                if travel[k]:
                    # an undo re-noises and drops the multistep history
                    eps = draw_noise(noise_fn, noise, x.shape, x_init.device)
                    keep, scale = tb.undo(t)
                    x = keep * x + scale * eps
                else:
                    skip_noise(noise)
                    x0_hat = _posterior_predict(model_fn, operator, guidance_fn, clip_denoised,
                                                x, apy, paste_mask, paste_content,
                                                tb.t_orig[t].expand(n), tb.step(t, op_ctx))
                    x = co.step(k, x, x0_hat, x0_prev)
                    x0_prev = x0_hat
            return x, x0_hat

        return body

    inputs = (x_init, apy, paste_mask, paste_content, op_ctx)
    if _resolve_posterior_loop(loop) == "scan":
        parts = ("posterior_multistep", model_fn, operator, tables, guidance_fn,
                 clip_denoised, noise_fn)
        return _run_scan_pms(parts, make_body, inputs, gens,
                             _Coefs.kinds(tables.is_travel, abar_prev[t_cur]))
    return make_body()(*inputs, noise=gens)


def _run_scan_pms(parts, make_body, inputs, gens, kinds):
    """The posterior multistep scan driver (JAX `_run_scan_pms`): one CUDA
    graph (sampling/graphs.py)."""
    return graphs.run(parts, make_body, inputs, gens, kinds)
