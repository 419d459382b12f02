"""Posterior-based DDNM sampling with respacing and time-travel (port of
ddnm_tpu/sampling/posterior.py), the sampler of the hq pipeline.

An ADM model predicting (eps, var_values) drives a DDPM posterior update
whose mean is recomputed from the DDNM-projected x0_hat and whose variance
is replaced by gamma_t (Eq. 19), with RePaint-style time-travel ("undo"
re-noising at beta[t + time_shift]) and timestep respacing (betas rebuilt
over the retained subset; the model gets the original timestep through
`timestep_map`). The learned variance (channels 3-5) is not used.

lambda_t and gamma_t depend only on the schedule and sigma_y, so they are
tables built on the host (`build_posterior_tables`). The Mask-Shift paste
is a masked blend `paste_mask * paste_content + (1 - paste_mask) * x0_hat`
after the projection and before the posterior mean.

The JAX package drives the loop either as one `lax.scan` (`_run_scan`) or
from the host (`_host_step` / `_host_undo`), chosen by
`_resolve_posterior_loop`, where "auto" always means the scan. So here:
`loop="host"` is one eager Python loop over the static schedule (the
per-step scalars live on the device from the start, so the loop never
waits for the card), `loop="scan"` (what "auto" resolves to) makes the
same body, unrolled, one CUDA graph captured once per key and replayed
(sampling/graphs.py; eagerly on the CPU), the guidance gradient included.
`solver="multistep"` runs the second-order deterministic solver
(sampling/solvers.py `sample_posterior_multistep`, noise-free tables only).
`guidance_fn` is the classifier-guidance hook (models/unet_adm.py
`classifier_guidance_fn`), which takes its gradient under
`torch.enable_grad()` inside this `torch.no_grad()` loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.operators.functional import FunctionalOperator
from ddnm_tpu_torch.sampling import graphs
from ddnm_tpu_torch.sampling.rng import NoiseFn, default_noise, draw_noise

__all__ = [
    "PosteriorTables",
    "respace_betas",
    "build_posterior_tables",
    "build_jump_pairs",
    "n_model_calls",
    "sample_posterior",
]


def respace_betas(betas: np.ndarray, use_timesteps) -> tuple[np.ndarray, np.ndarray]:
    """Betas rebuilt over a retained timestep subset: new_betas[i] gives the
    original alpha_bar at the retained steps; timestep_map maps a sampler
    index to the original timestep (the model's input)."""
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    keep = set(int(t) for t in use_timesteps)
    new_betas, tmap = [], []
    last = 1.0
    for i, ac in enumerate(alphas_cumprod):
        if i in keep:
            new_betas.append(1.0 - ac / last)
            last = ac
            tmap.append(i)
    return np.asarray(new_betas, dtype=np.float64), np.asarray(tmap, dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class PosteriorTables:
    """Per-timestep tables of the posterior sampler, indexed by the
    respaced timestep t (float32 unless said), and the jump schedule."""

    betas: np.ndarray
    timestep_map: np.ndarray  # original timestep fed to the model
    sqrt_recip_alphas_cumprod: np.ndarray  # 1/sqrt(abar)
    sqrt_recipm1_alphas_cumprod: np.ndarray  # sqrt(1/abar - 1)
    posterior_mean_coef1: np.ndarray  # coef on x0
    posterior_mean_coef2: np.ndarray  # coef on x_t
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    log_betas: np.ndarray
    lambda_t: np.ndarray  # Eq. 19 range-space scale
    gamma_t: np.ndarray  # Eq. 19 variance replacement
    t_cur: np.ndarray  # (S,) int32 respaced timestep of each step
    is_travel: np.ndarray  # (S,) bool: re-noise instead of sampling
    travel_shift: np.ndarray  # () int32: the undo uses beta[t + shift]


def build_jump_pairs(schedule_jump_params: dict) -> tuple[np.ndarray, np.ndarray]:
    """The 3-level jump schedule -> (t_cur, is_travel): a DDNM step at
    t_last where the schedule descends, an undo where it ascends."""
    times = sch.get_schedule_jump_hq(**schedule_jump_params)
    t_last = np.asarray(times[:-1], dtype=np.int32)
    t_next = np.asarray(times[1:], dtype=np.int32)
    return t_last, t_next >= t_last


def build_posterior_tables(
    *,
    betas: np.ndarray,
    timestep_respacing,
    sigma_y: float = 0.0,
    schedule_jump_params: Optional[dict] = None,
    time_shift: int = 1,
) -> PosteriorTables:
    """All tables of `sample_posterior`. `betas` is the original schedule,
    `timestep_respacing` a space_timesteps() spec ("ddim100", "250", ...),
    `time_shift` the conf option inpa_inj_time_shift."""
    betas = np.asarray(betas, dtype=np.float64)
    use = sch.space_timesteps(len(betas), timestep_respacing)
    new_betas, tmap = respace_betas(betas, use)

    alphas = 1.0 - new_betas
    abar = np.cumprod(alphas)
    abar_prev = np.append(1.0, abar[:-1])

    post_var = new_betas * (1.0 - abar_prev) / (1.0 - abar)
    post_logvar_clipped = np.log(np.append(post_var[1], post_var[1:]))
    coef1 = new_betas * np.sqrt(abar_prev) / (1.0 - abar)
    coef2 = (1.0 - abar_prev) * np.sqrt(alphas) / (1.0 - abar)

    # Eq. 19 in the posterior parameterisation: sigma_t = sqrt(post_var),
    # a_t = coef1 (the reference's sigma_t / a_t * sigma_y precedence)
    sigma_t = np.sqrt(post_var)
    a_t = coef1
    noisy = sigma_t < a_t * sigma_y
    lam = np.where(noisy, np.divide(sigma_t, a_t, out=np.ones_like(sigma_t),
                                    where=a_t > 0) * sigma_y, 1.0)
    gam = np.where(noisy, 0.0, post_var - (a_t * 1.0 * sigma_y) ** 2)

    if schedule_jump_params is None:
        schedule_jump_params = dict(
            t_T=len(new_betas), n_sample=1, jump_length=10, jump_n_sample=10
        )
    t_cur, is_travel = build_jump_pairs(schedule_jump_params)

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return PosteriorTables(
        betas=f32(new_betas),
        timestep_map=np.asarray(tmap, dtype=np.float32),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / abar)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / abar - 1.0)),
        posterior_mean_coef1=f32(coef1),
        posterior_mean_coef2=f32(coef2),
        posterior_variance=f32(post_var),
        posterior_log_variance_clipped=f32(post_logvar_clipped),
        log_betas=f32(np.log(new_betas)),
        lambda_t=f32(lam),
        gamma_t=f32(gam),
        t_cur=t_cur,
        is_travel=is_travel,
        travel_shift=np.asarray(time_shift, dtype=np.int32),
    )


def n_model_calls(tables) -> int:
    """Model calls per trajectory: its non-travel steps. Takes the tables
    (or any schedule with `is_travel`) or the `is_travel` array itself, the
    key-step domain of the encoder cache (sampling/accel.py)."""
    return int(np.sum(~np.asarray(getattr(tables, "is_travel", tables), bool)))


def _x0_hat(operator, clip_denoised, x, apy, paste_mask, paste_content, eps, s):
    """The projected and pasted x0 of a posterior step, given eps; `s` as in
    _posterior_update."""
    x0_t = s["sqrt_recip"] * x - s["sqrt_recipm1"] * eps
    if clip_denoised:
        x0_t = torch.clamp(x0_t, -1.0, 1.0)

    # Eq. 17: x0_hat = lam * Apy + x0 - lam * Ap(A(x0))
    op_ctx = s["op_ctx"]
    rng_proj = (operator.range_ctx(x0_t, op_ctx) if op_ctx is not None
                else operator.Ap(operator.A(x0_t)))
    lam = s["lam"]
    x0_hat = lam * apy + x0_t - lam * rng_proj

    # Mask-Shift paste: overlap strips come from the solved canvas
    if paste_mask is not None:
        x0_hat = paste_mask * paste_content + (1.0 - paste_mask) * x0_hat
    return x0_hat


def _posterior_update(operator, guidance_fn, clip_denoised, x, apy, paste_mask,
                      paste_content, noise, out, t_b, s):
    """The posterior DDNM step given the model output `out` (B, H, W, 2C);
    `s` holds this step's 0-dim fp32 tensors (sqrt_recip, sqrt_recipm1,
    lam, coef1, coef2, gamma, and `noise_scale` = nonzero * sqrt(gamma))
    and the operator context `op_ctx`."""
    x0_hat = _x0_hat(operator, clip_denoised, x, apy, paste_mask, paste_content,
                     out[..., :x.shape[-1]], s)
    mean = s["coef1"] * x0_hat + s["coef2"] * x
    if guidance_fn is not None:
        mean = mean + s["gamma"] * guidance_fn(x, t_b)
    return mean + s["noise_scale"] * noise, x0_hat


class _DeviceTables:
    """The tables' per-step values as fp32 tensors on one device (one upload
    each; indexing them by a Python int is a view, no launch)."""

    def __init__(self, tables: PosteriorTables, device):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.t_orig = f(tables.timestep_map)
        self.sqrt_recip = f(tables.sqrt_recip_alphas_cumprod)
        self.sqrt_recipm1 = f(tables.sqrt_recipm1_alphas_cumprod)
        self.lam = f(tables.lambda_t)
        self.coef1 = f(tables.posterior_mean_coef1)
        self.coef2 = f(tables.posterior_mean_coef2)
        self.gamma = f(tables.gamma_t)
        gamma = np.asarray(tables.gamma_t, np.float32)
        nonzero = (np.arange(len(gamma)) != 0).astype(np.float32)
        self.noise_scale = f(nonzero * np.sqrt(np.maximum(gamma, np.float32(0))))
        # the undo at t: beta[min(t + shift, T - 1)], its square roots taken
        # on the CPU and uploaded (no .numpy(): torch.export traces this,
        # serving.py)
        betas = torch.as_tensor(np.asarray(tables.betas, np.float32))
        self.undo_keep = torch.sqrt(1.0 - betas).to(device)
        self.undo_noise = torch.sqrt(betas).to(device)
        self.shift = int(tables.travel_shift)
        self.last = len(betas) - 1

    def step(self, t: int, op_ctx) -> dict:
        return {"sqrt_recip": self.sqrt_recip[t], "sqrt_recipm1": self.sqrt_recipm1[t],
                "lam": self.lam[t], "coef1": self.coef1[t], "coef2": self.coef2[t],
                "gamma": self.gamma[t], "noise_scale": self.noise_scale[t], "op_ctx": op_ctx}

    def undo(self, t: int):
        i = min(t + self.shift, self.last)
        return self.undo_keep[i], self.undo_noise[i]


def _check_sampler_args(operator, paste_mask, paste_content, op_ctx) -> None:
    if (paste_mask is None) != (paste_content is None):
        raise ValueError("paste_mask and paste_content go together")
    if op_ctx is not None and not getattr(operator, "has_ctx", False):
        name = getattr(operator, "name", type(operator).__name__)
        raise ValueError(f"operator {name!r} has no A_ctx/Ap_ctx forms; op_ctx requires a "
                         "context-parameterised operator")


@torch.no_grad()
def sample_posterior(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_init: torch.Tensor,
    apy: torch.Tensor,
    operator: FunctionalOperator,
    tables: PosteriorTables,
    gens: Sequence[torch.Generator],
    *,
    paste_mask: Optional[torch.Tensor] = None,
    paste_content: Optional[torch.Tensor] = None,
    guidance_fn: Optional[Callable] = None,
    clip_denoised: bool = True,
    noise_fn: NoiseFn = default_noise,
    op_ctx: Optional[torch.Tensor] = None,
    solver: str = "ddim",
    loop: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the posterior DDNM jump-schedule loop over NHWC images. Returns
    (x_final, x0_hat_final); callers keep x0_hat (the reference writes
    x0_t into the canvas).

    model_fn(x, t_orig[B]) -> (B, H, W, 2C) with channels [eps, var_values].
    `apy` is A+y of each image (or tile). `gens`: one generator per image
    (sampling/rng.py), or a `threefry.KeyNoise` (JAX's noise from a JAX
    key); every step draws `noise_fn(gens, x.shape)`, undo steps
    included, as the JAX sampler does. `guidance_fn(x, t_orig)`
    returns grad log p(y|x) * scale, added to the mean times gamma_t.
    `paste_mask` / `paste_content`: the Mask-Shift blend of each tile.
    `op_ctx`: the runtime operator context (a per-image mask) of a
    context-parameterised operator. `solver`: "ddim" (the reference's
    stochastic posterior transition) or "multistep" (second-order,
    deterministic, noise-free tables only; sampling/solvers.py). `loop`:
    "auto" | "host" | "scan" (module docstring; another value raises)."""
    if solver == "multistep":
        from ddnm_tpu_torch.sampling.solvers import sample_posterior_multistep

        return sample_posterior_multistep(
            model_fn, x_init, apy, operator, tables, gens, paste_mask=paste_mask,
            paste_content=paste_content, guidance_fn=guidance_fn,
            clip_denoised=clip_denoised, noise_fn=noise_fn, op_ctx=op_ctx, loop=loop)
    if solver != "ddim":
        raise ValueError(f"unknown solver {solver!r} (ddim | multistep)")
    _check_sampler_args(operator, paste_mask, paste_content, op_ctx)
    t_cur, is_travel = tables.t_cur.tolist(), tables.is_travel.tolist()

    def make_body():
        tb = _DeviceTables(tables, x_init.device)

        def body(x_init, apy, paste_mask, paste_content, op_ctx, *, noise, steps=None):
            dev = x_init.device
            n = x_init.shape[0]
            x, x0_hat = x_init, torch.zeros_like(x_init)
            for k in range(len(t_cur)) if steps is None else steps:
                t = t_cur[k]
                eps = draw_noise(noise_fn, noise, x.shape, dev)
                if is_travel[k]:
                    keep, scale = tb.undo(t)
                    x = keep * x + scale * eps
                else:
                    t_b = tb.t_orig[t].expand(n)
                    out = model_fn(x, t_b)
                    x, x0_hat = _posterior_update(operator, guidance_fn, clip_denoised, x,
                                                  apy, paste_mask, paste_content, eps, out,
                                                  t_b, tb.step(t, op_ctx))
            return x, x0_hat

        return body

    inputs = (x_init, apy, paste_mask, paste_content, op_ctx)
    if _resolve_posterior_loop(loop) == "scan":
        parts = ("posterior", model_fn, operator, tables, guidance_fn, clip_denoised, noise_fn)
        return _run_scan(parts, make_body, inputs, gens, is_travel)
    return make_body()(*inputs, noise=gens)


def _resolve_posterior_loop(loop: str) -> str:
    """JAX's `_resolve_posterior_loop`: "auto" always means the scan (here a
    CUDA graph, sampling/graphs.py), in a data mesh's shards and a
    spatial grid's ranks too, except on a gloo spatial group on a card,
    where it is "host" and "scan" raises ValueError."""
    return graphs.resolve_loop(loop)


def _run_scan(parts, make_body, inputs, gens, kinds):
    """The scan driver (JAX `_run_scan`): the body unrolled into one CUDA
    graph, captured at the first call of its key and replayed; the warm-up
    runs the first step of each kind."""
    return graphs.run(parts, make_body, inputs, gens, np.asarray(kinds).tolist())
