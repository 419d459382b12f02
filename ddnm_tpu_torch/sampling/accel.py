"""Encoder propagation, the opt-in approximate accelerator (port of
ddnm_tpu/sampling/accel.py).

The "Faster Diffusion" observation (Li et al., arXiv 2312.09608): a
diffusion UNet's encoder features change slowly across adjacent
timesteps, so at a cached step the encoder output of the last key step
(the bottleneck h and the skip list) is reused and only the decoder runs,
with a fresh time embedding, so the decoder's timestep conditioning stays
exact. Outputs differ from the exact sampler; with `interval=1` every step
is a key step and the result is the exact sampler's, bit for bit (each
step draws its noise from the generators as the exact sampler does).

Key-step placement: by default the cache refreshes every `interval`-th
model call since the last time-travel jump (uniform). `key_steps` pins the
full forwards to explicit global model-call indices instead:
`key_steps_end_dense` (an exact tail and a bounded head gap, the CLIs'
`--encoder_cache_policy end_dense`) or `select_key_steps` over the drift
that `measure_feature_drift` measures on one exact trajectory. A jump
drops the cache, so a key step follows every jump.

The split functions are `encode_fn(x, t) -> cache` and `decode_fn(cache,
x, t) -> model output` (`ddpm_split_fns`, `adm_split_fns`); the loops are
eager, over the static schedule, as sampling/ddnm.py's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ddnm_tpu_torch.sampling.ddnm import (
    DDNMSchedule,
    _simplified_update,
    _step_scalars,
    _travel_step,
)
from ddnm_tpu_torch.sampling.posterior import (
    PosteriorTables,
    _check_sampler_args,
    _DeviceTables,
    _posterior_update,
    n_model_calls,
)
from ddnm_tpu_torch.sampling.rng import NoiseFn, default_noise, draw_noise

__all__ = [
    "sample_simplified_encoder_prop",
    "sample_posterior_encoder_prop",
    "ddpm_split_fns",
    "adm_split_fns",
    "measure_feature_drift",
    "select_key_steps",
    "key_steps_end_dense",
    "key_steps_for_policy",
    "n_model_calls",
]


def key_steps_end_dense(n_calls: int, n_keys: int, exact_tail=None) -> list:
    """End-weighted key schedule: the last `exact_tail` model calls run
    exact (full forwards) and the rest of the budget spreads uniformly over
    the head. Default exact_tail = n_keys // 2. The JAX package measured
    on its trained toy harness that the cached encoder's error is benign
    at the high-noise start and fatal near the end, where the image forms.
    Validate per checkpoint."""
    if not 1 <= n_keys <= n_calls:
        raise ValueError(f"n_keys must be in [1, {n_calls}], got {n_keys}")
    if exact_tail is None:
        exact_tail = n_keys // 2
    exact_tail = int(min(exact_tail, n_keys - 1, n_calls - 1))
    tail = list(range(n_calls - exact_tail, n_calls))
    head_budget = n_keys - exact_tail
    head = np.linspace(0, n_calls - exact_tail - 1, head_budget).astype(int)
    return sorted(set([0]) | set(int(i) for i in head) | set(tail))


def _make_key_pred(interval: int, key_steps):
    """`is_key(segment_call, global_call) -> bool`: uniform (every
    `interval`-th call since the segment start; a segment restarts after
    each jump), or the set `key_steps` of global model-call indices.
    interval == 1 is always-full, the exactness contract: key_steps with
    it is contradictory and raises."""
    if key_steps is not None:
        if interval == 1:
            raise ValueError(
                "interval=1 guarantees the exact sampler; passing key_steps "
                "with it is contradictory (drop key_steps or use interval>1)"
            )
        keys = frozenset(int(k) for k in key_steps)
        return lambda seg_call, glob_call: glob_call in keys
    if interval == 1:
        return lambda seg_call, glob_call: True
    return lambda seg_call, glob_call: seg_call % interval == 0


def key_steps_for_policy(n_calls: int, interval: int, policy) -> list | None:
    """The CLIs' dispatch: None (the uniform predicate) or the end-dense
    set at the uniform policy's budget, ceil(n_calls / interval)."""
    if interval <= 1 or policy in (None, "uniform"):
        return None
    if policy != "end_dense":
        raise ValueError(
            f"encoder-cache policy must be 'uniform' or 'end_dense', got {policy!r}")
    return key_steps_end_dense(n_calls, -(-n_calls // interval))


def select_key_steps(drift: np.ndarray, n_keys: int) -> list:
    """`n_keys` global model-call indices for `key_steps` from a measured
    drift profile: walk the trajectory accumulating drift and open a new
    cache window whenever it exceeds an equal-budget threshold (bisected
    so that the windows number exactly `n_keys`). Step 0 is always a key
    step."""
    drift = np.asarray(drift, np.float64)
    n = len(drift)
    if not 1 <= n_keys <= n:
        raise ValueError(f"n_keys must be in [1, {n}], got {n_keys}")

    def windows(thr):
        keys, acc = [0], 0.0
        for i in range(1, n):
            acc += drift[i]
            if acc > thr:
                keys.append(i)
                acc = 0.0
        return keys

    lo, hi = 0.0, float(drift.sum()) + 1.0
    for _ in range(80):
        mid = (lo + hi) / 2
        if len(windows(mid)) > n_keys:
            lo = mid
        else:
            hi = mid
    keys = windows(hi)
    # bisection can land under budget on plateaus: fill with the largest
    # remaining single-step drifts
    if len(keys) < n_keys:
        have = set(keys)
        extra = [i for i in np.argsort(-drift) if i not in have]
        keys = sorted(have | set(int(i) for i in extra[: n_keys - len(keys)]))
    return [int(k) for k in keys]


def ddpm_split_fns(model):
    """(encode_fn, decode_fn) of a DDPMUNet (models/unet_ddpm.py
    `time_embed`, `encode`, `decode`): `encode_fn(x, t) -> (h, skips)`,
    `decode_fn(cache, x, t) -> eps` with a fresh time embedding."""

    def encode_fn(x, t):
        h, hs = model.encode(x, model.time_embed(t))
        return h, tuple(hs)

    def decode_fn(cache, x, t):
        return model.decode(cache[0], cache[1], model.time_embed(t), orig_dtype=x.dtype)

    return encode_fn, decode_fn


def adm_split_fns(model, label: Optional[int] = None):
    """(encode_fn, decode_fn) of an ADMUNet through its mode="encode" /
    "decode" forwards. `label`: the class of every image of a
    class-conditional model."""

    def _y(x):
        if label is None:
            return None
        return torch.full((x.shape[0],), label, dtype=torch.long, device=x.device)

    def encode_fn(x, t):
        return model(x, t, _y(x), mode="encode")

    def decode_fn(cache, x, t):
        return model(x, t, _y(x), mode="decode", cache=cache)

    return encode_fn, decode_fn


def _check_interval(interval: int) -> None:
    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")


@torch.no_grad()
def measure_feature_drift(encode_fn, decode_fn, x_init, y, operator, sched: DDNMSchedule,
                          gens: Sequence[torch.Generator], *, eta: float = 0.85,
                          sigma_y: float = 0.0, noise_fn: NoiseFn = default_noise
                          ) -> np.ndarray:
    """Per-model-call encoder-feature drift of one exact simplified
    trajectory: drift[i] = the relative change of the encoder bottleneck
    between model calls i - 1 and i (drift[0] = 0). Calibrate once per
    (checkpoint, task, schedule), then pass `select_key_steps(drift,
    n_keys)` as the samplers' `key_steps`."""
    dev = x_init.device
    n = x_init.shape[0]
    t_f, at, at_next = _step_scalars(sched, dev)
    x, x0_pred = x_init, torch.zeros_like(x_init)
    prev = None
    drifts = []
    for i, travel in enumerate(sched.is_travel.tolist()):
        noise = draw_noise(noise_fn, gens, x.shape, dev)
        if travel:
            x = _travel_step(x0_pred, at_next[i], noise)
            continue
        t_b = t_f[i].expand(n)
        cache = encode_fn(x, t_b)
        et = decode_fn(cache, x, t_b)  # _simplified_update drops a learned-sigma head
        x, x0_pred = _simplified_update(operator, eta, sigma_y, x, y, et, at[i], at_next[i],
                                        noise)
        h = cache[0].float().cpu().numpy().ravel()
        if prev is None:
            drifts.append(0.0)
        else:
            denom = float(np.linalg.norm(prev)) or 1.0
            drifts.append(float(np.linalg.norm(h - prev)) / denom)
        prev = h
    return np.asarray(drifts, np.float64)


@torch.no_grad()
def sample_simplified_encoder_prop(
    encode_fn,
    decode_fn,
    x_init: torch.Tensor,
    y: torch.Tensor,
    operator,
    sched: DDNMSchedule,
    gens: Sequence[torch.Generator],
    *,
    eta: float = 0.85,
    sigma_y: float = 0.0,
    interval: int = 3,
    key_steps=None,
    noise_fn: NoiseFn = default_noise,
    op_ctx=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Simplified DDNM+ with the encoder's features reused for `interval -
    1` of every `interval` model calls (or between the `key_steps`).
    Returns (x_final, x0_pred_final) like sample_simplified; `gens`,
    `noise_fn` and `op_ctx` as there. interval=1 is the exact sampler."""
    _check_interval(interval)
    _check_sampler_args(operator, None, None, op_ctx)
    is_key = _make_key_pred(interval, key_steps)
    dev = x_init.device
    n = x_init.shape[0]
    t_f, at, at_next = _step_scalars(sched, dev)
    x, x0_pred = x_init, torch.zeros_like(x_init)
    cache = None
    seg_call = glob_call = 0
    for i, travel in enumerate(sched.is_travel.tolist()):
        noise = draw_noise(noise_fn, gens, x.shape, dev)
        if travel:
            x = _travel_step(x0_pred, at_next[i], noise)
            # a jump breaks the adjacent-timestep premise: drop the cache, so
            # that a key (full) step follows every jump
            cache, seg_call = None, 0
            continue
        t_b = t_f[i].expand(n)
        if cache is None or is_key(seg_call, glob_call):
            cache = encode_fn(x, t_b)
        et = decode_fn(cache, x, t_b)  # _simplified_update drops a learned-sigma head
        x, x0_pred = _simplified_update(operator, eta, sigma_y, x, y, et, at[i], at_next[i],
                                        noise, op_ctx)
        seg_call += 1
        glob_call += 1
    return x, x0_pred


@torch.no_grad()
def sample_posterior_encoder_prop(
    encode_fn,
    decode_fn,
    x_init: torch.Tensor,
    apy: torch.Tensor,
    operator,
    tables: PosteriorTables,
    gens: Sequence[torch.Generator],
    *,
    interval: int = 3,
    key_steps=None,
    paste_mask: Optional[torch.Tensor] = None,
    paste_content: Optional[torch.Tensor] = None,
    guidance_fn=None,
    clip_denoised: bool = True,
    noise_fn: NoiseFn = default_noise,
    op_ctx: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior DDNM (the hq sampler) with the encoder's features reused
    as in sample_simplified_encoder_prop; `decode_fn` returns the (B, H,
    W, 2C) output. Arguments and the return as sample_posterior's;
    interval=1 is the exact sampler."""
    _check_interval(interval)
    _check_sampler_args(operator, paste_mask, paste_content, op_ctx)
    is_key = _make_key_pred(interval, key_steps)
    dev = x_init.device
    n = x_init.shape[0]
    tb = _DeviceTables(tables, dev)
    x, x0_hat = x_init, torch.zeros_like(x_init)
    cache = None
    seg_call = glob_call = 0
    for t, travel in zip(tables.t_cur.tolist(), tables.is_travel.tolist()):
        noise = draw_noise(noise_fn, gens, x.shape, dev)
        if travel:
            keep, scale = tb.undo(t)
            x = keep * x + scale * noise
            cache, seg_call = None, 0  # as in the simplified form
            continue
        t_b = tb.t_orig[t].expand(n)
        if cache is None or is_key(seg_call, glob_call):
            cache = encode_fn(x, t_b)
        out = decode_fn(cache, x, t_b)
        x, x0_hat = _posterior_update(operator, guidance_fn, clip_denoised, x, apy,
                                      paste_mask, paste_content, noise, out, t_b,
                                      tb.step(t, op_ctx))
        seg_call += 1
        glob_call += 1
    return x, x0_hat
