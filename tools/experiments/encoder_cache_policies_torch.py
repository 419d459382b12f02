"""Encoder-cache key-step placement on the trained toy fixtures, on the
port (the PyTorch counterpart of
tools/experiments/encoder_cache_policies.py).

The simplified pipeline on tests/fixtures/toy_ddpm32.pt (4x average-pool
SR, 100 steps, the 8 committed eval blobs): the exact sampler, then at
the full-forward budgets of intervals 2, 3, 4 and 5 the uniform interval,
drift-calibrated key sets (`measure_feature_drift` on 2 images, then
`select_key_steps`) and end-dense key sets (`key_steps_end_dense`).
`--posterior`: the posterior pipeline on tests/fixtures/toy_adm32.pt
(respacing 25 + jump 10 x 2, about 45 model calls), exact, uniform and
end-dense at intervals 2, 3 and 5. Keys and x_T are JAX's
(PRNGKey(11) noise, PRNGKey(12) x_T, PRNGKey(97) / (98) the calibration),
drawn through sampling/threefry.py, so each row is the JAX row's run on
the port.

  python tools/experiments/encoder_cache_policies_torch.py [--posterior]
      [--images 8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO / "tools/experiments"))

from ddnm_tpu_torch import schedules as sch  # noqa: E402
from ddnm_tpu_torch.data.metrics import psnr  # noqa: E402
from ddnm_tpu_torch.operators import build_functional_operator  # noqa: E402
from ddnm_tpu_torch.sampling import build_posterior_tables, build_schedule  # noqa: E402
from ddnm_tpu_torch.sampling import sample_posterior, sample_simplified  # noqa: E402
from ddnm_tpu_torch.sampling.accel import (  # noqa: E402
    adm_split_fns,
    ddpm_split_fns,
    key_steps_end_dense,
    measure_feature_drift,
    sample_posterior_encoder_prop,
    sample_simplified_encoder_prop,
    select_key_steps,
)
from ddnm_tpu_torch.sampling.threefry import KeyNoise, normal, prng_key  # noqa: E402
from solver_posterior_quality_torch import load_adm  # noqa: E402
from solver_quality_torch import load_ddpm, load_eval_images  # noqa: E402


def _score(x, gt, clip: bool) -> float:
    """The JAX experiment's score: data.metrics.psnr of each (H, W, 3)
    image, which takes its rows as the batch (a PSNR a row), averaged over
    rows and images."""
    a = (x.float().cpu() + 1) / 2
    if clip:
        a = a.clamp(0, 1)
    b = (gt.float().cpu() + 1) / 2
    return round(float(torch.cat([psnr(a[i], b[i]) for i in range(len(a))]).mean()), 2)


@torch.no_grad()
def simplified_rows(device, images: int = 8, intervals=(2, 3, 4, 5),
                    t_sampling: int = 100) -> list:
    model = load_ddpm("toy32", device)
    enc_fn, dec_fn = ddpm_split_fns(model)
    res = 32
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000)
    sched = build_schedule(betas=betas, t_sampling=t_sampling)
    op = build_functional_operator("sr_averagepooling", image_size=res, deg_scale=4,
                                   device=device)
    gt = torch.as_tensor(load_eval_images("exp/datasets/toy32", images), device=device)
    y = op.A(gt)
    x_init = normal(prng_key(12, device), gt.shape)
    noise = lambda: KeyNoise(prng_key(11, device))  # noqa: E731

    cal_gt = gt[:2]
    drift = measure_feature_drift(enc_fn, dec_fn, normal(prng_key(98, device), cal_gt.shape),
                                  op.A(cal_gt), op, sched,
                                  KeyNoise(prng_key(97, device)))
    n_calls = len(drift)
    exact, _ = sample_simplified(lambda x, t: model(x, t), x_init, y, op, sched, noise())
    rows = [{"sampler": "exact", "psnr": _score(exact, gt, False), "full_fwds": n_calls}]
    for interval in intervals:
        budget = -(-n_calls // interval)
        xu, _ = sample_simplified_encoder_prop(enc_fn, dec_fn, x_init, y, op, sched, noise(),
                                               interval=interval)
        drift_keys = select_key_steps(drift, budget)
        xd, _ = sample_simplified_encoder_prop(enc_fn, dec_fn, x_init, y, op, sched, noise(),
                                               key_steps=drift_keys)
        end_keys = key_steps_end_dense(n_calls, budget)
        xe, _ = sample_simplified_encoder_prop(enc_fn, dec_fn, x_init, y, op, sched, noise(),
                                               key_steps=end_keys)
        rows += [{"sampler": f"cache_k{interval}_uniform", "psnr": _score(xu, gt, False),
                  "full_fwds": budget},
                 {"sampler": f"cache_k{interval}_drift_calibrated",
                  "psnr": _score(xd, gt, False), "full_fwds": len(drift_keys)},
                 {"sampler": f"cache_k{interval}_end_dense", "psnr": _score(xe, gt, False),
                  "full_fwds": len(end_keys)}]
    return rows


@torch.no_grad()
def posterior_rows(device, images: int = 8, intervals=(2, 3, 5)) -> list:
    model = load_adm("toy32", device)
    enc_fn, dec_fn = adm_split_fns(model)
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True), timestep_respacing="25",
        sigma_y=0.0, schedule_jump_params=dict(t_T=25, n_sample=1, jump_length=10,
                                               jump_n_sample=2))
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4,
                                   device=device)
    gt = torch.as_tensor(load_eval_images("exp/datasets/toy32", images), device=device)
    apy = op.Ap(op.A(gt))
    x_init = normal(prng_key(12, device), gt.shape)
    noise = lambda: KeyNoise(prng_key(11, device))  # noqa: E731
    n_calls = int(np.sum(~np.asarray(tables.is_travel, bool)))
    _, x0 = sample_posterior(lambda x, t: model(x, t), x_init, apy, op, tables, noise())
    rows = [{"sampler": "exact", "psnr": _score(x0, gt, True), "full_fwds": n_calls}]
    for interval in intervals:
        budget = -(-n_calls // interval)
        _, xu = sample_posterior_encoder_prop(enc_fn, dec_fn, x_init, apy, op, tables, noise(),
                                              interval=interval)
        _, xe = sample_posterior_encoder_prop(enc_fn, dec_fn, x_init, apy, op, tables, noise(),
                                              key_steps=key_steps_end_dense(n_calls, budget))
        rows.append({"k": interval, "uniform": _score(xu, gt, True),
                     "end_dense": _score(xe, gt, True), "full_fwds": budget})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--posterior", action="store_true")
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    dev = torch.device(ns.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    rows = (posterior_rows if ns.posterior else simplified_rows)(dev, ns.images)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for r in rows:
        print(json.dumps({**r, "device": device}))
    return rows


if __name__ == "__main__":
    main()
