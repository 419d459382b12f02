#!/usr/bin/env python
"""Goldens of the port's paths at full width, from the JAX package, for the
PyTorch/CUDA port (ddnm_tpu_torch) to be held against.

Runs ddnm_tpu's samplers on the CPU with the trained flagship weights
(tests/fixtures/flag_ddpm256.pt: the 114M DDPM UNet of configs/celeba_hq.yml
at 256 px) under the zero-noise protocol of tests/_golden.py: x_T from
np.random.RandomState(42) (NCHW, then NHWC), the first 2 images of
exp/datasets/natural256, 25 DDIM steps, eta 0.85, fp32.

  simplified  `sample_simplified`, sr_averagepooling 4x, sigma_y 0:
    tests/fixtures/flag_simplified_golden.json  per-image PSNRs + protocol
    tests/fixtures/flag_simplified_pool8.npy    the final x (model domain,
                                                [-1, 1] unclipped) average-
                                                pooled 8x8: (2, 32, 32, 3)
  multistep   the simplified protocol with `solver="multistep"` at 10 steps
              (chip_smoke.py phase 15):
    tests/fixtures/flag_multistep_golden.json  per-image PSNRs + protocol
    tests/fixtures/flag_multistep_pool8.npy    pooled as above
  svd         `sample_svd` (default `fwht`), cs_walshhadamard at ratio 0.25,
              perm default_rng(7).permutation(65536), sigma_y 0 (cs_wh_025)
              and 0.1 (cs_wh_noisy), as tests/_golden.py TASKS runs them:
    tests/fixtures/flag_svd_golden.json  batch PSNRs + protocol; each must
                                         equal flag_golden_psnr.json's
                                         `ours_psnr` to 4 decimals
    tests/fixtures/flag_svd_pool8.npy    (2 tasks, 2, 32, 32, 3) pooled as
                                         above, tasks in the JSON's order

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py [--only simplified|multistep|svd]

About 4 minutes and 11 GB of memory per run of 25 steps (the multistep
golden's 10 steps take less than half of that). chip_smoke.py (phases 4
and 15 and the SVD parity phase, on the card) and tests/test_torch_golden.py
(the port's CPU plain path) read these files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

PROTOCOL = {
    "fixture": "tests/fixtures/flag_ddpm256.pt",
    "eval_dir": "exp/datasets/natural256",
    "n_images": 2,
    "res": 256,
    "x_T_seed": 42,
    "t_sampling": 25,
    "eta": 0.85,
    "sigma_y": 0.0,
    "deg": "sr_averagepooling",
    "deg_scale": 4.0,
    "noise": "zero",
    "dtype": "float32",
    "pool8": "final x in [-1, 1] (unclipped), 8x8 average pool, NHWC",
}

MULTISTEP_PROTOCOL = {**PROTOCOL, "t_sampling": 10, "solver": "multistep"}

SVD_PROTOCOL = {
    **{k: PROTOCOL[k] for k in ("fixture", "eval_dir", "n_images", "res", "x_T_seed",
                                "t_sampling", "eta", "noise", "dtype", "pool8")},
    "perm": "np.random.default_rng(7).permutation(res * res)",
    "psnr": "one PSNR over the batch, images clipped to [0, 1]",
    "tasks": {"cs_wh_025": {"deg": "cs_walshhadamard", "deg_scale": 0.25, "sigma_y": 0.0},
              "cs_wh_noisy": {"deg": "cs_walshhadamard", "deg_scale": 0.25,
                              "sigma_y": 0.1}},
}


def simplified_golden(p: dict = PROTOCOL, name: str = "flag_simplified") -> None:
    """The simplified protocol `p` (its `solver`, default ddim) into
    tests/fixtures/<name>_golden.json and <name>_pool8.npy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ddnm_tpu import schedules as sch
    from ddnm_tpu.operators import build_functional_operator
    from ddnm_tpu.sampling import build_schedule, sample_simplified
    from tests._golden import FLAG256, load_eval_images, load_our_model, psnr01

    n, res = p["n_images"], p["res"]
    gt = np.transpose(load_eval_images(n, FLAG256), (0, 2, 3, 1))  # NHWC [-1, 1]
    x_T = np.random.RandomState(p["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    x_T = np.ascontiguousarray(np.transpose(x_T, (0, 2, 3, 1)))
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    op = build_functional_operator(p["deg"], image_size=res, deg_scale=p["deg_scale"])
    fn, params = load_our_model(FLAG256)
    t0 = time.perf_counter()
    x, _ = sample_simplified(
        fn, jnp.asarray(x_T), op.A(jnp.asarray(gt)), op,
        build_schedule(betas=betas, t_sampling=p["t_sampling"]),
        jax.random.PRNGKey(0), eta=p["eta"], sigma_y=p["sigma_y"],
        noise_fn=lambda key, shape: jnp.zeros(shape, jnp.float32),
        params=params, loop="host", solver=p.get("solver", "ddim"))
    x = np.asarray(x, np.float32)
    seconds = time.perf_counter() - t0

    to01 = lambda a: np.clip((a + 1) / 2, 0, 1)
    per_image = [round(psnr01(to01(x[i]), to01(gt[i])), 4) for i in range(n)]
    pool8 = x.reshape(n, res // 8, 8, res // 8, 8, 3).mean(axis=(2, 4)).astype(np.float32)
    out = {"protocol": p, "per_image_psnr": per_image,
           "mean_psnr": round(float(np.mean(per_image)), 4),
           "jax_cpu_seconds": round(seconds, 1)}
    (REPO / f"tests/fixtures/{name}_golden.json").write_text(json.dumps(out, indent=1) + "\n")
    np.save(REPO / f"tests/fixtures/{name}_pool8.npy", pool8)
    print(json.dumps(out))


def svd_golden() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ddnm_tpu import schedules as sch
    from ddnm_tpu.operators import build_svd_operator
    from ddnm_tpu.sampling import build_schedule, sample_svd
    from tests._golden import FLAG256, load_eval_images, load_our_model, psnr01, toy_perm

    p = SVD_PROTOCOL
    n, res = p["n_images"], p["res"]
    gt = load_eval_images(n, FLAG256)  # NCHW [-1, 1]
    x_T = np.random.RandomState(p["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    x_T = np.ascontiguousarray(np.transpose(x_T, (0, 2, 3, 1)))
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    sched = build_schedule(betas=betas, t_sampling=p["t_sampling"])
    fn, params = load_our_model(FLAG256)
    flag = json.loads(FLAG256.golden_json.read_text())
    to01 = lambda a: np.clip((a + 1) / 2, 0, 1)
    out = {"protocol": p, "tasks": {}}
    pools = []
    for name, task in p["tasks"].items():
        op = build_svd_operator(task["deg"], channels=3, image_size=res,
                                deg_scale=task["deg_scale"], perm=toy_perm(res))
        y = op.A(jnp.asarray(gt.reshape(n, -1)))
        t0 = time.perf_counter()
        x, _ = sample_svd(
            fn, jnp.asarray(x_T), y, op, sched, jax.random.PRNGKey(0), eta=p["eta"],
            sigma_y=task["sigma_y"], noise_fn=lambda key, shape: jnp.zeros(shape, jnp.float32),
            params=params, loop="host")
        x = np.asarray(x, np.float32)  # NHWC
        seconds = time.perf_counter() - t0
        batch_psnr = round(psnr01(to01(x), to01(np.transpose(gt, (0, 2, 3, 1)))), 4)
        if batch_psnr != flag[name]["ours_psnr"]:
            raise AssertionError(f"{name}: batch PSNR {batch_psnr} does not reproduce "
                                 f"{FLAG256.golden_json.name}'s {flag[name]['ours_psnr']}")
        out["tasks"][name] = {"batch_psnr": batch_psnr, "jax_cpu_seconds": round(seconds, 1)}
        pools.append(x.reshape(n, res // 8, 8, res // 8, 8, 3).mean(axis=(2, 4)))
        print(name, json.dumps(out["tasks"][name]), flush=True)
    (REPO / "tests/fixtures/flag_svd_golden.json").write_text(json.dumps(out, indent=1) + "\n")
    np.save(REPO / "tests/fixtures/flag_svd_pool8.npy", np.stack(pools).astype(np.float32))
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--only", choices=["simplified", "multistep", "svd"], default=None,
                    help="write one golden (default: all three)")
    only = ap.parse_args().only
    if only in (None, "simplified"):
        simplified_golden()
    if only in (None, "multistep"):
        simplified_golden(MULTISTEP_PROTOCOL, "flag_multistep")
    if only in (None, "svd"):
        svd_golden()


if __name__ == "__main__":
    main()
