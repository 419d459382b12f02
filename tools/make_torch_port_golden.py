#!/usr/bin/env python
"""Golden of the simplified DDNM+ path at full width, from the JAX package,
for the PyTorch/CUDA port (ddnm_tpu_torch) to be held against.

Runs ddnm_tpu's `sample_simplified` on the CPU with the trained flagship
weights (tests/fixtures/flag_ddpm256.pt: the 114M DDPM UNet of
configs/celeba_hq.yml at 256 px) under the zero-noise protocol of
tests/_golden.py: x_T from np.random.RandomState(42) (NCHW, then NHWC), the
first 2 images of exp/datasets/natural256, 25 DDIM steps, eta 0.85,
sigma_y 0, sr_averagepooling 4x, fp32. Writes

  tests/fixtures/flag_simplified_golden.json  per-image PSNRs + protocol
  tests/fixtures/flag_simplified_pool8.npy    the final x (model domain,
                                              [-1, 1] unclipped) average-
                                              pooled 8x8: (2, 32, 32, 3) fp32

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py

Both chip_smoke.py (phase 4, on the card) and tests/test_torch_golden.py
(the port's CPU plain path) read these files.
"""

from __future__ import annotations

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


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ddnm_tpu import schedules as sch
    from ddnm_tpu.operators import build_functional_operator
    from ddnm_tpu.sampling import build_schedule, sample_simplified
    from tests._golden import FLAG256, load_eval_images, load_our_model, psnr01

    p = PROTOCOL
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
        params=params, loop="host")
    x = np.asarray(x, np.float32)
    seconds = time.perf_counter() - t0

    to01 = lambda a: np.clip((a + 1) / 2, 0, 1)
    per_image = [round(psnr01(to01(x[i]), to01(gt[i])), 4) for i in range(n)]
    pool8 = x.reshape(n, res // 8, 8, res // 8, 8, 3).mean(axis=(2, 4)).astype(np.float32)
    out = {"protocol": p, "per_image_psnr": per_image,
           "mean_psnr": round(float(np.mean(per_image)), 4),
           "jax_cpu_seconds": round(seconds, 1)}
    (REPO / "tests/fixtures/flag_simplified_golden.json").write_text(
        json.dumps(out, indent=1) + "\n")
    np.save(REPO / "tests/fixtures/flag_simplified_pool8.npy", pool8)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
