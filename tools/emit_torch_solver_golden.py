#!/usr/bin/env python
"""The JAX golden of the multistep solver and the encoder cache at toy
scale, for the PyTorch/CUDA port (ddnm_tpu_torch) to be held against on the
card (chip_smoke.py phase 15) and on the CPU (tests/test_torch_accel.py).

    JAX_PLATFORMS=cpu python tools/emit_torch_solver_golden.py

Imports JAX and the JAX package; it never runs on the card. Writes
tests/fixtures/toy_solver_golden.json: the protocol (PROTOCOL below: the
fixtures, images, x_T, schedules, operator, zero noise) and, per run, the
per-image PSNR (images clipped to [0, 1] against the ground truth), the
final x averaged over 8 x 8 pixels (model domain, unclipped, NHWC) and the
JAX CPU seconds. About 30 s on one CPU.

  toy_ddpm32.pt (the DDPM UNet of tests/_golden.py TOY32), 2 images of
  exp/datasets/toy32, 4x average-pooling SR, x_T from RandomState(42):
    ms_simplified_6 / _10   simplified multistep, 6 / 10 steps
    ms_svd_10               SVD multistep (the SVD operator), 10 steps
    ec3_uniform / _end_dense  simplified encoder cache, interval 3, 25
                            steps, eta 0.85, the uniform / end_dense keys
  toy_adm32.pt (the toy32 ADM UNet), a 64 x 64 Mask-Shift canvas (the
  first image of exp/datasets/natural64, 4x average-pooling SR), tiles of
  32 at stride 16 (3 x 3), the fresh order: tile (0, 0) from
  RandomState(7), every other tile from the pattern RandomState(3) (1, 32,
  32, 3) (the JAX tile init patched to it; the card's likewise):
    ms_maskshift_6          posterior multistep, respacing 6, no jumps
    ec3_maskshift           posterior encoder cache, interval 3, uniform
                            keys, respacing 25 with 10 x 2 undo jumps
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

OUT = REPO / "tests" / "fixtures" / "toy_solver_golden.json"

PROTOCOL = {
    "ddpm": {
        "fixture": "tests/fixtures/toy_ddpm32.pt",
        # the port's DDPMUNet arguments (tests/_torch_port.py port_arch)
        "ddpm_kw": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                    "attn_resolutions": [16], "resolution": 32},
        "eval_dir": "exp/datasets/toy32",
        "n_images": 2,
        "res": 32,
        "x_T_seed": 42,
        "betas": "linear 1e-4 .. 0.02, 1000 steps",
        "deg": "sr_averagepooling",
        "deg_scale": 4.0,
        "eta": 0.85,
        "noise": "zero",
    },
    "adm": {
        "fixture": "tests/fixtures/toy_adm32.pt",
        "gt": "exp/datasets/natural64 first PNG, 64 x 64",
        "deg": "sr_averagepooling",
        "scale": 4,
        "tile": 32,
        "stride": 16,
        "tile_init": "fresh",
        "first_init_seed": 7,
        "tile_pattern_seed": 3,
        "betas": "named linear 1000 (use_scale)",
        "noise": "zero",
    },
    "runs": {
        "ms_simplified_6": {"model": "ddpm", "mode": "simplified", "solver": "multistep",
                            "t_sampling": 6},
        "ms_simplified_10": {"model": "ddpm", "mode": "simplified", "solver": "multistep",
                             "t_sampling": 10},
        "ms_svd_10": {"model": "ddpm", "mode": "svd", "solver": "multistep", "t_sampling": 10},
        "ec3_uniform": {"model": "ddpm", "mode": "simplified", "encoder_cache": 3,
                        "policy": "uniform", "t_sampling": 25},
        "ec3_end_dense": {"model": "ddpm", "mode": "simplified", "encoder_cache": 3,
                          "policy": "end_dense", "t_sampling": 25},
        "ms_maskshift_6": {"model": "adm", "solver": "multistep", "timestep_respacing": "6",
                           "schedule_jump_params": {"t_T": 6, "n_sample": 1,
                                                    "jump_length": 1, "jump_n_sample": 1}},
        "ec3_maskshift": {"model": "adm", "encoder_cache": 3, "policy": "uniform",
                          "timestep_respacing": "25",
                          "schedule_jump_params": {"t_T": 25, "n_sample": 1,
                                                   "jump_length": 10, "jump_n_sample": 2}},
    },
    "pool8": "final x in [-1, 1] (unclipped), 8 x 8 average pool, NHWC",
    "psnr": "per image, clipped to [0, 1], against the ground truth",
}


def pool8(x):
    import numpy as np

    n, h, w, c = x.shape
    return x.reshape(n, h // 8, 8, w // 8, 8, c).mean(axis=(2, 4)).astype(np.float32)


def psnrs(x, gt):
    import numpy as np

    to01 = lambda a: np.clip((a + 1.0) / 2.0, 0.0, 1.0)
    return [float(10.0 * np.log10(1.0 / max(float(np.mean((to01(x[i]) - to01(gt[i])) ** 2)),
                                             1e-12))) for i in range(len(x))]


def ddpm_run(run: dict):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ddnm_tpu import schedules as sch
    from ddnm_tpu.operators import build_functional_operator
    from ddnm_tpu.sampling import accel, build_schedule, sample_simplified, sample_svd
    from tests._golden import TOY32, _trainer, build_our_operator, load_eval_images
    from tests._golden import load_our_model

    p = PROTOCOL["ddpm"]
    n, res = p["n_images"], p["res"]
    gt = np.ascontiguousarray(np.transpose(load_eval_images(n, TOY32), (0, 2, 3, 1)))
    xt = np.random.RandomState(p["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    xt = jnp.asarray(np.ascontiguousarray(xt.transpose(0, 2, 3, 1)))
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    sched = build_schedule(betas=betas, t_sampling=run["t_sampling"])
    fn, params = load_our_model(TOY32)
    zero = lambda key, shape: jnp.zeros(shape, jnp.float32)
    key = jax.random.PRNGKey(0)
    if run["mode"] == "svd":
        op = build_our_operator(p["deg"], p["deg_scale"], res=res)
        y = op.A(jnp.asarray(np.transpose(gt, (0, 3, 1, 2)).reshape(n, -1)))
        x, _ = sample_svd(fn, xt, y, op, sched, key, noise_fn=zero, params=params, loop="host",
                          solver=run["solver"])
        return np.asarray(x, np.float32), gt
    op = build_functional_operator(p["deg"], image_size=res, deg_scale=p["deg_scale"])
    y = op.A(jnp.asarray(gt))
    if "encoder_cache" in run:
        enc, dec = accel.ddpm_split_fns(_trainer(TOY32).build_model(dtype=jnp.float32))
        keys = accel.key_steps_for_policy(accel.n_model_calls(sched.is_travel),
                                          run["encoder_cache"], run["policy"])
        x, _ = accel.sample_simplified_encoder_prop(
            enc, dec, xt, y, op, sched, key, eta=p["eta"], interval=run["encoder_cache"],
            key_steps=keys, noise_fn=zero, params=params)
    else:
        x, _ = sample_simplified(fn, xt, y, op, sched, key, noise_fn=zero, params=params,
                                 loop="host", solver=run["solver"])
    return np.asarray(x, np.float32), gt


def adm_run(run: dict):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ddnm_tpu.tiling as jt
    from ddnm_tpu import schedules as sch
    from ddnm_tpu.data.io import load_image
    from ddnm_tpu.sampling import accel, build_posterior_tables
    from tests._golden_adm import ADM_TOY32, _mod, load_our_model

    p = PROTOCOL["adm"]
    img = load_image(sorted((REPO / "exp" / "datasets" / "natural64").glob("*.png"))[0])
    gt = (np.asarray(img, np.float32) * 2.0 - 1.0)[None]
    first = np.random.RandomState(p["first_init_seed"]).randn(1, 3, 32, 32).astype(np.float32)
    first = np.ascontiguousarray(first.transpose(0, 2, 3, 1))
    pattern = np.random.RandomState(p["tile_pattern_seed"]).randn(1, 32, 32, 3).astype(np.float32)
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=run["timestep_respacing"],
        schedule_jump_params=run["schedule_jump_params"])
    fn, params = load_our_model(ADM_TOY32)
    kw = {}
    if "encoder_cache" in run:
        model = getattr(_mod(ADM_TOY32.trainer_mod), ADM_TOY32.build_fn)(dtype=jnp.float32)
        kw["encode_fn"], kw["decode_fn"] = accel.adm_split_fns(model)
        kw.update(encoder_cache=run["encoder_cache"], encoder_cache_policy=run["policy"])
    else:
        kw["solver"] = run["solver"]
    real_normal, tile, stride = jax.random.normal, jt.TILE, jt.STRIDE
    jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.broadcast_to(
        jnp.asarray(pattern, dtype), shape)
    jt.TILE, jt.STRIDE = p["tile"], p["stride"]
    try:
        out = jt.mask_shift_sample(
            fn, gt, p["deg"], tables, jax.random.PRNGKey(0), scale=p["scale"], params=params,
            noise_fn=lambda key, shape: jnp.zeros(shape, jnp.float32), tile_init="fresh",
            init_noise=first, **kw)
    finally:
        jax.random.normal, jt.TILE, jt.STRIDE = real_normal, tile, stride
    return np.asarray(out["final"], np.float32), gt


def main() -> None:
    golden = {"protocol": PROTOCOL, "runs": {}}
    for name, run in PROTOCOL["runs"].items():
        t0 = time.perf_counter()
        x, gt = (ddpm_run if run["model"] == "ddpm" else adm_run)(run)
        secs = time.perf_counter() - t0
        golden["runs"][name] = {"per_image_psnr": psnrs(x, gt),
                                "pool8": pool8(x).round(6).tolist(),
                                "jax_cpu_seconds": round(secs, 1)}
        print(name, golden["runs"][name]["per_image_psnr"], f"{secs:.1f} s", flush=True)
    OUT.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(REPO)}")


if __name__ == "__main__":
    main()
