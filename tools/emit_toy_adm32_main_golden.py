#!/usr/bin/env python
"""JAX golden of the main runner on the ADM UNet, for the PyTorch/CUDA port
(ddnm_tpu_torch) to be held against.

Runs the six ImageNet rows of evaluation.py (SVD mode, sigma_y 0) through
the JAX package's own `Runner` (ddnm_tpu/runner.py: the model, operator and
dataset it builds from a config) on the trained toy ADM UNet
tests/fixtures/toy_adm32.pt, at 32 px, fp32, under the zero-noise protocol:

  - the config below ("openai", the fixture's architecture, dataset
    ImageNet: exp/datasets/toy32 through center_crop_arr), seed 1234 (the
    cs_walshhadamard permutation), the default exp/inp_masks/mask.npy
    nearest-resized to 32 px for inpainting;
  - the dataset's first 2 images;
  - a shared x_T from np.random.RandomState(42) (NCHW, then NHWC);
  - zero sampler noise, T_sampling 20, eta 0.85.

Writes tests/fixtures/toy_adm32_main_golden.json: the protocol and, per
task, the per-image PSNR of the clipped output against the ground truth.

    JAX_PLATFORMS=cpu python tools/emit_toy_adm32_main_golden.py

About a minute on the CPU. chip_smoke.py (phase 11, on the card) and
tests/test_torch_runner_adm.py (the port on the CPU, and two rows
recomputed with JAX) read the file.
"""

from __future__ import annotations

import copy
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT = REPO / "tests" / "fixtures" / "toy_adm32_main_golden.json"
PROTOCOL = {
    "fixture": "tests/fixtures/toy_adm32.pt",
    "eval_dir": "exp/datasets/toy32",
    "n_images": 2,
    "res": 32,
    "seed": 1234,
    "x_T_seed": 42,
    "eta": 0.85,
    "sigma_y": 0.0,
    "noise": "zero",
    "dtype": "float32",
    "mode": "svd",
    "psnr": "per image, clip((x + 1) / 2, 0, 1) against the ground truth",
    "config": {
        "data": {"dataset": "ImageNet", "image_size": 32, "channels": 3, "rescaled": True},
        "model": {"type": "openai", "num_channels": 32, "num_res_blocks": 1,
                  "num_heads": 4, "num_head_channels": 32, "attention_resolutions": "16",
                  "channel_mult": "1,2", "use_scale_shift_norm": True,
                  "resblock_updown": True, "learn_sigma": True, "class_cond": False},
        "diffusion": {"beta_schedule": "linear", "beta_start": 1.0e-4, "beta_end": 0.02,
                      "num_diffusion_timesteps": 1000},
        "time_travel": {"T_sampling": 20, "travel_length": 1, "travel_repeat": 1},
        "sampling": {"batch_size": 2},
    },
    # (name, deg, deg_scale): evaluation.py IMAGENET_RUNS
    "tasks": [
        ["imagenet_sr_bicubic_4x", "sr_bicubic", 4.0],
        ["imagenet_sr_ap_4x", "sr_averagepooling", 4.0],
        ["imagenet_deblur_gauss", "deblur_gauss", 4.0],
        ["imagenet_colorization", "colorization", 4.0],
        ["imagenet_cs_wh_025", "cs_walshhadamard", 0.25],
        ["imagenet_inpainting", "inpainting", 4.0],
    ],
}


def run_task(name: str, protocol: dict = PROTOCOL) -> list[float]:
    """Per-image PSNRs of one task through the JAX Runner's model, operator
    and dataset under the protocol."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ddnm_tpu.config import Config
    from ddnm_tpu.runner import RunArgs, Runner
    from ddnm_tpu.sampling import sample_svd

    p = protocol
    _, deg, deg_scale = next(t for t in p["tasks"] if t[0] == name)
    args = RunArgs(deg=deg, deg_scale=deg_scale, sigma_y=p["sigma_y"], eta=p["eta"],
                   seed=p["seed"], exp=str(REPO / "exp"), path_y=str(REPO / p["eval_dir"]),
                   ckpt=str(REPO / p["fixture"]))
    runner = Runner(args, Config.from_dict(copy.deepcopy(p["config"])))
    model_fn, _, params = runner.build_model(jax.random.PRNGKey(0))
    operator = runner.build_operator()
    dataset = runner.build_dataset()
    n, res = p["n_images"], p["res"]
    gt01 = np.stack([dataset[i][0] for i in range(n)])
    x_orig = gt01 * 2.0 - 1.0
    x_t = np.random.RandomState(p["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    x_t = np.ascontiguousarray(np.transpose(x_t, (0, 2, 3, 1)))
    y = operator.A(jnp.asarray(np.transpose(x_orig, (0, 3, 1, 2)).reshape(n, -1)))
    x, _ = sample_svd(model_fn, jnp.asarray(x_t), y, operator, runner.sched,
                      jax.random.PRNGKey(0), eta=p["eta"], sigma_y=p["sigma_y"],
                      noise_fn=lambda key, shape: jnp.zeros(shape, jnp.float32),
                      params=params, loop="host")
    x01 = np.clip((np.asarray(x, np.float32) + 1.0) / 2.0, 0.0, 1.0)
    mse = ((x01 - gt01) ** 2).reshape(n, -1).mean(axis=1)
    return [float(10.0 * np.log10(1.0 / m)) for m in mse]


def main() -> None:
    tasks = {}
    for name, _, _ in PROTOCOL["tasks"]:
        tasks[name] = {"per_image_psnr": run_task(name)}
        print(name, tasks[name], flush=True)
    OUT.write_text(json.dumps({"protocol": PROTOCOL, "tasks": tasks}, indent=2) + "\n")
    print(f"wrote {OUT.relative_to(REPO)}")


if __name__ == "__main__":
    main()
