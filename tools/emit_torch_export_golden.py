#!/usr/bin/env python
"""JAX golden of the serving export's trajectories at toy scale, for the
PyTorch/CUDA port (ddnm_tpu_torch/serving.py) to be held against on the card
(chip_smoke.py phase 23(b), which has no JAX) and on the CPU
(tests/test_torch_serving.py).

Exports the two trajectory artifacts with the JAX package's own
ddnm_tpu/serving.py, calls them on the protocol's inputs and keys, and
writes their final images:

  - simplified: export_simplified_trajectory on tests/fixtures/toy_ddpm32.pt,
    4x average-pooling SR of the first 2 images of exp/datasets/toy32,
    x_init from RandomState(42) (NCHW, then NHWC), betas linear 1e-4 ..
    0.02 over 1000 steps, T_sampling 2 with one travel step (travel_length
    1, travel_repeat 2), eta 0.85, per-image keys PRNGKey(7) and PRNGKey(8);
  - posterior: export_posterior_trajectory with paste and ctx on
    tests/fixtures/toy_adm32.pt, the inpainting operator's context forms
    (a per-image keep-mask from RandomState(3) > 0.4), A+y of the same 2
    images, the Mask-Shift paste mask (RandomState(4) > 0.5) and content
    (RandomState(5) uniform in [-1, 1]), x_init from RandomState(7), the
    named linear 1000-step betas respaced to 2 with a jump schedule (t_T 2,
    jump_length 1, jump_n_sample 2: 3 model calls, 1 undo step), the same
    per-image keys.

Writes tests/fixtures/toy_export_golden.json: the protocol and, per run,
the final x (float32, NHWC, its shape and little-endian bytes in base64).

    JAX_PLATFORMS=cpu python tools/emit_torch_export_golden.py

About 10 s on the CPU. Imports JAX and the JAX package; it never runs on
the card.
"""

from __future__ import annotations

import base64
import json
import os
import sys
from pathlib import Path

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT = REPO / "tests" / "fixtures" / "toy_export_golden.json"

PROTOCOL = {
    "images": "exp/datasets/toy32, first 2, in [-1, 1], NHWC",
    "keys": "per image: jax.random.key_data(PRNGKey(7)), PRNGKey(8)",
    "dtype": "float32",
    "simplified": {
        "fixture": "tests/fixtures/toy_ddpm32.pt",
        "ddpm_kw": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                    "attn_resolutions": [16], "resolution": 32},
        "deg": "sr_averagepooling", "deg_scale": 4,
        "x_init_seed": 42,
        "betas": "linear 1e-4 .. 0.02, 1000 steps",
        "t_sampling": 2, "travel_length": 1, "travel_repeat": 2,
        "eta": 0.85, "sigma_y": 0.0,
    },
    "posterior": {
        "fixture": "tests/fixtures/toy_adm32.pt",
        "deg": "inpainting (A_ctx / Ap_ctx), mask of ones",
        "ctx_seed": 3, "ctx_keep_above": 0.4,
        "paste_mask_seed": 4, "paste_mask_above": 0.5,
        "paste_content_seed": 5,
        "x_init_seed": 7,
        "betas": "named linear, 1000 steps (use_scale)",
        "timestep_respacing": "2",
        "schedule_jump_params": {"t_T": 2, "n_sample": 1, "jump_length": 1,
                                 "jump_n_sample": 2},
        "clip_denoised": True,
    },
}


def encode(a) -> dict:
    """A float32 array as its shape and little-endian bytes in base64."""
    a = np.ascontiguousarray(np.asarray(a, "<f4"))
    return {"shape": list(a.shape), "f32_b64": base64.b64encode(a.tobytes()).decode()}


def decode(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["f32_b64"]), dtype="<f4").reshape(d["shape"])


def keys() -> np.ndarray:
    import jax

    return np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(s)))
                     for s in (7, 8)]).astype(np.uint32)


def images() -> np.ndarray:
    """The protocol's 2 ground-truth images in [-1, 1], NHWC."""
    from ddnm_tpu.data.io import load_image

    paths = sorted((REPO / "exp" / "datasets" / "toy32").glob("*.png"))[:2]
    return np.stack([load_image(p) for p in paths]).astype(np.float32) * 2.0 - 1.0


def nchw_to_nhwc(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def simplified_inputs(op_A) -> dict:
    """x_init, y of the simplified run (numpy; op_A the framework's A)."""
    p = PROTOCOL["simplified"]
    gt = images()
    x = np.random.RandomState(p["x_init_seed"]).randn(2, 3, 32, 32).astype(np.float32)
    return {"x_init": nchw_to_nhwc(x), "y": np.asarray(op_A(gt), np.float32)}


def posterior_inputs(op) -> dict:
    """x_init, apy, paste_mask, paste_content, op_ctx of the posterior run
    (numpy; `op` the framework's inpainting operator, its array type
    converted by the caller's `op.A_ctx` / `op.Ap_ctx`)."""
    p = PROTOCOL["posterior"]
    gt = images()
    ctx = (np.random.RandomState(p["ctx_seed"]).random((2, 32, 32, 1))
           > p["ctx_keep_above"]).astype(np.float32)
    paste_mask = (np.random.RandomState(p["paste_mask_seed"]).random((2, 32, 32, 1))
                  > p["paste_mask_above"]).astype(np.float32)
    paste_content = np.random.RandomState(p["paste_content_seed"]).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)
    x = np.random.RandomState(p["x_init_seed"]).randn(2, 3, 32, 32).astype(np.float32)
    apy = np.asarray(op.Ap_ctx(op.A_ctx(gt, ctx), ctx), np.float32)
    return {"x_init": nchw_to_nhwc(x), "apy": apy, "paste_mask": paste_mask,
            "paste_content": paste_content, "op_ctx": ctx}


def simplified_run() -> np.ndarray:
    import jax.numpy as jnp

    from ddnm_tpu import schedules as sch
    from ddnm_tpu.operators import build_functional_operator
    from ddnm_tpu.sampling import build_schedule
    from ddnm_tpu.serving import export_simplified_trajectory, load_exported
    from tests._golden import TOY32, load_our_model

    p = PROTOCOL["simplified"]
    fn, params = load_our_model(TOY32)
    op = build_functional_operator(p["deg"], image_size=32, deg_scale=p["deg_scale"])
    inp = simplified_inputs(lambda a: op.A(jnp.asarray(a)))
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000)
    sched = build_schedule(betas=betas, t_sampling=p["t_sampling"],
                           travel_length=p["travel_length"], travel_repeat=p["travel_repeat"])
    call = load_exported(export_simplified_trajectory(
        fn, params, op, sched, batch=2, image_size=32, y_shape=inp["y"].shape, eta=p["eta"],
        sigma_y=p["sigma_y"], per_image_keys=True))
    x, _ = call(params, inp["x_init"], inp["y"], keys())
    return np.asarray(x, np.float32)


def posterior_run() -> np.ndarray:
    import jax.numpy as jnp

    from ddnm_tpu import schedules as sch
    from ddnm_tpu.operators import build_functional_operator
    from ddnm_tpu.sampling.posterior import build_posterior_tables
    from ddnm_tpu.serving import export_posterior_trajectory, load_exported
    from tests._golden_adm import ADM_TOY32, load_our_model

    p = PROTOCOL["posterior"]
    fn, params = load_our_model(ADM_TOY32)
    op = build_functional_operator("inpainting", image_size=32,
                                   mask=np.ones((32, 32, 1), np.float32))
    inp = posterior_inputs(op)
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=p["timestep_respacing"],
        schedule_jump_params=p["schedule_jump_params"])
    call = load_exported(export_posterior_trajectory(
        fn, params, op, tables, batch=2, image_size=32, clip_denoised=p["clip_denoised"],
        with_paste=True, with_ctx=True, per_image_keys=True))
    x, _ = call(params, *(jnp.asarray(inp[k]) for k in
                          ("x_init", "apy", "paste_mask", "paste_content", "op_ctx")), keys())
    return np.asarray(x, np.float32)


def main() -> None:
    runs = {"simplified": encode(simplified_run()), "posterior": encode(posterior_run())}
    OUT.write_text(json.dumps({"protocol": PROTOCOL, "runs": runs}, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(REPO)} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
