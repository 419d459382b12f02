#!/usr/bin/env python
"""JAX golden of classifier-guided hq restoration, for the PyTorch/CUDA port
(ddnm_tpu_torch) to be held against.

Runs the JAX side of the guided hq protocol (tests/_golden_adm.py
`run_hq_guided_task`, without its torch reference) on the trained toy
ADM UNet and toy classifier of two tiers, fp32:

  - toy32: tests/fixtures/toy_adm32.pt + toy_clf32.pt at 32 px;
  - mid64: tests/fixtures/mid_adm64.pt + mid_clf64.pt at 64 px;
  - the ground truth: 2 class-pure blob images of GUIDED_CLASS from
    `make_class_blobs(jax.random.PRNGKey(123), ...)`
    (tools/train_toy_classifier_golden.py), stored here because the port
    has no threefry to draw them;
  - x_T from np.random.RandomState(11) (NCHW, then NHWC), zero sampler
    noise, 4x average-pooling SR, respacing "25" with the jump schedule
    t_T 25 / jump_length 10 / jump_n_sample 2, guidance toward class 2
    with scale 2.0 (`classifier_guidance_fn`, jax.grad through the XLA
    GroupNorm and attention).

Writes tests/fixtures/toy_adm32_guided_golden.json: the protocol and, per
tier, the ground truth, the JAX output (float32 NHWC, little-endian,
base64) and the PSNR of the 2-image batch, which must reproduce the
`hq_guided_sr` rows of tests/fixtures/toy_adm32_psnr.json (43.1492) and
mid_adm64_psnr.json (49.0197) within REPRODUCE_DB; the script raises if it
does not.

    JAX_PLATFORMS=cpu python tools/emit_toy_adm32_guided_golden.py

About a minute on the CPU. chip_smoke.py (on the card) and
tests/test_torch_guidance.py (the port on the CPU) read the file.
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
sys.path.insert(0, str(REPO / "tools"))

OUT = REPO / "tests" / "fixtures" / "toy_adm32_guided_golden.json"
PROTOCOL = {
    "deg": "sr_averagepooling",
    "scale": 4,
    "n_images": 2,
    "gt": "make_class_blobs(jax.random.PRNGKey(123), 2, res, classes=guided_class)",
    "x_T_seed": 11,
    "noise": "zero",
    "timestep_respacing": "25",
    "schedule_jump_params": {"t_T": 25, "n_sample": 1, "jump_length": 10,
                             "jump_n_sample": 2},
    "guided_class": 2,
    "classifier_scale": 2.0,
    "dtype": "float32",
    "psnr": "of the batch, clip((x + 1) / 2, 0, 1) against the ground truth",
}
# how near the recorded hq_guided_sr PSNR a run must land: the rows were
# emitted by an earlier jax; jax 0.9.0 on the CPU gives 43.1489 for 43.1492
REPRODUCE_DB = 1e-3
TIERS = {
    "toy32": {"res": 32, "model": "tests/fixtures/toy_adm32.pt",
              "classifier": "tests/fixtures/toy_clf32.pt",
              "golden": "tests/fixtures/toy_adm32_psnr.json"},
    "mid64": {"res": 64, "model": "tests/fixtures/mid_adm64.pt",
              "classifier": "tests/fixtures/mid_clf64.pt",
              "golden": "tests/fixtures/mid_adm64_psnr.json"},
}


def encode(a: np.ndarray) -> dict:
    """A float32 array as its shape and little-endian bytes in base64."""
    a = np.ascontiguousarray(a, dtype="<f4")
    return {"shape": list(a.shape), "f32_b64": base64.b64encode(a.tobytes()).decode()}


def decode(d: dict) -> np.ndarray:
    """The inverse of `encode` (also used by the port's readers)."""
    return np.frombuffer(base64.b64decode(d["f32_b64"]), dtype="<f4").reshape(d["shape"])


def run_tier(name: str) -> dict:
    import jax
    import jax.numpy as jnp

    from ddnm_tpu import schedules as sch
    from ddnm_tpu.models.unet_adm import classifier_guidance_fn
    from ddnm_tpu.operators import build_functional_operator
    from ddnm_tpu.sampling.posterior import build_posterior_tables, sample_posterior
    from tests._golden_adm import ADM_TIERS, load_our_classifier, load_our_model
    from train_toy_classifier_golden import make_class_blobs

    tier, res, p = ADM_TIERS[name], TIERS[name]["res"], PROTOCOL
    gt, _ = make_class_blobs(jax.random.PRNGKey(123), p["n_images"], res,
                             classes=p["guided_class"])
    gt = np.asarray(gt, np.float32)  # NHWC in [-1, 1]
    x_t = np.random.RandomState(p["x_T_seed"]).randn(p["n_images"], 3, res, res)
    x_t = np.ascontiguousarray(x_t.astype(np.float32).transpose(0, 2, 3, 1))
    op = build_functional_operator(p["deg"], image_size=res, deg_scale=float(p["scale"]))
    model_fn_raw, mparams = load_our_model(tier)
    cmodel, cparams = load_our_classifier(tier)
    guidance = classifier_guidance_fn(
        cmodel.apply, jnp.full((p["n_images"],), p["guided_class"], jnp.int32),
        p["classifier_scale"])
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=p["timestep_respacing"], sigma_y=0.0,
        schedule_jump_params=p["schedule_jump_params"])
    x, _ = sample_posterior(
        lambda prm, z, t: model_fn_raw(prm["model"], z, t), jnp.asarray(x_t),
        op.Ap(op.A(jnp.asarray(gt))), op, tables, jax.random.PRNGKey(0),
        noise_fn=lambda key, shape: jnp.zeros(shape, jnp.float32),
        params={"model": mparams, "classifier": cparams}, guidance_fn=guidance)
    x = np.asarray(x, np.float32)
    to01 = lambda a: np.clip((a + 1.0) / 2.0, 0.0, 1.0)
    mse = float(np.mean((to01(x) - to01(gt)) ** 2))
    psnr = round(10.0 * float(np.log10(1.0 / max(mse, 1e-12))), 4)
    want = json.loads((REPO / TIERS[name]["golden"]).read_text())["hq_guided_sr"]["ours_psnr"]
    if abs(psnr - want) > REPRODUCE_DB:
        raise AssertionError(f"{name}: guided PSNR {psnr} does not reproduce {want}")
    return dict(TIERS[name], psnr=psnr, recorded_psnr=want, gt=encode(gt),
                jax_output=encode(x))


def main() -> None:
    out = {"protocol": PROTOCOL, "tiers": {}}
    for name in TIERS:
        out["tiers"][name] = run_tier(name)
        print(f"{name}: PSNR {out['tiers'][name]['psnr']}", flush=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
