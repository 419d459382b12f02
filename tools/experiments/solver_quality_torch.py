"""Quality against model calls of the second-order multistep DDNM solver,
on the port (the PyTorch counterpart of
tools/experiments/solver_quality.py).

The trained golden fixtures (toy32: tests/fixtures/toy_ddpm32.pt on the
exp/datasets/toy32 blobs; mid64: tests/fixtures/mid_ddpm64.pt on
exp/datasets/natural64) through the DDIM sampler (eta 0.85, the reference
protocol) and the multistep solver at a sweep of step budgets, zero noise,
x_T = normal(PRNGKey(5)) (JAX's draw): restored-against-ground-truth PSNR
for simplified 4x average-pool SR and the SVD tasks sr_bicubic and
deblur_gauss. The fixtures load through the port's own loader
(data/checkpoints.py, data/io.py).

  python tools/experiments/solver_quality_torch.py [--tier toy32|mid64]
      [--images 4] [--nfe 6,10,15,25,50,100] [--device cuda|cpu]
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

from ddnm_tpu_torch import schedules as sch  # noqa: E402
from ddnm_tpu_torch.data.checkpoints import load_checkpoint  # noqa: E402
from ddnm_tpu_torch.data.io import read_rgb8  # noqa: E402
from ddnm_tpu_torch.models import DDPMUNet  # noqa: E402
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator  # noqa: E402
from ddnm_tpu_torch.sampling import build_schedule, sample_simplified, sample_svd  # noqa: E402
from ddnm_tpu_torch.sampling import threefry  # noqa: E402

# tier -> (DDPM fixture, eval folder, the trainer module holding its DDPM_KW)
TIERS = {
    "toy32": ("tests/fixtures/toy_ddpm32.pt", "exp/datasets/toy32", "train_toy_golden_torch"),
    "mid64": ("tests/fixtures/mid_ddpm64.pt", "exp/datasets/natural64",
              "train_mid_golden_torch"),
}
# (name, mode, deg, deg_scale): noise-free tasks of both modes
TASKS = [
    ("sr_ap_4x/simpl", "simplified", "sr_averagepooling", 4),
    ("sr_bicubic_4x/svd", "svd", "sr_bicubic", 4.0),
    ("deblur_gauss/svd", "svd", "deblur_gauss", 4.0),
]


def load_eval_images(folder, n: int) -> np.ndarray:
    """(n, H, W, 3) float32 in [-1, 1] of the first n PNGs of `folder`."""
    paths = sorted((REPO / folder).glob("*.png"))[:n]
    if not paths:
        raise FileNotFoundError(f"no eval images under {REPO / folder}")
    return np.stack([read_rgb8(p).astype(np.float32) / 255.0 for p in paths]) * 2.0 - 1.0


def load_ddpm(tier: str, device) -> DDPMUNet:
    import importlib

    fixture, _, trainer = TIERS[tier]
    model = DDPMUNet(**importlib.import_module(trainer).DDPM_KW)
    load_checkpoint(model, REPO / fixture)
    return model.to(device).eval().requires_grad_(False)


def psnr01(a01: np.ndarray, b01: np.ndarray) -> float:
    mse = float(np.mean((a01 - b01) ** 2))
    return 10.0 * float(np.log10(1.0 / max(mse, 1e-12)))


@torch.no_grad()
def run(model, gt: np.ndarray, mode: str, deg: str, deg_scale, solver: str, n_steps: int,
        x_init=None, device="cpu") -> np.ndarray:
    """One restoration of the NHWC batch `gt` ([-1, 1]): (N, H, W, 3) out,
    clipped to [0, 1]."""
    res = gt.shape[1]
    x_orig = torch.as_tensor(gt, device=device)
    if x_init is None:
        x_init = threefry.normal(threefry.prng_key(5), x_orig.shape)
    x_init = torch.as_tensor(x_init, device=device)
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=2e-2,
                                  num_diffusion_timesteps=1000)
    sched = build_schedule(betas=betas, t_sampling=n_steps)
    model_fn = lambda x, t: model(x, t)  # noqa: E731
    noise = lambda gens, shape: torch.zeros(shape, device=device)  # noqa: E731
    gens = [None] * len(x_orig)  # zero noise: nothing is drawn
    if mode == "simplified":
        op = build_functional_operator(deg, image_size=res, deg_scale=deg_scale, device=device)
        out, _ = sample_simplified(model_fn, x_init, op.A(x_orig), op, sched, gens, eta=0.85,
                                   sigma_y=0.0, noise_fn=noise, solver=solver)
    else:
        op = build_svd_operator(deg, image_size=res, deg_scale=deg_scale, device=device)
        x_vec = x_orig.permute(0, 3, 1, 2).reshape(len(x_orig), -1)
        out, _ = sample_svd(model_fn, x_init, op.A(x_vec), op, sched, gens, eta=0.85,
                            sigma_y=0.0, noise_fn=noise, solver=solver)
    return np.clip((out.float().cpu().numpy() + 1.0) / 2.0, 0.0, 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tier", choices=sorted(TIERS), default="toy32")
    ap.add_argument("--images", type=int, default=4)
    ap.add_argument("--nfe", type=str, default="6,10,15,25,50,100")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    dev = torch.device(ns.device)
    if dev.type == "cuda":  # the fp32 gates of the parity runs: no TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = load_ddpm(ns.tier, dev)
    gt = load_eval_images(TIERS[ns.tier][1], ns.images)
    gt01 = (gt + 1.0) / 2.0
    nfes = [int(s) for s in ns.nfe.split(",")]
    results = {}
    for name, mode, deg, scale in TASKS:
        rows = {}
        for solver in ("ddim", "multistep"):
            rows[solver] = {n: round(psnr01(run(model, gt, mode, deg, scale, solver, n,
                                                device=dev), gt01), 3) for n in nfes}
            print(f"# {name} {solver}: {rows[solver]}", flush=True)
        results[name] = rows

    header = "| task | solver | " + " | ".join(f"{n} steps" for n in nfes)
    print(f"\n{header} |")
    print("|" + "---|" * (len(nfes) + 2))
    for name, rows in results.items():
        for solver, vals in rows.items():
            print(f"| {name} | {solver} | " + " | ".join(f"{vals[n]:.2f}" for n in nfes) + " |")
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"tier": ns.tier, "nfe": nfes, "device": device, "results": results}))
    return results


if __name__ == "__main__":
    main()
