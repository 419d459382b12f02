"""Quality against model calls of the posterior (hq / Mask-Shift)
multistep solver, on the port (the PyTorch counterpart of
tools/experiments/solver_posterior_quality.py).

Canvases of the natural family (data/synthetic.py `make_naturals`,
PRNGKey(42): JAX's images) at twice the fixture's resolution, restored with
the trained ADM fixture (toy32: tests/fixtures/toy_adm32.pt, mid64:
tests/fixtures/mid_adm64.pt) by `tiling.mask_shift_sample` with the tile
geometry scaled to the model (tile = res, stride = res / 2: the
reference's 2:1 ratio, a 3 x 3 grid of tiles on the default canvas), 4x
average-pool SR, zero noise. Rows: respacing budgets without time travel,
ddim against multistep, and the reference protocol's shape (respacing 25
+ jump 10 x 2) for both. The port draws its tile inits from the seed and
image index (its own generators), so its numbers are the port's: a
comparison with the JAX experiment holds the inits equal (`init_noise`).

  python tools/experiments/solver_posterior_quality_torch.py
      [--tier mid64|toy32] [--images 2] [--canvas N]
      [--nfe 6,10,15,25,50,100] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import importlib
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
from ddnm_tpu_torch import tiling  # noqa: E402
from ddnm_tpu_torch.data.checkpoints import load_checkpoint  # noqa: E402
from ddnm_tpu_torch.data.synthetic import make_naturals  # noqa: E402
from ddnm_tpu_torch.models import ADMUNet  # noqa: E402
from ddnm_tpu_torch.sampling import build_posterior_tables  # noqa: E402
from ddnm_tpu_torch.sampling.threefry import prng_key  # noqa: E402
from solver_quality_torch import psnr01  # noqa: E402

# tier -> (ADM fixture, the trainer module holding its ADM_KW)
TIERS = {"toy32": ("tests/fixtures/toy_adm32.pt", "train_toy_adm_golden_torch"),
         "mid64": ("tests/fixtures/mid_adm64.pt", "train_mid_golden_torch")}


def load_adm(tier: str, device) -> ADMUNet:
    fixture, trainer = TIERS[tier]
    path = REPO / fixture
    if not path.exists():
        raise SystemExit(f"{tier} ADM fixture not trained: {path}")
    model = ADMUNet(**importlib.import_module(trainer).ADM_KW)
    load_checkpoint(model, path)
    return model.to(device).eval().requires_grad_(False)


def respaced_tables(nfe: int):
    """Respacing `nfe` with no time travel."""
    return build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=str(nfe),
        schedule_jump_params=dict(t_T=nfe, n_sample=1, jump_length=1, jump_n_sample=1))


def jump_tables():
    """Respacing 25 + jump 25 / 10 x 2: the reference protocol's shape."""
    return build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing="25",
        schedule_jump_params=dict(t_T=25, n_sample=1, jump_length=10, jump_n_sample=2))


@torch.no_grad()
def restore(model, gt: np.ndarray, tables, solver: str, image_index: int, res: int,
            device="cpu", init_noise=None) -> np.ndarray:
    """One Mask-Shift 4x SR restoration of the (1, H, W, 3) canvas `gt`
    ([-1, 1]); the final canvas in [0, 1]."""
    out = tiling.mask_shift_sample(
        lambda x, t: model(x, t), gt, "sr_averagepooling", tables, 7, image_index=image_index,
        scale=4, noise_fn=lambda g, s: torch.zeros(s), solver=solver, tile=res,
        stride=res // 2, device=device, init_noise=init_noise)
    return np.clip((out["final"][0] + 1.0) / 2.0, 0.0, 1.0)


def mean_psnr(model, gts: np.ndarray, tables, solver: str, res: int, device) -> float:
    return float(np.mean([psnr01(restore(model, gts[i:i + 1], tables, solver, i, res, device),
                                 (gts[i] + 1.0) / 2.0) for i in range(len(gts))]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tier", choices=sorted(TIERS), default="mid64")
    ap.add_argument("--images", type=int, default=2)
    ap.add_argument("--canvas", type=int, default=None,
                    help="canvas size (default 2x the tile / model resolution)")
    ap.add_argument("--nfe", type=str, default="6,10,15,25,50,100")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    dev = torch.device(ns.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = load_adm(ns.tier, dev)
    res = model.image_size
    canvas = ns.canvas or 2 * res
    n_tiles = len(tiling.tile_grid(canvas, canvas, res, res // 2))
    print(f"# {ns.tier}: {canvas}px canvas, TILE={res} STRIDE={res // 2} -> {n_tiles} tiles",
          flush=True)
    gts = make_naturals(prng_key(42), ns.images, canvas).numpy()

    rows = []
    for nfe in [int(s) for s in ns.nfe.split(",")]:
        tables = respaced_tables(nfe)
        r = {"nfe": nfe, "schedule": "respacing",
             **{s: round(mean_psnr(model, gts, tables, s, res, dev), 2)
                for s in ("ddim", "multistep")}}
        rows.append(r)
        print(json.dumps(r), flush=True)
    tables = jump_tables()
    r = {"nfe": int(np.sum(~np.asarray(tables.is_travel))), "schedule": "respace25+jump10x2",
         **{s: round(mean_psnr(model, gts, tables, s, res, dev), 2)
            for s in ("ddim", "multistep")}}
    rows.append(r)
    print(json.dumps(r), flush=True)

    print("\n| NFE/tile | schedule | ddim PSNR | multistep PSNR |")
    print("|---|---|---|---|")
    for r in rows:
        print(f"| {r['nfe']} | {r['schedule']} | {r['ddim']} | {r['multistep']} |")
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"tier": ns.tier, "device": device, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
