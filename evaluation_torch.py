#!/usr/bin/env python
"""Evaluation sweep of the PyTorch/CUDA port (ddnm_tpu_torch): evaluation.py's
14 rows through main_torch.py.

The same task x dataset table as evaluation.py (CelebA-HQ noise-free x6,
CelebA-HQ noisy x2 with --add_noise, ImageNet noise-free x6 on the ADM
UNet of configs/imagenet_256.yml) and the same flags, plus --device (cuda
by default; without a card every row fails unless --device cpu is given)
and --dtype, passed to every row. Each row's average PSNR and rates go
into one JSON report, <out>/report.json. A row that fails is recorded with
its error and the sweep goes on; the sweep then exits non-zero. Every row
runs main_torch's default loop, "auto": each batch's trajectory one CUDA
graph (ddnm_tpu_torch/sampling/graphs.py), dropped when its row ends.

Usage:
  python evaluation_torch.py --ckpt-celeba tests/fixtures/flag_ddpm256.pt \\
      --random-init --dtype bfloat16 --exp exp -i eval_out
  python evaluation_torch.py --dry-run      # print the 14 rows' arguments
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from ddnm_tpu_torch.runtime import device_arg  # noqa: E402

# (name, config, deg, deg_scale, sigma_y, simplified, add_noise): a copy of
# evaluation.py's table (the reference's evaluation.sh)
CELEBA_RUNS = [
    ("celeba_sr_bicubic_4x", "celeba_hq.yml", "sr_bicubic", 4.0, 0.0, False, False),
    ("celeba_sr_ap_4x", "celeba_hq.yml", "sr_averagepooling", 4.0, 0.0, False, False),
    ("celeba_deblur_gauss", "celeba_hq.yml", "deblur_gauss", 4.0, 0.0, False, False),
    ("celeba_colorization", "celeba_hq.yml", "colorization", 4.0, 0.0, False, False),
    ("celeba_cs_wh_025", "celeba_hq.yml", "cs_walshhadamard", 0.25, 0.0, False, False),
    ("celeba_inpainting", "celeba_hq.yml", "inpainting", 4.0, 0.0, False, False),
    ("celeba_sr_ap_16x_noisy", "celeba_hq.yml", "sr_averagepooling", 16.0, 0.2, False, True),
    ("celeba_cs_wh_noisy", "celeba_hq.yml", "cs_walshhadamard", 0.25, 0.2, False, True),
]
IMAGENET_RUNS = [
    ("imagenet_sr_bicubic_4x", "imagenet_256.yml", "sr_bicubic", 4.0, 0.0, False, False),
    ("imagenet_sr_ap_4x", "imagenet_256.yml", "sr_averagepooling", 4.0, 0.0, False, False),
    ("imagenet_deblur_gauss", "imagenet_256.yml", "deblur_gauss", 4.0, 0.0, False, False),
    ("imagenet_colorization", "imagenet_256.yml", "colorization", 4.0, 0.0, False, False),
    ("imagenet_cs_wh_025", "imagenet_256.yml", "cs_walshhadamard", 0.25, 0.0, False, False),
    ("imagenet_inpainting", "imagenet_256.yml", "inpainting", 4.0, 0.0, False, False),
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DDNM evaluation sweep (PyTorch/CUDA port)")
    p.add_argument("--exp", type=str, default="exp")
    p.add_argument("-i", "--out", type=str, default="eval_out")
    p.add_argument("--ckpt-celeba", type=str, default=None)
    p.add_argument("--ckpt-imagenet", type=str, default=None)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="toy config + tiny fixture set (CI)")
    p.add_argument("--tasks", type=str, default=None,
                   help="comma-separated run-name filter substrings")
    p.add_argument("--datasets", type=str, default="celeba,imagenet")
    p.add_argument("--path-y-celeba", type=str, default="celeba_hq")
    p.add_argument("--path-y-imagenet", type=str, default="imagenet")
    p.add_argument("--config-celeba", type=str, default=None,
                   help="substitute config for the CelebA rows")
    p.add_argument("--config-imagenet", type=str, default=None,
                   help="substitute config for the ImageNet rows")
    p.add_argument("--mask_path", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--t-sampling", type=int, default=None,
                   help="override time_travel.T_sampling for every run")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default; rows fail without a card) or cpu")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="model torso dtype of every row")
    return p.parse_args(argv)


def row_argv(ns, row, ckpt, path_y) -> tuple[str, list[str]]:
    """(name, main_torch argv) of one row of the table."""
    name, config, deg, scale, sigma_y, simplified, noisy = row
    if ns.smoke:
        config = "smoke.yml"
    elif config == "celeba_hq.yml" and ns.config_celeba:
        config = ns.config_celeba
    elif config == "imagenet_256.yml" and ns.config_imagenet:
        config = ns.config_imagenet
    argv = ["--config", config, "--deg", deg, "--deg_scale", str(scale),
            "--sigma_y", str(sigma_y), "--exp", ns.exp, "--path_y", path_y,
            "-i", str(Path(ns.out) / name), "--ni"]
    if simplified:
        argv.append("--simplified")
    if noisy:
        argv.append("--add_noise")
    if deg in ("inpainting", "mask_color_sr") and ns.mask_path:
        argv += ["--mask_path", ns.mask_path]
    if ns.t_sampling is not None:
        argv += ["--t_sampling", str(ns.t_sampling)]
    if ckpt:
        argv += ["--ckpt", ckpt]
    elif ns.random_init:
        argv.append("--random_init")
    if ns.batch_size:
        argv += ["--batch_size", str(ns.batch_size)]
    if ns.max_images:
        argv += ["--max_images", str(ns.max_images)]
    return name, argv


def main(argv=None) -> dict:
    """Run the selected rows; returns {name: main_torch's stats or
    {"error": message}}. Raises SystemExit(1) after writing the report if
    any row failed."""
    ns = parse_args(argv)
    import main_torch

    runs = []
    if "celeba" in ns.datasets:
        runs += [(r, ns.ckpt_celeba, ns.path_y_celeba) for r in CELEBA_RUNS]
    if "imagenet" in ns.datasets:
        runs += [(r, ns.ckpt_imagenet, ns.path_y_imagenet) for r in IMAGENET_RUNS]
    if ns.tasks:
        keys = [t.strip() for t in ns.tasks.split(",")]
        runs = [r for r in runs if any(k in r[0][0] for k in keys)]

    report = {}
    for row, ckpt, path_y in runs:
        name, argv_run = row_argv(ns, row, ckpt, path_y)
        argv_run += ["--device", ns.device, "--dtype", ns.dtype]
        print(f"== {name}: main_torch.py {' '.join(argv_run)}", flush=True)
        if ns.dry_run:
            continue
        try:
            report[name] = main_torch.main(argv_run)
        except Exception as e:  # keep sweeping; the exit code reports it
            print(f"!! {name} failed: {type(e).__name__}: {e}", flush=True)
            report[name] = {"error": f"{type(e).__name__}: {e}"}

    # main_torch re-roots a relative -i under <exp>/image_samples: the
    # report goes into the same tree as the images
    out_root = Path(ns.out)
    if not out_root.is_absolute():
        out_root = Path(ns.exp) / "image_samples" / ns.out
    out_root.mkdir(parents=True, exist_ok=True)
    (out_root / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2), flush=True)
    failed = [name for name, r in report.items() if "error" in r]
    if failed:
        raise SystemExit(f"{len(failed)} of {len(report)} rows failed: {', '.join(failed)}")
    return report


if __name__ == "__main__":
    main()
