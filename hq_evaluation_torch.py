#!/usr/bin/env python
"""hq qualitative demo sweep on the PyTorch/CUDA port (port of
hq_evaluation.py): the reference's hq_demo/evaluation.sh:3-17 as a harness
driving hq_main_torch.py. Five class-conditional arbitrary-size SR demos
(orange / bear / zebra at 4x, flamingo / kimono at 2x, all with
--resize_y), or with --face_sweep the face256 inpainting sweep over paired
gt / keep-mask trees.

    python hq_evaluation_torch.py --random-init [--demos orange,bear]
    python hq_evaluation_torch.py --face_sweep --random-init \\
        [--face_gt DIR --face_masks DIR] [--max_len N] [--sweep_batch N]

It takes hq_evaluation.py's flags and builds the same hq_main argv, with
`--device` (default cuda) added; without a card and without
`--device cpu` it raises before anything runs. Point --data at a folder
holding the demo images (orange.png, bear.png, flamingo.png, kimono.png,
zebra.png); a missing image is skipped with a note. --dry-run prints the
runs without running them. Use --random-init for a weights-free sweep.
Every run takes the samplers' default loop, "auto": each tile group's
trajectory one CUDA graph a group size (ddnm_tpu_torch/sampling/graphs.py).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from ddnm_tpu_torch.runtime import device_arg  # noqa: E402

# (name, class label, SR scale) — hq_demo/evaluation.sh
DEMOS = [
    ("orange", 950, 4),
    ("bear", 294, 4),
    ("flamingo", 130, 2),
    ("kimono", 614, 2),
    ("zebra", 340, 4),
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="hq Mask-Shift demo sweep (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, default="configs/hq/inet256.yml")
    p.add_argument("--data", type=str, default="exp/datasets/inet256")
    p.add_argument("-i", "--out", type=str, default="exp/hq_eval")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--classifier_ckpt", type=str, default=None)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--demos", type=str, default=None,
                   help="comma-separated demo-name filter")
    p.add_argument("--parallel_tiles", action="store_true")
    p.add_argument("--encoder_cache", type=int, default=1)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--face_sweep", action="store_true",
                   help="run the face256 inpainting dataset sweep "
                        "(hq_demo/confs/face256.yml eval dataset) instead of "
                        "the five SR demos")
    p.add_argument("--face_config", type=str, default="configs/hq/face256.yml")
    p.add_argument("--face_gt", type=str, default=None,
                   help="override the gt directory for --face_sweep "
                        "(default: the conf's data.eval entry)")
    p.add_argument("--face_masks", type=str, default=None)
    p.add_argument("--max_len", type=int, default=None)
    p.add_argument("--sweep_batch", type=int, default=1,
                   help="batch this many face-sweep images per sampler call "
                        "(hq_main_torch --sweep_batch; single-tile canvases only)")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (the default) needs a card and raises without one")
    return p.parse_args(argv)


def _model_args(ns) -> list[str]:
    """The weights, tiling, cache and dtype flags every run shares."""
    out = []
    if ns.ckpt:
        out += ["--ckpt", ns.ckpt]
    elif ns.random_init:
        out.append("--random_init")
    return out


def _tail_args(ns) -> list[str]:
    out = ["--parallel_tiles"] if ns.parallel_tiles else []
    if ns.encoder_cache > 1:
        out += ["--encoder_cache", str(ns.encoder_cache)]
    if ns.dtype != "float32":
        out += ["--dtype", ns.dtype]
    return out + ["--device", ns.device]


def runs(ns) -> list[tuple[str, list[str]]]:
    """(name, hq_main_torch argv) of each run: hq_evaluation.py's argv with
    --device added; the face sweep alone or the demos whose image exists."""
    if ns.face_sweep:
        argv = ["--config", ns.face_config, "--deg", "inpainting",
                "-i", str(Path(ns.out) / "face256")]
        if bool(ns.face_gt) != bool(ns.face_masks):
            # never default one to the other: masks as gts (or gts as masks)
            # would threshold photos into keep-masks
            raise SystemExit("--face_gt and --face_masks must be given together "
                             "(filename-paired trees); omit both to use the "
                             "conf's data.eval entry")
        if ns.face_gt:
            argv += ["--gt_path", ns.face_gt, "--mask_path_dir", ns.face_masks]
        if ns.max_len is not None:
            argv += ["--max_len", str(ns.max_len)]
        if ns.sweep_batch > 1:
            argv += ["--sweep_batch", str(ns.sweep_batch)]
        return [("face256", argv + _model_args(ns) + _tail_args(ns))]
    demos = DEMOS
    if ns.demos:
        keep = {d.strip() for d in ns.demos.split(",")}
        demos = [d for d in demos if d[0] in keep]
    out = []
    for name, cls, scale in demos:
        src = Path(ns.data) / f"{name}.png"
        if not src.exists():
            print(f"-- {name}: {src} missing, skipped")
            continue
        argv = ["--config", ns.config, "--deg", "sr_averagepooling",
                "--scale", str(scale), "--resize_y", "--path_y", str(src),
                "--class", str(cls), "-i", str(Path(ns.out) / name)] + _model_args(ns)
        if ns.classifier_ckpt:
            argv += ["--classifier_ckpt", ns.classifier_ckpt]
        out.append((name, argv + _tail_args(ns)))
    return out


def main(argv=None) -> dict:
    ns = parse_args(argv)
    from ddnm_tpu_torch.runtime import resolve_device

    resolve_device(ns.device)  # fail before anything runs
    import hq_main_torch

    results = {}
    for name, run_argv in runs(ns):
        label = "face256 sweep" if ns.face_sweep else name
        print(f"== {label}: hq_main_torch.py {' '.join(run_argv)}", flush=True)
        if not ns.dry_run:
            results[name] = hq_main_torch.main(run_argv)
    return results


if __name__ == "__main__":
    main()
