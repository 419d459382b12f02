#!/usr/bin/env python3
"""The runner's images/s end to end against in the sampler, on one card,
for this tree or another checkout of the repository (`--root`, e.g. a
parent commit unpacked with `git archive` into `_archive_check/`).

Runs main_torch.py in-process on the flag DDPM of configs/celeba_hq.yml
(tests/fixtures/flag_ddpm256.pt of this tree), bf16 torso, the 8 images of
exp/datasets/celeba_hq (or, with `--path_y celeba_hq_jpeg`, their JPEG
copies), sigma_y 0, the runs of chip_smoke.py phases 5, 7 and 16:

  simplified    simplified 4x average-pooling SR, 100 steps (phase 5)
  svd           SVD-mode 25% Walsh-Hadamard CS, 100 steps (phase 7)
  multistep_10  simplified, --solver multistep --t_sampling 10 (phase 16)
  exact_10      simplified, --t_sampling 10 (phase 16)
  cache_3       simplified, --encoder_cache 3 --encoder_cache_policy end_dense

after one warm-up run (exact_10, discarded). `--prefetch N` sets the
runner's decode-ahead depth (iterate_batches(prefetch=N); a tree whose
iterate_batches has no such argument refuses it); with `--batch_size 2`
the 8 images make 4 batches, so that decoding ahead overlaps sampling.

    python3 tools/time_runner_overlap.py [--root DIR] [--runs simplified,svd,...]
        [--batch_size 8] [--prefetch N] [--repeat 1] [--path_y celeba_hq]

Prints one line per run and, last, one JSON object. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
RUNS = {
    "simplified": ["--deg", "sr_averagepooling", "--deg_scale", "4", "--simplified"],
    "svd": ["--deg", "cs_walshhadamard", "--deg_scale", "0.25"],
    "multistep_10": ["--deg", "sr_averagepooling", "--deg_scale", "4", "--simplified",
                     "--solver", "multistep", "--t_sampling", "10"],
    "exact_10": ["--deg", "sr_averagepooling", "--deg_scale", "4", "--simplified",
                 "--t_sampling", "10"],
    "cache_3": ["--deg", "sr_averagepooling", "--deg_scale", "4", "--simplified",
                "--encoder_cache", "3", "--encoder_cache_policy", "end_dense"],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=str, default=str(HERE),
                    help="the checkout whose main_torch.py and ddnm_tpu_torch run")
    ap.add_argument("--runs", type=str, default=",".join(RUNS))
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--prefetch", type=int, default=None,
                    help="iterate_batches(prefetch=N) (default: the runner's own)")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--path_y", type=str, default="celeba_hq",
                    help="the folder of exp/datasets to restore (celeba_hq_jpeg: JPEG)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this timing runs only on a card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import main_torch
    import ddnm_tpu_torch.runner as runner_mod

    if not str(Path(main_torch.__file__).resolve()).startswith(str(root)):
        raise RuntimeError(f"main_torch imported from {main_torch.__file__}, not {root}")
    if args.prefetch is not None:
        runner_mod.iterate_batches = functools.partial(runner_mod.iterate_batches,
                                                       prefetch=args.prefetch)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    base = ["--config", str(HERE / "configs" / "celeba_hq.yml"),
            "--ckpt", str(HERE / "tests" / "fixtures" / "flag_ddpm256.pt"),
            "--exp", str(HERE / "exp"), "--path_y", args.path_y, "--sigma_y", "0",
            "--dtype", "bfloat16", "--batch_size", str(args.batch_size), "--ni",
            "--verbose", "warning"]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        main_torch.main(base + RUNS["exact_10"] + ["-i", str(Path(tmp) / "warm")])
        for rep in range(args.repeat):
            for name in args.runs.split(","):
                t0 = time.perf_counter()
                r = main_torch.main(base + RUNS[name] + ["-i", str(Path(tmp) / f"{name}{rep}")])
                r = dict(r, call_seconds=time.perf_counter() - t0,
                         sampler_images_per_second=r["num_samples"] / r["sample_seconds"])
                r["end_to_end_over_sampler"] = (r["images_per_second"]
                                                / r["sampler_images_per_second"])
                results.setdefault(name, []).append(r)
                print(f"{root.name} {args.path_y} {name:13s} batch {args.batch_size} prefetch "
                      f"{args.prefetch}: {r['images_per_second']:.4f} images/s end to end, "
                      f"{r['sampler_images_per_second']:.4f} in the sampler, ratio "
                      f"{r['end_to_end_over_sampler']:.3f}; wall {r['wall_seconds']:.3f} s, "
                      f"sampler {r['sample_seconds']:.3f} s, PSNR {r['avg_psnr']:.4f}",
                      flush=True)
    print(smi, flush=True)
    print(json.dumps({"root": str(root), "nvidia_smi": smi, "path_y": args.path_y,
                      "batch_size": args.batch_size,
                      "prefetch": args.prefetch, "runs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
