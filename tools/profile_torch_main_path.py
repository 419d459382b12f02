#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main path goes, on one card.

Runs a main path's sampler (the 114M DDPM UNet of configs/celeba_hq.yml
with tests/fixtures/flag_ddpm256.pt, bf16 torso, batch 8 from
exp/datasets/celeba_hq, sigma_y 0) for a window of steps of the 100-step
schedule: `--mode simplified` (default) is simplified DDNM+ 4x
average-pooling SR, `--mode svd` SVD-mode DDNM on 25% Walsh-Hadamard
compressed sensing (cs_walshhadamard, perm from the seed). It reports:

  - ms per step (host clock around steps that end in a synchronize);
  - from torch.profiler over a second window: device time by kernel and by
    kind (the port's GroupNorm and attention kernels, convolutions, other
    matrix products, elementwise, reductions, copies), device busy time
    (kernels run on one stream, so their sum) and the idle share of the
    window;
  - the chrome trace, written to --out.

    python3 tools/profile_torch_main_path.py --out <dir> [--steps 10] [--mode svd]

Prints one JSON object as its last line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

KINDS = (  # first match wins; matched against the lower-cased kernel name
    ("groupnorm (port)", ("gn_stats_kernel", "gn_finalize_kernel", "gn_apply_kernel")),
    ("attention (port)", ("attn_kernel",)),
    ("fwht (port)", ("fwht_rows_kernel", "fwht_cols_kernel")),
    ("gather", ("index",)),
    ("convolution", ("conv", "cudnn", "implicit", "fprop", "dgrad", "winograd")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet", "xmma", "sm90_")),
    ("reduction", ("reduce",)),
    ("copy / layout", ("copy", "transpose", "cat", "pad", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="directory for the chrome trace")
    ap.add_argument("--steps", type=int, default=10, help="steps per window")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mode", choices=["simplified", "svd"], default="simplified")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile runs only on a card")

    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.data.datasets import get_dataset, iterate_batches
    from ddnm_tpu_torch.data.transforms import data_transform
    from ddnm_tpu_torch.models import DDPMUNet, cast_torso
    from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
    from ddnm_tpu_torch.runner import load_checkpoint
    from ddnm_tpu_torch.sampling import build_schedule, sample_simplified, sample_svd
    from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec
    from ddnm_tpu_torch.sampling.rng import (STREAM_INIT, STREAM_SAMPLE, default_noise,
                                             image_generators)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = load_config(REPO / "configs" / "celeba_hq.yml")
    model = DDPMUNet.from_config(cfg)
    load_checkpoint(model, REPO / "tests" / "fixtures" / "flag_ddpm256.pt")
    model = cast_torso(model.cuda().eval(), torch.bfloat16)
    size = cfg.data.image_size
    ds = get_dataset(cfg.data.dataset, root=REPO / "exp" / "datasets" / "celeba_hq",
                     image_size=size, out_of_dist=cfg.data.out_of_dist)
    imgs, _, _ = next(iterate_batches(ds, args.batch))
    x_orig = data_transform(torch.from_numpy(imgs).cuda())
    if args.mode == "svd":
        op = build_svd_operator("cs_walshhadamard", image_size=size, deg_scale=0.25,
                                device="cuda")
        y, sample = op.A(_nhwc_to_vec(x_orig)), sample_svd
    else:
        op = build_functional_operator("sr_averagepooling", image_size=size, deg_scale=4.0,
                                       device="cuda")
        y, sample = op.A(x_orig), sample_simplified
    idxs = range(args.batch)
    x_init = default_noise(image_generators(0, idxs, STREAM_INIT, "cuda"),
                           (args.batch, size, size, 3))
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    full = build_schedule(betas=betas, t_sampling=cfg.time_travel.T_sampling)

    def window(start: int):
        sched = dataclasses.replace(
            full, t_cur=full.t_cur[start:start + args.steps],
            t_next=full.t_next[start:start + args.steps],
            is_travel=full.is_travel[start:start + args.steps])
        return sample(model, x_init, y, op, sched,
                      image_generators(0, idxs, STREAM_SAMPLE, "cuda"))

    window(0)  # warm-up: cuDNN algorithm choice, the kernels' build and load
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window(args.steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window(2 * args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"{args.mode}_trace.json"))

    by_kernel: dict[str, float] = {}
    for ev in prof.events():  # device-side events: one per kernel run
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_kernel.values())
    by_kind: dict[str, float] = {}
    for name, ms in by_kernel.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    for name, ms in top:
        print(f"{ms / args.steps:9.4f} ms/step  {kind_of(name):18s} {name[:110]}", flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "mode": args.mode, "batch": args.batch, "steps": args.steps, "step_ms": step_ms,
        "profiled_window_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "ms_per_step_by_kind": {k: v / args.steps for k, v in
                                sorted(by_kind.items(), key=lambda kv: -kv[1])},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
