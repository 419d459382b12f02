#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's main path goes, on one card.

Runs a main path's sampler (the 114M DDPM UNet of configs/celeba_hq.yml
with tests/fixtures/flag_ddpm256.pt, bf16 torso, batch 8 from
exp/datasets/celeba_hq, sigma_y 0) for a window of steps of the 100-step
schedule: `--mode simplified` (default) is simplified DDNM+ 4x
average-pooling SR, `--mode svd` SVD-mode DDNM on 25% Walsh-Hadamard
compressed sensing (cs_walshhadamard, perm from the seed); with
`--encoder_cache N` the simplified sampler reuses the UNet's encoder
features (sampling/accel.py, uniform keys: a full forward every N-th step
of each window, the decoder half between). `--mode hq` is
the hq path of chip_smoke.py phase 10: the posterior sampler on one 256 px
tile (--batch tiles) of the 553.8M ADM UNet of configs/hq/inet256.yml
(random weights from seed 1234, bf16 torso, class 0), 4x average-pooling
SR of exp/datasets/imagenet/00000.png, on the config's jump schedule; its
"step" is a model call (the undo steps between the window's calls run
too). `--mode guidance` is chip_smoke.py phase 14's guidance call: the
forward and backward of the 256 px classifier of configs/imagenet_256_cc.yml
(`chip_smoke.cc_classifier`: bf16, random weights, every layer drawn) at
--batch images (8), t = 500, class 951; its "step" is one call. It reports:

  - ms per step (host clock around steps that end in a synchronize);
  - from torch.profiler over a second window: device time by kernel and by
    kind (the port's GroupNorm, attention and Walsh-Hadamard kernels,
    convolutions, other matrix products, elementwise, reductions, copies),
    device busy time (kernels run on one stream, so their sum) and the idle
    share of the window; the Walsh-Hadamard wrapper calls and kernel
    launches per step;
  - the chrome trace, written to --out.

    python3 tools/profile_torch_main_path.py --out <dir> [--steps 10] [--mode svd|hq|guidance]
        [--encoder_cache N]

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
    ("groupnorm (port)", ("gn_stats_affine_kernel", "gn_apply_kernel")),
    ("groupnorm backward (port)", ("gn_bwd_reduce_kernel", "gn_bwd_dx_kernel")),
    ("attention (port)", ("attn_mma_kernel", "attn_kernel")),
    ("attention backward (port)", ("attn_bwd_",)),
    ("fwht (port)", ("fwht_kernel",)),
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
    ap.add_argument("--batch", type=int, default=None,
                    help="images (8) or, with --mode hq, tiles (1)")
    ap.add_argument("--mode", choices=["simplified", "svd", "hq", "guidance"],
                    default="simplified")
    ap.add_argument("--encoder_cache", type=int, default=1,
                    help="--mode simplified: the encoder cache's interval (1: exact)")
    args = ap.parse_args(argv)
    if args.encoder_cache > 1 and args.mode != "simplified":
        raise SystemExit("--encoder_cache profiles the simplified mode only")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile runs only on a card")
    if args.batch is None:
        args.batch = 1 if args.mode == "hq" else 8

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    window = {"hq": hq_window, "guidance": guidance_window}.get(args.mode, ddpm_window)(args)
    window(0)  # warm-up: cuDNN algorithm choice, the kernels' build and load
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window(args.steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3
    return profile_window(args, window, step_ms, smi)


def hq_window(args):
    """window(start): the posterior sampler over the model calls start ..
    start + steps of the inet256 schedule (with the undo steps among
    them), on args.batch tiles."""
    import hq_main_torch
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.models import cast_torso
    from ddnm_tpu_torch.models.unet_adm import init_like_flax
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, sample_posterior
    from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, default_noise, image_generators
    from ddnm_tpu_torch.tiling import build_hq_operators

    conf = load_hq_config(REPO / "configs" / "hq" / "inet256.yml")
    model = init_like_flax(hq_main_torch.build_adm_from_hq(conf, "cuda"), 1234)
    model = cast_torso(model.eval(), torch.bfloat16)
    n, size = args.batch, int(conf.image_size)
    labels = torch.zeros(n, dtype=torch.long, device="cuda")
    gt = torch.from_numpy(load_image(REPO / "exp" / "datasets" / "imagenet" / "00000.png"))
    gt = (gt * 2 - 1).cuda()[None].expand(n, size, size, 3)
    op, a_temp = build_hq_operators("sr_averagepooling", scale=4, gt_shape=(size, size),
                                    tile=size, device="cuda")
    apy = op.Ap(a_temp(gt))
    full = build_posterior_tables(
        betas=sch.named_beta_schedule(conf.noise_schedule, int(conf.diffusion_steps)),
        timestep_respacing=str(conf.timestep_respacing),
        schedule_jump_params=dict(conf.schedule_jump_params))
    calls = np.flatnonzero(~full.is_travel)  # schedule positions of the model calls
    x_init = default_noise(image_generators(0, range(n), STREAM_SAMPLE, "cuda"),
                           (n, size, size, 3))
    zeros = torch.zeros(n, size, size, 1, device="cuda")

    def window(start: int):
        lo, hi = calls[start], calls[start + args.steps - 1] + 1
        tables = dataclasses.replace(full, t_cur=full.t_cur[lo:hi],
                                     is_travel=full.is_travel[lo:hi])
        return sample_posterior(lambda x, t: model(x, t, labels), x_init, apy, op, tables,
                                image_generators(0, range(n), STREAM_SAMPLE, "cuda"),
                                paste_mask=zeros, paste_content=torch.zeros_like(apy))

    return window


def guidance_window(args):
    """window(start): args.steps guidance calls (the same call each time)."""
    import chip_smoke
    from ddnm_tpu_torch.models import classifier_guidance_fn

    guide = classifier_guidance_fn(chip_smoke.cc_classifier(), 951, 1.0)
    g = torch.Generator("cuda").manual_seed(args.batch)
    x = torch.randn(args.batch, 256, 256, 3, device="cuda", generator=g)
    t = torch.full((args.batch,), 500.0, device="cuda")

    def window(start: int):
        for _ in range(args.steps):
            guide(x, t)

    return window


def ddpm_window(args):
    """window(start): the DDPM main path's sampler over steps start ..
    start + steps of the 100-step schedule."""
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
        if args.encoder_cache > 1:
            from ddnm_tpu_torch.sampling.accel import (ddpm_split_fns,
                                                       sample_simplified_encoder_prop)

            split = ddpm_split_fns(model)
            sample = lambda model, x, y, op, sched, gens: sample_simplified_encoder_prop(
                *split, x, y, op, sched, gens, interval=args.encoder_cache)
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

    return window


def profile_window(args, window, step_ms: float, smi: str) -> int:
    """torch.profiler over window(2 * steps): device time by kernel and kind,
    busy time and idle share, the chrome trace; prints the JSON summary."""
    from torch.profiler import ProfilerActivity, profile

    from ddnm_tpu_torch import ops

    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window(2 * args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"{args.mode}_trace.json"))

    calls = ops.launch_counts()
    by_kernel: dict[str, float] = {}
    runs: dict[str, int] = {}
    for ev in prof.events():  # device-side events: one per kernel run
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
            runs[ev.name] = runs.get(ev.name, 0) + 1
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
        "encoder_cache": args.encoder_cache,
        "profiled_window_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "ms_per_step_by_kind": {k: v / args.steps for k, v in
                                sorted(by_kind.items(), key=lambda kv: -kv[1])},
        # the swish passes left outside the GroupNorm kernel (the time
        # embedding's; the norms' run in the apply kernel's SiLU epilogue)
        "sigmoid_ms_per_step": sum(ms for name, ms in by_kernel.items()
                                   if "sigmoid" in name.lower()) / args.steps,
        # the Walsh-Hadamard transform: wrapper calls (ops.launch_counts) and
        # CUDA launches of its kernel per step (one launch a call)
        "fwht_calls_per_step": calls["fwht"] / args.steps,
        "fwht_kernel_launches_per_step": sum(n for name, n in runs.items()
                                             if "fwht_kernel" in name) / args.steps,
        # wrapper calls of every port kernel per step (per model call in hq mode)
        "port_calls_per_step": {k: v / args.steps for k, v in calls.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
