#!/usr/bin/env python3
"""The two loop drivers of the PyTorch/CUDA port against each other on one
card: loop="host" (the eager loop) and loop="scan" (the trajectory as one
CUDA graph, ddnm_tpu_torch/sampling/graphs.py).

  - `--path main`: the main path's sampler, simplified DDNM+ 4x
    average-pooling SR on the 114M DDPM UNet of configs/celeba_hq.yml
    (tests/fixtures/flag_ddpm256.pt, bf16 torso), the 8 images of
    exp/datasets/celeba_hq, 100 steps, per-image generators;
  - `--path hq`: one 256 px tile of the hq path (the 553.8M ADM of
    configs/hq/inet256.yml, random weights from seed 1234, bf16, class 0,
    4x SR of exp/datasets/imagenet/00000.png) over the first `--calls`
    model calls of its jump schedule (the undo steps among them);
  - `--path guided`: the same tile guided by the 256 px classifier of
    configs/imagenet_256_cc.yml (`chip_smoke.cc_classifier`: bf16, random
    weights, every layer drawn; class 951, scale 1), cuDNN deterministic.

For each driver: ms a step (a model call) from the host clock around a
whole call that ends in a synchronize (the second call: the first warms up
or captures), the device busy time of a third call under torch.profiler
(device activity only), and the idle share of that call's wall and of the
second call's; for the scan driver also the first call's warm-up,
capture and instantiate seconds and the graph's memory pool in bytes.
The outputs of the two drivers must be bit-equal and their launch counts
equal. `measure(path)` is what chip_smoke.py phase 25(b) calls.

    python3 tools/time_loop_drivers.py [--path main hq guided] [--calls 50]

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


def main_path_call(batch: int = 8):
    """(call(loop) -> x_final, model calls a call) of the main path."""
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.data.datasets import get_dataset, iterate_batches
    from ddnm_tpu_torch.data.transforms import data_transform
    from ddnm_tpu_torch.models import DDPMUNet, cast_torso
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.runner import load_checkpoint
    from ddnm_tpu_torch.sampling import build_schedule, sample_simplified
    from ddnm_tpu_torch.sampling.rng import (STREAM_INIT, STREAM_SAMPLE, default_noise,
                                             image_generators)
    from ddnm_tpu_torch.schedules import get_beta_schedule

    cfg = load_config(REPO / "configs" / "celeba_hq.yml")
    model = DDPMUNet.from_config(cfg)
    load_checkpoint(model, REPO / "tests" / "fixtures" / "flag_ddpm256.pt")
    model = cast_torso(model.cuda().eval(), torch.bfloat16)
    size = cfg.data.image_size
    ds = get_dataset(cfg.data.dataset, root=REPO / "exp" / "datasets" / "celeba_hq",
                     image_size=size, out_of_dist=cfg.data.out_of_dist)
    imgs, _, _ = next(iterate_batches(ds, batch))
    op = build_functional_operator("sr_averagepooling", image_size=size, deg_scale=4.0,
                                   device="cuda")
    y = op.A(data_transform(torch.from_numpy(imgs).cuda()))
    x_init = default_noise(image_generators(0, range(batch), STREAM_INIT, "cuda"),
                           (batch, size, size, 3))
    d = cfg.diffusion
    sched = build_schedule(
        betas=get_beta_schedule(d.beta_schedule, beta_start=d.beta_start, beta_end=d.beta_end,
                                num_diffusion_timesteps=d.num_diffusion_timesteps
                                ).astype(np.float32),
        t_sampling=cfg.time_travel.T_sampling)

    def call(loop):
        gens = image_generators(0, range(batch), STREAM_SAMPLE, "cuda")
        return sample_simplified(model, x_init, y, op, sched, gens, loop=loop)[0]

    return call, int(np.sum(~sched.is_travel))


def hq_tile_call(calls: int, guided: bool):
    """(call(loop) -> x0_hat, model calls a call) of one inet256 tile over
    the first `calls` model calls of its schedule, guided or not."""
    import chip_smoke
    import hq_main_torch
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.models import cast_torso, classifier_guidance_fn
    from ddnm_tpu_torch.models.unet_adm import init_like_flax
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, sample_posterior
    from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, default_noise, image_generators
    from ddnm_tpu_torch.tiling import build_hq_operators

    conf = load_hq_config(REPO / "configs" / "hq" / "inet256.yml")
    model = init_like_flax(hq_main_torch.build_adm_from_hq(conf, "cuda"), 1234)
    model = cast_torso(model.eval(), torch.bfloat16)
    size = int(conf.image_size)
    labels = torch.zeros(1, dtype=torch.long, device="cuda")
    gt = torch.from_numpy(load_image(REPO / "exp" / "datasets" / "imagenet" / "00000.png"))
    gt = (gt * 2 - 1).cuda()[None]
    op, a_temp = build_hq_operators("sr_averagepooling", scale=4, gt_shape=(size, size),
                                    tile=size, device="cuda")
    apy = op.Ap(a_temp(gt))
    full = build_posterior_tables(
        betas=sch.named_beta_schedule(conf.noise_schedule, int(conf.diffusion_steps)),
        timestep_respacing=str(conf.timestep_respacing),
        schedule_jump_params=dict(conf.schedule_jump_params))
    normal = np.flatnonzero(~full.is_travel)
    hi = normal[min(calls, len(normal)) - 1] + 1
    tables = dataclasses.replace(full, t_cur=full.t_cur[:hi], is_travel=full.is_travel[:hi])
    guidance = (classifier_guidance_fn(chip_smoke.cc_classifier(), 951, 1.0) if guided
                else None)
    x_init = default_noise(image_generators(0, [0], STREAM_SAMPLE, "cuda"), (1, size, size, 3))
    zeros = torch.zeros(1, size, size, 1, device="cuda")
    model_fn = lambda x, t: model(x, t, labels)  # noqa: E731

    def call(loop):
        gens = image_generators(0, [0], STREAM_SAMPLE, "cuda")
        return sample_posterior(model_fn, x_init, apy, op, tables, gens, paste_mask=zeros,
                                paste_content=torch.zeros_like(apy), guidance_fn=guidance,
                                loop=loop)[1]

    return call, int(np.sum(~tables.is_travel))


def _timed(call, loop) -> tuple[torch.Tensor, float, dict]:
    from ddnm_tpu_torch import ops

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = call(loop)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ops.launch_counts()


def _profiled(call, loop, seconds: float) -> dict:
    """Device busy ms of one call under torch.profiler (its kernels' sum:
    they run on one stream), and the idle share of the profiled call's wall
    and of the unprofiled call's `seconds` (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(loop)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the raw device events (prof.events() would build ~70000 Python
    # objects a 100-step trajectory, tens of seconds)
    device = [ev for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(ev.duration_ns() for ev in device) / 1e6
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_events": len(device),
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "idle_share_unprofiled": (1 - busy_ms / (seconds * 1e3)) if busy_ms else None}


def measure(path: str, calls: int = 280) -> dict:
    """Both drivers on `path` (module docstring): the numbers and checks of
    one path as a dict; raises if the drivers' outputs or launches differ."""
    from ddnm_tpu_torch.sampling import graphs

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = path == "guided" or deterministic
    graphs.clear_graphs()
    try:
        if path == "main":
            call, steps = main_path_call()
        else:
            call, steps = hq_tile_call(calls, guided=path == "guided")
        out = {"path": path, "model_calls": steps}
        # host: a warm-up call (cuDNN's choices, the kernels' load), then timed
        _timed(call, "host")
        host_x, host_s, host_launches = _timed(call, "host")
        out["host"] = dict(ms_per_step=host_s / steps * 1e3, seconds=host_s,
                           **_profiled(call, "host", host_s))
        # scan: the first call warms up, captures, instantiates and replays
        first_x, first_s, first_launches = _timed(call, "scan")
        (stats,) = graphs.graph_stats()
        scan_x, scan_s, scan_launches = _timed(call, "scan")
        out["scan"] = dict(ms_per_step=scan_s / steps * 1e3, seconds=scan_s,
                           first_call_seconds=first_s, warmup_seconds=stats["warmup_s"],
                           capture_seconds=stats["capture_s"],
                           instantiate_seconds=stats["instantiate_s"],
                           pool_bytes=stats["pool_bytes"], **_profiled(call, "scan", scan_s))
        out["bit_equal"] = bool(torch.equal(host_x, first_x) and torch.equal(host_x, scan_x))
        out["launches_equal"] = host_launches == first_launches == scan_launches
        out["launches"] = {k: v for k, v in scan_launches.items() if v}
        if not (out["bit_equal"] and out["launches_equal"]):
            raise AssertionError(f"{path}: scan against host: bit-equal {out['bit_equal']}, "
                                 f"launches {host_launches} / {first_launches} / "
                                 f"{scan_launches}")
        return out
    finally:
        graphs.clear_graphs()
        torch.backends.cudnn.deterministic = deterministic


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", nargs="+", choices=["main", "hq", "guided"],
                    default=["main", "hq", "guided"])
    ap.add_argument("--calls", type=int, default=280,
                    help="hq and guided: model calls of the tile's schedule (280: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this measurement runs only on a card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    results = []
    for path in args.path:
        r = measure(path, args.calls)
        results.append(r)
        print(f"{path}: host {r['host']['ms_per_step']:.3f} ms a step (idle "
              f"{r['host']['idle_share']}), scan {r['scan']['ms_per_step']:.3f} ms (idle "
              f"{r['scan']['idle_share']}); capture {r['scan']['capture_seconds']:.3f} s, "
              f"instantiate {r['scan']['instantiate_seconds']:.3f} s, pool "
              f"{r['scan']['pool_bytes']} bytes; bit-equal {r['bit_equal']}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "torch": torch.__version__, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
