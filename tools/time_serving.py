#!/usr/bin/env python3
"""The serving export at full width on one card: the flag DDPM's whole
simplified trajectory as one torch.export artifact (ddnm_tpu_torch/serving.py).

The main path's workload: configs/celeba_hq.yml's DDPM UNet with
tests/fixtures/flag_ddpm256.pt, bf16 torso, simplified DDNM+ 4x
average-pooling SR, eta 0.85, batch 8, 256 px, `--steps` steps (100 by
default, the main path's; no travel), one threefry key per image.
Measures, in this order:

  - export: seconds of torch.export tracing the unrolled trajectory, the
    graph's node count, and of torch.export.save, the artifact's bytes;
  - load: seconds of load_exported (torch.export.load and the module);
  - run: ms per trajectory through the artifact and through the eager
    sampler (sample_simplified with the same KeyNoise), each after one
    warm-up run, ms per step of each, the kernels' launches of one run of
    each (equal), max abs between the two finals.

    python3 tools/time_serving.py [--steps 100] [--out chiprun_out/time_serving.json]

The tracing runs on the host: its seconds are the host's, whatever the
card. Prints the card's `nvidia-smi` name and power limit, one line per
measurement and, last, one JSON object. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", type=str, default=None)
    ns = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("tools/time_serving.py needs a CUDA card")
    from ddnm_tpu_torch import ops, schedules, serving
    from ddnm_tpu_torch.models import DDPMUNet, cast_torso
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.runner import load_checkpoint
    from ddnm_tpu_torch.sampling import build_schedule, sample_simplified
    from ddnm_tpu_torch.sampling.threefry import KeyNoise

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    model = DDPMUNet(resolution=256)
    load_checkpoint(model, HERE / "tests" / "fixtures" / "flag_ddpm256.pt")
    model = cast_torso(model, torch.bfloat16).cuda().eval()
    op = build_functional_operator("sr_averagepooling", image_size=256, deg_scale=4,
                                   device="cuda")
    sched = build_schedule(betas=schedules.get_beta_schedule(
        "linear", beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=1000),
        t_sampling=ns.steps)
    b = ns.batch
    gen = torch.Generator(device="cuda").manual_seed(2323)
    x = torch.randn(b, 256, 256, 3, device="cuda", generator=gen)
    y = op.A(torch.rand(b, 256, 256, 3, device="cuda", generator=gen) * 2 - 1)
    keys = torch.tensor([[0, 100 + i] for i in range(b)], dtype=torch.int64, device="cuda")
    out = {"device": smi, "steps": ns.steps, "batch": b}

    mod = serving._SimplifiedTrajectory(model, op, sched, 0.85, 0.0)
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(mod.eval(), (x, y, keys))
    out["export_seconds"] = time.perf_counter() - t0
    out["graph_nodes"] = len(ep.graph.nodes)
    t0 = time.perf_counter()
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    out["save_seconds"] = time.perf_counter() - t0
    blob = buf.getvalue()
    out["artifact_bytes"] = len(blob)
    del ep, buf
    print(f"export {out['export_seconds']:.2f} s ({out['graph_nodes']} nodes), save "
          f"{out['save_seconds']:.2f} s, {len(blob)} bytes", flush=True)
    t0 = time.perf_counter()
    call = serving.load_exported(blob)
    out["load_seconds"] = time.perf_counter() - t0
    print(f"load {out['load_seconds']:.2f} s", flush=True)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, ops.launch_counts()

    with torch.no_grad():
        (xa, _), ms_a, la = timed(lambda: call(x, y, keys))
        (xe, _), ms_e, le = timed(lambda: sample_simplified(model, x, y, op, sched,
                                                            KeyNoise(keys)))
    out.update(ms_per_trajectory_artifact=ms_a, ms_per_trajectory_eager=ms_e,
               ms_per_step_artifact=ms_a / ns.steps, ms_per_step_eager=ms_e / ns.steps,
               launches_artifact=la, launches_eager=le,
               max_abs_artifact_vs_eager=float((xa - xe).abs().max()),
               bit_equal=bool(torch.equal(xa, xe)))
    print(f"run: artifact {ms_a:.1f} ms ({ms_a / ns.steps:.2f} per step), eager {ms_e:.1f} ms "
          f"({ms_e / ns.steps:.2f} per step); max abs {out['max_abs_artifact_vs_eager']:.3e}, "
          f"bit-equal {out['bit_equal']}; launches {la} / eager {le}", flush=True)
    if la != le:
        raise AssertionError(f"launches through the artifact {la} != eager {le}")
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
