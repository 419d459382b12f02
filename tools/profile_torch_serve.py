#!/usr/bin/env python3
"""The served main path under load, on one card: requests/s, latency and
the device's busy time and idle share (torch.profiler), through the HTTP
server and, for comparison, the same groups restored back to back without
it.

Builds chip_smoke.py phase 17's service (serve_torch.build_service: the
flag DDPM of configs/celeba_hq.yml with tests/fixtures/flag_ddpm256.pt,
bf16 torso, 4x average-pooling SR, max_batch 8, 100 steps), warms it up,
then:

  server  --requests N concurrent POST /restore?deg=sr_averagepooling&input=gt
          of the 8 images of exp/datasets/celeba_hq to a RestorationServer on
          127.0.0.1 (the worker's one-deep dispatch/fetch pipeline);
  direct  the same number of full groups through service.restore, one after
          another (launch, wait, launch).

Each is profiled over its whole window (CPU and CUDA activities): device
busy ms (the kernels' summed time; one stream), the window's wall ms and
the idle share 1 - busy / wall.

    python3 tools/profile_torch_serve.py [--requests 24] [--trace DIR]

Prints one line per mode and, last, one JSON object. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def busy_ms(prof) -> float:
    import torch

    return sum(ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--trace", type=str, default=None,
                    help="directory for the two Chrome traces (large)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import serve_torch
    from ddnm_tpu_torch.data.datasets import FolderDataset
    from ddnm_tpu_torch.data.io import encode_png

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile runs only on a card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    svc = serve_torch.build_service(serve_torch.parse_args(
        chip_smoke.SERVED_FLAGS + ["--degs", "sr_averagepooling", "--deg_scale", "4"]))
    svc.warmup()
    ds = FolderDataset(REPO / "exp" / "datasets" / "celeba_hq", 256)
    gts = [chip_smoke.to_u8(ds[i][0]) for i in range(len(ds))]
    calls = [("/restore?deg=sr_averagepooling&input=gt", encode_png(gts[i % len(gts)]))
             for i in range(args.requests)]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"nvidia_smi": smi, "requests": args.requests, "max_batch": svc.max_batch}

    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        load = chip_smoke.serve_load(svc, calls)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if [r[0] for r in load["replies"]] != [200] * args.requests:
        raise AssertionError("a served request failed")
    busy = busy_ms(prof)
    h = load["health"]
    out["server"] = {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
                     "requests_per_second": args.requests / load["wall"],
                     "groups": h["batches"], "mean_batch": h["mean_batch"],
                     "latency_s": h.get("latency_s")}
    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.trace) / "serve_trace.json"))

    groups = h["batches"]
    imgs = np.stack([g.astype(np.float32) / 255.0 for g in gts])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for k in range(groups):
            svc.restore(imgs, "sr_averagepooling", list(range(8 * k, 8 * k + 8)),
                        input_kind="gt")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof)
    out["direct"] = {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
                     "groups": groups, "images_per_second": 8 * groups / wall * 1e3}
    if args.trace:
        prof.export_chrome_trace(str(Path(args.trace) / "direct_trace.json"))
    for mode in ("server", "direct"):
        r = out[mode]
        print(f"{mode:6s}: {r['groups']} groups, wall {r['wall_ms']:.1f} ms, device busy "
              f"{r['device_busy_ms']:.1f} ms, idle share {r['idle_share']:.3f}", flush=True)
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
