#!/usr/bin/env python3
"""The sampler's images/s on one card against a data mesh and against one
process a card: which way of spreading a batch over cards pays.

Runs sample_simplified (4x average-pooling SR, eta 0.85) on the flag DDPM
of configs/celeba_hq.yml (tests/fixtures/flag_ddpm256.pt, bf16 torso),
`--steps` steps, random images, for each `--batch` B and mesh size m
(`--mesh`), in turns:

  single     one card, one stream, the whole batch on the caller's thread
  serial     a mesh of m (the first m cards where the machine has them,
             else cuda:0 m times) as ddnm_tpu_torch/parallel/mesh.py runs
             it: each shard's B/m images on a stream of their own, shard
             0's trajectory launched on the caller's thread, then shard
             1's, ...
  threads    the same shards each launched from a host thread of its own
             (a mesh of one entry a thread), the design mesh.py measured
             against and dropped
  processes  (`--processes`, where m cards exist) m processes, one a card,
             each running `single` at batch B on its own card at the same
             time: images/s of the node is the sum of theirs

`--loop` picks the samplers' drivers, each timed as its own run of the
above: "scan" (what "auto" resolves to: a trajectory as one CUDA graph, a
graph a shard on a mesh, replayed on the shard's stream) and "host" (the
eager loop). One more call of each run goes under torch.profiler: every
card's busy ms (the union of its kernels' intervals, streams overlapping)
and the idle share of the cards over that call's wall
(tools/time_spatial.py `profiled`).

Each call is timed from synchronised cards to synchronised cards, after one
warm-up call of each (under scan, the capture); the best of `--repeat`
rounds is kept. The mesh's
outputs are held against `single`'s (max |difference|: the shards' copies
between cards). The sampler is host-bound at batch 8 (PERF.md §5): a shard
of B/m images launches as much as the whole batch.

    python3 tools/time_data_parallel.py [--steps 20] [--repeat 3] \
        [--mesh 2 4] [--batch 8 32] [--loop scan host] [--processes]

Prints one line per call and, last, one JSON object. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from ddnm_tpu_torch import schedules as sch  # noqa: E402
from ddnm_tpu_torch.models import DDPMUNet, cast_torso  # noqa: E402
from ddnm_tpu_torch.operators import build_functional_operator  # noqa: E402
from ddnm_tpu_torch.parallel import make_mesh, replicate, sharded_sampler  # noqa: E402
from ddnm_tpu_torch.runner import load_checkpoint  # noqa: E402
from ddnm_tpu_torch.sampling import build_schedule, graphs, sample_simplified  # noqa: E402
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators  # noqa: E402
from time_spatial import profiled  # noqa: E402


def _threaded(mesh, model, op, x_init, y, sched, pool, loop):
    """The `threads` run: entry i's shard through a mesh of that entry
    alone, on a thread of `pool`; the outputs joined on the caller's card."""
    m, n = mesh.size, x_init.shape[0]
    k = n // m
    subs = [make_mesh(devices=[d]) for d in mesh.devices]
    reps = [(replicate(sub, model), replicate(sub, op)) for sub in subs]

    def run(gens):
        futs = [pool.submit(sharded_sampler(sample_simplified, sub), mod,
                            x_init[i * k:(i + 1) * k], y[i * k:(i + 1) * k], o, sched,
                            gens[i * k:(i + 1) * k], loop=loop)
                for i, (sub, (mod, o)) in enumerate(zip(subs, reps))]
        return torch.cat([f.result()[0] for f in futs]), None
    return run


def _setup(device: str, steps: int):
    model = DDPMUNet(resolution=256)
    load_checkpoint(model, HERE / "tests" / "fixtures" / "flag_ddpm256.pt")
    model = cast_torso(model.to(device).eval().requires_grad_(False), torch.bfloat16)
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000)
    sched = build_schedule(betas=betas, t_sampling=steps)
    op = build_functional_operator("sr_averagepooling", image_size=256, deg_scale=4,
                                   device=device)
    return model, sched, op


def _inputs(batch: int, op, device: str):
    gen = torch.Generator(device=device).manual_seed(batch)
    x_init = torch.randn((batch, 256, 256, 3), generator=gen, device=device)
    y = op.A(torch.rand((batch, 256, 256, 3), generator=gen, device=device) * 2 - 1)
    return x_init, y


def _timer(devices, batch: int, device: str):
    def timed(fn):
        gens = image_generators(0, range(batch), STREAM_SAMPLE, device)
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        out = fn(gens)
        for d in devices:
            torch.cuda.synchronize(d)
        return time.perf_counter() - t0, out[0]
    return timed


def child(ns) -> int:
    """One process of `processes`: `single` at each batch on `--device`."""
    model, sched, op = _setup(ns.device, ns.steps)
    best = {}
    for batch in ns.batch:
        x_init, y = _inputs(batch, op, ns.device)
        timed = _timer({torch.device(ns.device)}, batch, ns.device)
        run = lambda g: sample_simplified(model, x_init, y, op, sched, g, loop=ns.loop[0])
        timed(run)
        best[batch] = min(timed(run)[0] for _ in range(ns.repeat))
    print(json.dumps({"device": ns.device, "best_seconds": best}), flush=True)
    return 0


def processes(ns, m: int) -> dict:
    """`child` on cards 0..m-1 at once; each one's best seconds per batch."""
    argv = [sys.executable, str(Path(__file__).resolve()), "--child", "--steps", str(ns.steps),
            "--repeat", str(ns.repeat), "--batch", *map(str, ns.batch), "--loop", ns.loop[0]]
    procs = [subprocess.Popen(argv + ["--device", f"cuda:{i}"], stdout=subprocess.PIPE,
                              text=True, cwd=HERE, env=dict(os.environ))
             for i in range(m)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise RuntimeError(f"a timing process exited {p.returncode}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {batch: [o["best_seconds"][str(batch)] for o in outs] for batch in ns.batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--mesh", type=int, nargs="+", default=[2])
    ap.add_argument("--batch", type=int, nargs="+", default=[8])
    ap.add_argument("--loop", nargs="+", default=["auto"], choices=["auto", "host", "scan"])
    ap.add_argument("--processes", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda:0", help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool times the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if ns.child:
        return child(ns)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip()
    print(smi, flush=True)

    model, sched, op = _setup("cuda:0", ns.steps)
    count = torch.cuda.device_count()
    meshes = {}
    for m in ns.mesh:
        mesh = make_mesh(devices=[f"cuda:{i}" for i in range(m)] if count >= m
                         else ["cuda:0"] * m)
        meshes[m] = (mesh, replicate(mesh, model), replicate(mesh, op))
    pool = ThreadPoolExecutor(max_workers=max(ns.mesh), thread_name_prefix="shard")
    every = {torch.device(f"cuda:{i}") for i in range(min(count, max(ns.mesh)))}
    results = []
    for batch in ns.batch:
        x_init, y = _inputs(batch, op, "cuda:0")
        timed = _timer(every, batch, "cuda:0")
        runs = {}
        for loop in ns.loop:
            runs[f"single_{loop}"] = (lambda g, loop=loop: sample_simplified(
                model, x_init, y, op, sched, g, loop=loop))
            for m, (mesh, models, ops_) in meshes.items():
                if batch % m:
                    continue
                runs[f"threads{m}_{loop}"] = _threaded(mesh, model, op, x_init, y, sched, pool,
                                                       loop)
                runs[f"serial{m}_{loop}"] = (lambda g, mesh=mesh, models=models, ops_=ops_,
                                             loop=loop: sharded_sampler(sample_simplified, mesh)(
                                                 models, x_init, y, ops_, sched, g, loop=loop))
        base = f"single_{ns.loop[0]}"
        outs = {name: timed(run)[1] for name, run in runs.items()}  # warm-up, captures
        diff = {name: float((o.float() - outs[base].float()).abs().max())
                for name, o in outs.items() if name != base}
        best = {name: float("inf") for name in runs}
        for r in range(ns.repeat):
            for name, run in runs.items():
                secs = timed(run)[0]
                best[name] = min(best[name], secs)
                print(f"batch {batch} round {r} {name:14s}: {secs:.4f} s, {batch / secs:.4f} "
                      f"images/s in the sampler ({ns.steps} steps)", flush=True)
        gens = lambda: image_generators(0, range(batch), STREAM_SAMPLE, "cuda:0")  # noqa: E731
        prof = {name: profiled(lambda run=run: run(gens()), sorted(every, key=str))
                for name, run in runs.items()}
        for name, p in prof.items():
            print(f"batch {batch} {name:14s}: profiled {p['profiled_wall_ms']:.1f} ms, busy "
                  f"{ {d: round(b['busy_ms'], 1) for d, b in p['busy'].items()} } ms, idle share "
                  f"{p['idle_share']}", flush=True)
        results.append({"batch": batch, "best_seconds": best,
                        "images_per_second": {k: batch / v for k, v in best.items()},
                        "over_single": {k: best[base] / v for k, v in best.items()},
                        "max_abs_diff_vs_single": diff, "profiled": prof})
        print(json.dumps({k: v for k, v in results[-1].items() if k != "profiled"}), flush=True)
        graphs.clear_graphs()
    pool.shutdown()
    procs = {}
    if ns.processes:
        del meshes, model  # the processes load their own
        torch.cuda.empty_cache()
        for m in ns.mesh:
            if count < m:
                continue
            per = processes(ns, m)
            procs[m] = {batch: {"best_seconds": secs,
                                "node_images_per_second": sum(batch / s for s in secs)}
                        for batch, secs in per.items()}
            for batch, v in procs[m].items():
                print(f"batch {batch} processes{m}: best {v['best_seconds']} s, node "
                      f"{v['node_images_per_second']:.4f} images/s", flush=True)
    out = {"card": smi, "device_count": count, "steps": ns.steps, "results": results,
           "processes": procs}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
