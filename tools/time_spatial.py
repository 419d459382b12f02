#!/usr/bin/env python3
"""Seconds per face256 tile, or per guided inet256 tile, with each tile's
rows split over processes (spatial partitioning,
ddnm_tpu_torch/parallel/spatial.py), against one process on one card.

The full-width face256 ADM of configs/hq/face256.yml (128 channels,
random weights from seed 1234, the layers its init zeroes drawn too so that
eps depends on the input; bf16 torso) restores one 256 px tile (4x
average-pooling SR, zero noise) through tiling.batched_tile_sample (one tile a data row) with
`--calls` model calls (a respacing of that many steps, no jumps). For each
layout DxS (`--layouts`, dp x sp) and spatial backend (`--backends`: auto
is NCCL where each rank of a group has its own card, gloo otherwise) the
tool starts D * S processes (gloo rendezvous on 127.0.0.1), one card a rank
where the machine has D * S cards, else all on cuda:0. Each rank builds the
model, shards it, runs one warm-up tile and then `--repeat` timed tiles
(synchronised card to synchronised card; the best is kept). A layout with
D > 1 restores D tiles at once (the data rows each take one): its seconds
per tile are the wall time over D. Also per model call: the rank's
launches of each kernel and its collectives by kind, and the host seconds
spent inside the collectives (the tool wraps SpatialGroup.all_gather with
a clock; the exchange and its host copies, not the kernels it waits
behind). Every rank's tile must be bit-equal to its group's others', and
each layout's to 1x1's within the bf16 rounding (printed, not gated).

`--loop` picks the samplers' drivers, timed one after the other in each
rank: "scan" (a rank's trajectory as one CUDA graph, its NCCL collectives
inside; what "auto" resolves to except on gloo on a card, where it is
"host" and "scan" is refused) and "host" (the eager loop). For each, a
third call runs under torch.profiler: the card's busy ms (the union of its
kernels' intervals, the NCCL kernels' among them and also apart) and the
idle share of that call's wall. The host seconds inside the collectives
are those of the host driver; a replay issues none.

`--model inet256_guided` times the guided call instead: the inet256 ADM of
configs/hq/inet256.yml (256 channels, class 951, random weights from seed
1234 with the zeroed layers drawn too) and its 54.1M classifier (the same
seed, dense), both bf16 and both sharded, guidance scale 1.0: each model
call is the UNet's forward and the classifier's forward and backward, the
backward's collectives counted apart (`BACKWARD_COLLECTIVES`).

    python3 tools/time_spatial.py [--model face256|inet256_guided]
        [--layouts 1x1 1x2] [--backends auto gloo] [--loop scan host]
        [--calls 20] [--repeat 2] [--out chiprun_out/time_spatial.json]

Prints one line per layout and, last, one JSON object (the card's name and
power limit beside the numbers). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

CONFIGS = {"face256": HERE / "configs" / "hq" / "face256.yml",
           "inet256_guided": HERE / "configs" / "hq" / "inet256.yml"}
GUIDED_CLASS = 951


def _tables(model: str, calls: int):
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables
    from ddnm_tpu_torch.schedules import named_beta_schedule

    conf = load_hq_config(CONFIGS[model])
    return build_posterior_tables(
        betas=named_beta_schedule(str(conf.noise_schedule), int(conf.diffusion_steps),
                                  use_scale=True),
        timestep_respacing=str(calls),
        schedule_jump_params=dict(t_T=calls, n_sample=1, jump_length=1, jump_n_sample=1))


def device_busy(prof, device: int) -> dict:
    """Busy ms of card `device` in a torch.profiler run: the union of its
    kernels' intervals (streams overlap), and the NCCL kernels' union apart
    (they wait for the other ranks on the card)."""
    spans, nccl = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or ev.device_index() != device:
            continue
        span = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        spans.append(span)
        if "nccl" in ev.name().lower():
            nccl.append(span)

    def union_ms(iv):
        total, end = 0, None
        for a, b in sorted(iv):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e6

    return {"busy_ms": union_ms(spans), "nccl_ms": union_ms(nccl), "device_events": len(spans)}


def profiled(fn, devices) -> dict:
    """One call of fn() under torch.profiler: its wall, each card's busy ms
    and the idle share of the cards over that wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        fn()
        for d in devices:
            torch.cuda.synchronize(d)
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = {str(d): device_busy(prof, torch.device(d).index) for d in devices}
    total = sum(b["busy_ms"] for b in busy.values())
    return {"profiled_wall_ms": wall_ms, "busy": busy,
            "idle_share": 1 - total / (wall_ms * len(devices)) if total else None}


def worker(model_name: str, dp: int, sp: int, backend: str, calls: int, repeat: int,
           out: Path, loops=("auto",)) -> None:
    """One rank: the timed tiles of this layout under each loop driver,
    written to `out`."""
    from ddnm_tpu_torch.sampling import graphs
    from ddnm_tpu_torch import ops
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.models import cast_torso, classifier_guidance_fn, shard_spatially
    from ddnm_tpu_torch.models.unet_adm import _ZERO_INIT, init_like_flax
    from ddnm_tpu_torch.parallel import multihost, spatial
    from ddnm_tpu_torch.tiling import batched_tile_sample
    from hq_main_torch import build_adm_from_hq, build_classifier_from_hq

    world = dp * sp
    grid = None
    if world > 1:
        multihost.maybe_init_distributed()
        rank = multihost.process_index()
        dev = torch.device("cuda", rank if torch.cuda.device_count() >= world else 0)
        torch.cuda.set_device(dev)
        grid = spatial.make_mesh_2d(dp, sp, device=dev,
                                    backend=None if backend == "auto" else backend)
    else:
        dev = torch.device("cuda", 0)
    conf = load_hq_config(CONFIGS[model_name])
    model = init_like_flax(build_adm_from_hq(conf, dev), 1234).eval()
    gen = torch.Generator(device=dev).manual_seed(1235)
    with torch.no_grad():  # the layers the init zeroes, drawn: eps then depends on x
        for name, mod in model.named_modules():
            if name.endswith(_ZERO_INIT) and hasattr(mod, "weight"):
                w = mod.weight
                w.normal_(0.0, 1.0 / w[0].numel() ** 0.5, generator=gen)
    model = cast_torso(model, torch.bfloat16)
    guidance_fn = clf = None
    if model_name == "inet256_guided":
        clf = build_classifier_from_hq(conf, dev)
        clf.zero_init = ()  # dense: every norm's and attention's backward carries signal
        clf = cast_torso(init_like_flax(clf, 1234).eval(), torch.bfloat16)
    mesh = None
    if grid is not None:
        if sp > 1:
            shard_spatially(model, grid.spatial)
            if clf is not None:
                shard_spatially(clf, grid.spatial)
        mesh = grid
    if clf is not None:
        guidance_fn = classifier_guidance_fn(clf, GUIDED_CLASS, float(conf.classifier_scale))

    def model_fn(x, t):
        if not model.num_classes:
            return model(x, t)
        return model(x, t, torch.full((x.shape[0],), GUIDED_CLASS, device=x.device))
    clock = {"seconds": 0.0}
    gather = spatial.SpatialGroup.all_gather

    def timed_gather(self, t, kind):
        t0 = time.perf_counter()
        parts = gather(self, t, kind)
        clock["seconds"] += time.perf_counter() - t0
        return parts

    spatial.SpatialGroup.all_gather = timed_gather
    tables = _tables(model_name, calls)
    rng = np.random.default_rng(0)
    gts = rng.uniform(-1, 1, (dp, 256, 256, 3)).astype(np.float32)
    zero = lambda gens, shape: torch.zeros(shape, device=dev)

    def run(loop):
        return batched_tile_sample(model_fn, gts, "sr_averagepooling", tables, 1234, scale=4,
                                   noise_fn=zero, guidance_fn=guidance_fn, device=dev,
                                   mesh=mesh, loop=loop)

    results = {}
    for loop in loops:
        # warm-up: cuDNN's plans, the allocator, the kernels' first launches;
        # under scan the capture (its seconds in the graph's stats)
        t0 = time.perf_counter()
        run(loop)
        torch.cuda.synchronize(dev)
        first = time.perf_counter() - t0
        stats = graphs.graph_stats()
        best = float("inf")
        for _ in range(repeat):
            ops.reset_launch_counts()
            spatial.reset_collective_counts()
            clock["seconds"] = 0.0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = run(loop)
            torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        launches = {**ops.launch_counts(), **ops.spatial_launch_counts()}
        collectives = {**spatial.COLLECTIVES, **spatial.BACKWARD_COLLECTIVES}
        host_seconds = clock["seconds"]
        results[loop] = {
            "seconds": best, "seconds_per_tile": best / dp, "first_call_seconds": first,
            "graphs": [{k: s[k] for k in ("warmup_s", "capture_s", "instantiate_s",
                                          "pool_bytes")} for s in stats],
            "launches_per_call": {k: v / calls for k, v in launches.items() if v},
            "collectives_per_call": {k: v / calls for k, v in collectives.items() if v},
            "collective_host_seconds_per_call": host_seconds / calls,
            "profile": profiled(lambda: run(loop), [dev]),
            "sha256": hashlib.sha256(res["final"].tobytes()).hexdigest(),
            "final": res["final"][0, ::8, ::8].tolist()}
        graphs.clear_graphs()
    out.write_text(json.dumps({
        "rank": multihost.process_index(), "device": str(dev),
        "backend": grid.spatial.backend if grid is not None and sp > 1 else None,
        "loops": results}))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_layout(model: str, dp: int, sp: int, backend: str, calls: int, repeat: int,
               tmp: Path, loops=("auto",)) -> list:
    """The D * S ranks of one layout, each timing `loops` in turn; their
    results in rank order."""
    world = dp * sp
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if world == 1:
            env = {k: v for k, v in env.items() if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                                              "MASTER_ADDR", "MASTER_PORT")}
        log = open(tmp / f"{dp}x{sp}_{backend}_{rank}.log", "w+")
        procs.append((log, subprocess.Popen(
            [sys.executable, __file__, "--worker", model, f"{dp}x{sp}", backend, str(calls),
             str(repeat), str(tmp / f"{dp}x{sp}_{backend}_{rank}.json"), ",".join(loops)],
            cwd=HERE, env=env,
            stdout=log, stderr=subprocess.STDOUT)))
    try:
        for log, proc in procs:
            if proc.wait(timeout=900) != 0:
                log.seek(0)
                raise RuntimeError(f"{dp}x{sp} {backend}: a rank exited {proc.returncode}: "
                                   f"{log.read()[-3000:]}")
    finally:
        for log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return [json.loads((tmp / f"{dp}x{sp}_{backend}_{r}.json").read_text())
            for r in range(world)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="face256", choices=sorted(CONFIGS))
    p.add_argument("--layouts", nargs="+", default=["1x1", "1x2"])
    p.add_argument("--backends", nargs="+", default=["auto"], choices=["auto", "nccl", "gloo"])
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--repeat", type=int, default=2)
    p.add_argument("--loop", nargs="+", default=["auto"], choices=["auto", "host", "scan"],
                   help="the loop drivers to time, in turn, in each rank")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--worker", nargs=7, default=None, help=argparse.SUPPRESS)
    ns = p.parse_args(argv)
    if ns.worker:
        model, layout, backend, calls, repeat, out, loops = ns.worker
        dp, sp = (int(v) for v in layout.split("x"))
        worker(model, dp, sp, backend, int(calls), int(repeat), Path(out), loops.split(","))
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("tools/time_spatial.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"{len(smi)} card(s): {smi[0]}", flush=True)
    results, base = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for layout in ns.layouts:
            dp, sp = (int(v) for v in layout.split("x"))
            if sp == 1 and dp > 1:
                raise ValueError(f"layout {layout}: a grid of processes needs sp > 1")
            for backend in (["auto"] if dp * sp == 1 else ns.backends):
                ranks = run_layout(ns.model, dp, sp, backend, ns.calls, ns.repeat, Path(tmp),
                                   ns.loop)
                for loop in ns.loop:
                    per = [r["loops"][loop] for r in ranks]
                    final = np.asarray(per[0].pop("final"))
                    for r in per[1:]:
                        r.pop("final")
                    groups_equal = all(
                        len({per[d * sp + s]["sha256"] for s in range(sp)}) == 1
                        for d in range(dp))
                    if loop not in base and dp * sp == 1:
                        base[loop] = final
                    diff = (None if loop not in base
                            else float(np.abs(final - base[loop]).max()))
                    r0 = per[0]
                    row = {"layout": layout, "dp": dp, "sp": sp, "loop": loop,
                           "backend": ranks[0]["backend"],
                           "devices": sorted({r["device"] for r in ranks}),
                           "seconds_per_tile": max(r["seconds_per_tile"] for r in per),
                           "first_call_seconds": max(r["first_call_seconds"] for r in per),
                           "calls": ns.calls, "graphs": r0["graphs"],
                           "launches_per_call": r0["launches_per_call"],
                           "collectives_per_call": r0["collectives_per_call"],
                           "collective_host_seconds_per_call":
                               r0["collective_host_seconds_per_call"],
                           "profile_per_rank": [r["profile"] for r in per],
                           "idle_share_max": max((r["profile"]["idle_share"] or 0.0)
                                                 for r in per),
                           "sha256": r0["sha256"],
                           "ranks_bit_equal_in_group": groups_equal,
                           "max_abs_vs_1x1_subsampled": diff}
                    results.append(row)
                    busy = r0["profile"]["busy"][ranks[0]["device"]]
                    print(f"{layout} {loop} ({row['backend']}, {row['devices']}): "
                          f"{row['seconds_per_tile']:.4f} s per tile, "
                          f"{row['seconds_per_tile'] / ns.calls * 1e3:.2f} ms per model call "
                          f"(first call {row['first_call_seconds']:.2f} s), "
                          f"{row['collective_host_seconds_per_call'] * 1e3:.2f} ms of host in "
                          f"collectives; rank 0 busy {busy['busy_ms']:.1f} ms (NCCL "
                          f"{busy['nccl_ms']:.1f}) of {r0['profile']['profiled_wall_ms']:.1f}, "
                          f"idle share {r0['profile']['idle_share']}; per call "
                          f"{row['launches_per_call']} launches, {row['collectives_per_call']} "
                          f"collectives; group bit-equal {groups_equal}; against 1x1 {diff}",
                          flush=True)
                    if not groups_equal:
                        raise AssertionError(f"{layout} {loop}: the ranks of a group disagree")
                if len(ns.loop) > 1:
                    shas = {loop: [r["loops"][loop]["sha256"] for r in ranks]
                            for loop in ns.loop}
                    same = len({tuple(v) for v in shas.values()}) == 1
                    print(f"{layout}: every rank's tile bit-equal across {ns.loop}: {same}",
                          flush=True)
                    results[-1]["bit_equal_across_loops"] = same
    summary = {"card": smi[0], "cards": len(smi), "model": ns.model, "model_calls": ns.calls,
               "layouts": results}
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
