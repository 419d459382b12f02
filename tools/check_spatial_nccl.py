#!/usr/bin/env python3
"""Spatial partitioning (`--sp`) across separate cards over NCCL, held to
the JAX goldens and to the same layout with every rank on one card.

Needs four cards (one a rank):
  (a) the toy32 hq golden (hq_sr_ap_4x, toy_adm32.pt) and the toy32
      guided golden (toy_adm32.pt guided by toy_clf32.pt), fp32 with TF32
      off, at sp 2 (ranks on cuda:0, cuda:1) and at dp 2 x sp 2 (the batch
      of 2 over the data rows through parallel.grid_sampler, each image's
      rows over a pair of cards): every rank's spatial group is NCCL, each
      PSNR within 0.01 dB of the JAX package's, every rank's gathered
      finals bit-equal; under each loop driver of `--loop` in turn in each
      rank ("scan": the rank's trajectory as one CUDA graph, the NCCL
      collectives captured inside it; "host": the eager loop), every
      rank's scan final bit-equal to its host final (the guided runs with
      cuDNN's deterministic engines), and the collectives counted equal
      under both;
  (b) tools/time_spatial.py's bf16 face256 tile at sp 2 with the ranks on
      two cards (NCCL) against sp 2 with both ranks on cuda:0 (gloo), the
      protocol of chip_smoke.py phase 21: SHA-256 of the finals and max
      |diff| of their subsample.

    python3 tools/check_spatial_nccl.py [--loop host scan] [--calls 20]
        [--out FILE.json]
    python3 tools/check_spatial_nccl.py --cpu   # (a) as 2 and 4 CPU processes over gloo

Prints a line per run, the card's name and power limit, and last one JSON
object. Exits 1 if a gate of (a) fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))


def worker(kind: str, dp: int, sp: int, out: Path, device: str, loops: list) -> None:
    """One rank of (a): its card is cuda:<rank>, its spatial group NCCL
    (device "cpu": the CPU and gloo); the golden under each of `loops`."""
    import functools

    import chip_smoke as cs
    from ddnm_tpu_torch.models import shard_spatially
    from ddnm_tpu_torch.parallel import (BACKWARD_COLLECTIVES, COLLECTIVES, grid_sampler,
                                         make_mesh_2d, multihost, reset_collective_counts)
    from ddnm_tpu_torch.sampling import graphs
    from ddnm_tpu_torch.sampling.posterior import sample_posterior

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the classifier's backward takes cuDNN's deterministic engines, so that
    # the guided runs under the two drivers can be held bit for bit (as
    # tools/time_loop_drivers.py does on one card)
    torch.backends.cudnn.deterministic = kind != "golden"
    if device == "cpu":
        torch.set_num_threads(1)  # 2-4 ranks share the host's cores
    multihost.maybe_init_distributed()
    rank = multihost.process_index()
    dev = "cpu" if device == "cpu" else f"cuda:{rank}"
    grid = make_mesh_2d(dp, sp, device=dev, backend="gloo" if device == "cpu" else "nccl")
    model = shard_spatially(cs.toy_adm(dev), grid.spatial)
    clf = shard_spatially(cs.toy_classifier(dev), grid.spatial) if kind != "golden" else None
    fn, _, _ = grid.wrap(lambda z, t: model(z, t), model=model)
    runs = {}
    for loop in loops:
        over_rows = grid_sampler(functools.partial(sample_posterior, loop=loop), grid)

        def sample(model_fn, x, apy, op, tables, gens, **kw):
            # generators (unused under zero noise) so that grid_sampler splits them with
            # the batch
            gens = [torch.Generator(device=dev).manual_seed(i) for i in range(len(gens))]
            return over_rows(model_fn, x, apy, op, tables, gens, **kw)

        reset_collective_counts()
        if kind == "golden":
            psnr, x, secs = cs.hq_golden_run(fn, dev, cs.TASKS_HQ[0], sample=sample)
            per_image = None
        else:
            psnr, x, per_image, secs = cs.guided_golden_run(model, clf, dev, grid=grid,
                                                            sample=sample)
        runs[loop] = {"psnr": psnr, "per_image_max_abs_vs_jax": per_image, "seconds": secs,
                      "collectives": {**COLLECTIVES, **BACKWARD_COLLECTIVES},
                      "graphs": len(graphs.graph_stats()),
                      "sha256": hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()}
        graphs.clear_graphs()
    out.write_text(json.dumps({"rank": rank, "device": dev, "backend": grid.spatial.backend,
                               "loops": runs}))


def run_golden(kind: str, dp: int, sp: int, tmp: Path, device: str, loops: list) -> list:
    import chip_smoke as cs

    world = dp * sp
    port = cs.free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(tmp / f"{kind}_{dp}x{sp}_{rank}.log", "w+")
        procs.append((log, subprocess.Popen(
            [sys.executable, __file__, "--worker", kind, str(dp), str(sp),
             str(tmp / f"{kind}_{dp}x{sp}_{rank}.json"), device, ",".join(loops)], cwd=HERE,
            env=env, stdout=log,
            stderr=subprocess.STDOUT)))
    try:
        for log, proc in procs:
            if proc.wait(timeout=600) != 0:
                log.seek(0)
                raise RuntimeError(f"{kind} {dp}x{sp}: a rank exited {proc.returncode}: "
                                   f"{log.read()[-3000:]}")
    finally:
        for log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return [json.loads((tmp / f"{kind}_{dp}x{sp}_{r}.json").read_text()) for r in range(world)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=20, help="face256 model calls of (b)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--cpu", action="store_true", help="(a) only, on the CPU over gloo")
    p.add_argument("--loop", nargs="+", default=["host", "scan"], choices=["host", "scan"],
                   help="the loop drivers of (a), in turn in each rank")
    p.add_argument("--worker", nargs=6, default=None, help=argparse.SUPPRESS)
    ns = p.parse_args(argv)
    if ns.worker:
        kind, dp, sp, out, device, loops = ns.worker
        worker(kind, int(dp), int(sp), Path(out), device, loops.split(","))
        return 0
    import chip_smoke as cs
    import time_spatial

    device = "cpu" if ns.cpu else "cuda"
    smi = ["cpu"]
    if not ns.cpu:
        if torch.cuda.device_count() < 4:
            raise RuntimeError(f"needs 4 cards, {torch.cuda.device_count()} visible")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()
    print(f"{len(smi)} card(s): {smi[0]}", flush=True)
    backend = "gloo" if ns.cpu else "nccl"
    want = {"golden": json.loads(cs.TOY_ADM_PSNR.read_text())[cs.TASKS_HQ[0][0]]["ours_psnr"],
            "guided_golden": json.loads(cs.GUIDED_GOLDEN.read_text())["tiers"]["toy32"][
                "recorded_psnr"]}
    goldens, failed = [], []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for kind in ("golden", "guided_golden"):
            for dp, sp in ((1, 2), (2, 2)):
                ranks = run_golden(kind, dp, sp, tmp, device, ns.loop)
                for loop in ns.loop:
                    per = [r["loops"][loop] for r in ranks]
                    row = {"kind": kind, "dp": dp, "sp": sp, "loop": loop,
                           "jax_psnr": want[kind], "psnr": [r["psnr"] for r in per],
                           "backends": sorted({r["backend"] for r in ranks}),
                           "devices": [r["device"] for r in ranks],
                           "ranks_bit_equal": len({r["sha256"] for r in per}) == 1,
                           "seconds": [r["seconds"] for r in per],
                           "graphs": [r["graphs"] for r in per],
                           "collectives": per[0]["collectives"],
                           "per_image_max_abs_vs_jax": per[0]["per_image_max_abs_vs_jax"]}
                    row["max_db_from_jax"] = max(abs(v - want[kind]) for v in row["psnr"])
                    ok = (row["ranks_bit_equal"] and row["max_db_from_jax"] <= cs.HQ_PSNR_TOL
                          and row["backends"] == [backend])
                    if loop == "scan" and "host" in ns.loop:
                        host = [r["loops"]["host"] for r in ranks]
                        row["bit_equal_to_host"] = all(a["sha256"] == b["sha256"]
                                                       for a, b in zip(per, host))
                        row["collectives_equal_to_host"] = all(
                            a["collectives"] == b["collectives"] for a, b in zip(per, host))
                        ok = ok and row["bit_equal_to_host"] and row["collectives_equal_to_host"]
                    print(f"{kind} dp {dp} x sp {sp} {loop} ({row['backends']}, "
                          f"{row['devices']}): PSNR {row['psnr']} against JAX {want[kind]:.4f} "
                          f"({row['max_db_from_jax']:.5f} dB, gate {cs.HQ_PSNR_TOL}), ranks "
                          f"bit-equal {row['ranks_bit_equal']}, graphs {row['graphs']}, "
                          f"bit-equal to host {row.get('bit_equal_to_host', '-')}, collectives "
                          f"equal to host {row.get('collectives_equal_to_host', '-')}, "
                          f"{'ok' if ok else 'FAILED'}", flush=True)
                    goldens.append(row)
                    if not ok:
                        failed.append(f"{kind} {dp}x{sp} {loop}")
        face, face_row = {}, None
        for where, env in (() if ns.cpu else (("two_cards_nccl", None), ("one_card_gloo", "0"))):
            old = os.environ.get("CUDA_VISIBLE_DEVICES")
            if env is not None:
                os.environ["CUDA_VISIBLE_DEVICES"] = env
            try:
                ranks = time_spatial.run_layout("face256", 1, 2, "nccl" if env is None else "gloo",
                                                ns.calls, 1, tmp, ["auto"])
                ranks = [dict(r["loops"]["auto"], device=r["device"], backend=r["backend"])
                         for r in ranks]
            finally:
                if env is not None:
                    if old is None:
                        os.environ.pop("CUDA_VISIBLE_DEVICES")
                    else:
                        os.environ["CUDA_VISIBLE_DEVICES"] = old
            face[where] = ranks
        if face:
            a, b = face["two_cards_nccl"], face["one_card_gloo"]
            face_row = {
                "calls": ns.calls,
                "devices": {k: [r["device"] for r in v] for k, v in face.items()},
                "backends": {k: v[0]["backend"] for k, v in face.items()},
                "seconds_per_tile": {k: max(r["seconds_per_tile"] for r in v)
                                     for k, v in face.items()},
                "ranks_bit_equal": {k: len({r["sha256"] for r in v}) == 1
                                    for k, v in face.items()},
                "finals_bit_equal": a[0]["sha256"] == b[0]["sha256"],
                "max_abs_subsampled": float(np.abs(np.asarray(a[0]["final"])
                                                   - np.asarray(b[0]["final"])).max())}
            print(f"face256 bf16 sp 2, {ns.calls} calls: two cards (NCCL) against one card "
                  f"(gloo): finals bit-equal {face_row['finals_bit_equal']}, max |diff| of the "
                  f"subsample {face_row['max_abs_subsampled']}, s per tile "
                  f"{face_row['seconds_per_tile']}", flush=True)
    summary = {"card": smi[0], "cards": len(smi), "goldens": goldens, "face256": face_row,
               "failed": failed}
    if ns.out:
        Path(ns.out).parent.mkdir(parents=True, exist_ok=True)
        Path(ns.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
