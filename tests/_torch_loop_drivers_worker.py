"""One rank of tests/test_torch_loop_drivers_parallel.py's group of 2 gloo
processes on 127.0.0.1: the scan loop driver under --sp 2 on the CPU, the
graphs stand-ins (tests/_torch_port.py StandInGraph) whose replays rerun
the body, written to <dir>/rank<r>.npz for the parent. Imports no JAX.

    python tests/_torch_loop_drivers_worker.py RANK WORLD PORT DIR

Runs, on the grid (1, WORLD) with the toy32 ADM (and classifier) sharded:
the hq golden tile and the guided golden tile under host and scan; a short
tile under host, scan (a capture) and auto (a replay), again after rank 0
alone dropped its graphs, then with a capture that fails on rank 0 alone
(every rank must raise) and one that runs out of memory on rank 0 alone
(every rank must drop its graphs and capture again)."""

from __future__ import annotations

import functools
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke  # noqa: E402
from ddnm_tpu_torch import schedules as sch  # noqa: E402
from ddnm_tpu_torch.models import shard_spatially  # noqa: E402
from ddnm_tpu_torch.operators import build_functional_operator  # noqa: E402
from ddnm_tpu_torch.parallel import (  # noqa: E402
    BACKWARD_COLLECTIVES,
    COLLECTIVES,
    grid_sampler,
    make_mesh_2d,
    reset_collective_counts,
)
from ddnm_tpu_torch.sampling import graphs  # noqa: E402
from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, sample_posterior  # noqa: E402
from tests._torch_port import StandInGraph  # noqa: E402


def _counts() -> np.ndarray:
    return np.array([COLLECTIVES[k] for k in sorted(COLLECTIVES)]
                    + [BACKWARD_COLLECTIVES[k] for k in sorted(BACKWARD_COLLECTIVES)])


def _replays() -> list:
    return [s["replays"] for s in graphs.graph_stats()]


def main(rank: int, world: int, port: int, out_dir: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    graphs._BACKENDS["cpu"] = StandInGraph
    grid = make_mesh_2d(1, world, device="cpu")
    model = shard_spatially(chip_smoke.toy_adm("cpu"), grid.spatial)
    fn, _, _ = grid.wrap(lambda z, t: model(z, t), model=model)
    over = lambda loop: grid_sampler(functools.partial(sample_posterior, loop=loop), grid)
    out = {}

    # the hq golden tile and the guided golden tile (the ADM and the
    # classifier sharded) under host and scan (a capture and its replay)
    clf = shard_spatially(chip_smoke.toy_classifier("cpu"), grid.spatial)
    for name in ("host", "scan"):
        reset_collective_counts()
        psnr, x, _ = chip_smoke.hq_golden_run(fn, "cpu", chip_smoke.TASKS_HQ[0],
                                              sample=over(name))
        out[f"hq_{name}"], out[f"hq_{name}_psnr"] = x.numpy(), np.array(psnr)
        out[f"hq_{name}_collectives"] = _counts()
        reset_collective_counts()
        psnr, x, _, _ = chip_smoke.guided_golden_run(model, clf, "cpu", grid=grid,
                                                     sample=over(name))
        out[f"guided_{name}"], out[f"guided_{name}_psnr"] = x.numpy(), np.array(psnr)
        out[f"guided_{name}_collectives"] = _counts()
    graphs.clear_graphs()

    # a short tile: host, scan (captures), auto (replays); then rank 0
    # alone drops its graphs (the group agrees to capture afresh); then its
    # capture fails, and runs out of memory, on rank 0 alone
    tables = build_posterior_tables(betas=sch.named_beta_schedule("linear", 1000),
                                    timestep_respacing="3",
                                    schedule_jump_params=dict(t_T=3, n_sample=1, jump_length=1,
                                                              jump_n_sample=1))
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0)
    x_init = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    apy = op.Ap(op.A(torch.ones((1, 32, 32, 3)) * 0.3))
    zero = lambda gens, shape: torch.zeros(shape)

    def short(loop):
        reset_collective_counts()
        x = over(loop)(fn, x_init, apy, op, tables, [None], noise_fn=zero)[0].numpy()
        return x, _counts()

    for name in ("host", "scan", "auto"):
        out[f"short_{name}"], out[f"short_{name}_collectives"] = short(name)
    out["short_replays"] = np.array(_replays())
    if rank == 0:
        graphs.clear_graphs()
    out["short_after_clear"], out["short_after_clear_collectives"] = short("auto")
    out["short_after_clear_replays"] = np.array(_replays())
    graphs.clear_graphs()
    for name, err in (("failed", RuntimeError("stand-in capture failed after its body")),
                      ("oom", torch.OutOfMemoryError("CUDA out of memory (stand-in)"))):
        if rank == 0:
            StandInGraph.fail_after = err
        try:
            out[f"short_{name}"] = short("scan")[0]
            out[f"short_{name}_error"] = np.array("")
        except Exception as e:  # every rank must raise alike
            out[f"short_{name}_error"] = np.array(f"{type(e).__name__}: {e}")
    # rank 0's out-of-memory capture dropped every rank's graphs once
    out["short_oom_graphs"] = np.array(len(graphs.graph_stats()))
    np.savez(out_dir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
