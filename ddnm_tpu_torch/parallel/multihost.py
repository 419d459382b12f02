"""Several processes, each restoring its own slice of the dataset (port of
ddnm_tpu/parallel/multihost.py).

DDNM sampling has no cross-image dependency, so a multi-process run is
the degenerate-ideal one: every process runs the same program on a
disjoint contiguous slice of the dataset (`process_subset`) on its own
card, and writes its own outputs under their global names: the way to use
several cards (on 4 H100s 3.7-4.0x one card's images/s, PERF.md §6). The step loop has no collectives; the
process group (gloo) serves the set-up only (the output folder is cleared
once, before any rank writes), so two ranks may share one card.

A launch is detected from the environment alone, as in the JAX package:
torchrun's WORLD_SIZE > 1 with RANK and MASTER_ADDR, Slurm's SLURM_NTASKS >
1 with SLURM_PROCID, or OpenMPI's OMPI_COMM_WORLD_SIZE > 1 with
OMPI_COMM_WORLD_RANK (a lone SLURM_JOB_NUM_NODES is no evidence). The
rendezvous is MASTER_ADDR:MASTER_PORT, which torchrun sets and a Slurm or
MPI job script exports. Unlike the JAX package, a detected launch whose
initialisation fails raises: a rank that went on alone would restore the
whole dataset, and every rank would write every image.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

__all__ = ["maybe_init_distributed", "process_index", "process_count", "process_subset",
           "local_device", "launch_from_env"]

logger = logging.getLogger("ddnm_tpu_torch")

# (launcher, world-size variable, rank variable, local-rank variable)
_LAUNCHERS = (
    ("torchrun", "WORLD_SIZE", "RANK", "LOCAL_RANK"),
    ("slurm", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"),
    ("openmpi", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"),
)


def launch_from_env() -> Optional[dict]:
    """The multi-process launch the environment describes, or None: a dict
    of launcher, rank, world_size and local_rank (None where unset)."""
    env = os.environ
    for name, size_var, rank_var, local_var in _LAUNCHERS:
        size, rank = env.get(size_var), env.get(rank_var)
        if not size or rank is None or int(size) <= 1:
            continue
        if name == "torchrun" and not env.get("MASTER_ADDR"):
            continue
        local = env.get(local_var)
        return {"launcher": name, "rank": int(rank), "world_size": int(size),
                "local_rank": None if local is None else int(local)}
    return None


def maybe_init_distributed() -> bool:
    """Join the process group (gloo) when the environment describes a
    multi-process launch; False (and nothing done) otherwise. Raises
    RuntimeError when a launch is detected and the group cannot be joined
    (no MASTER_ADDR / MASTER_PORT, a bad port, a failed rendezvous)."""
    launch = launch_from_env()
    if launch is None:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    what = f"{launch['launcher']} rank {launch['rank']} of {launch['world_size']}"
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    try:
        if not addr or not port:
            raise ValueError("MASTER_ADDR and MASTER_PORT must name the rendezvous")
        if not port.isdigit() or not 0 < int(port) < 65536:
            raise ValueError(f"MASTER_PORT {port!r} is not a port")
        dist.init_process_group("gloo", init_method=f"tcp://{addr}:{int(port)}",
                                rank=launch["rank"], world_size=launch["world_size"])
    except Exception as e:
        raise RuntimeError(f"multi-process launch detected ({what}) but the process group "
                           f"could not be joined: {e}") from e
    logger.info("process group joined: %s (gloo, %s:%s)", what, addr, port)
    return True


def _group() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return _group()[0]


def process_count() -> int:
    """The number of processes of the run (1 without a process group)."""
    return _group()[1]


def process_subset(n_items: int, process_index=None, process_count=None):
    """(start, end) of this process's contiguous dataset slice.

    Splits n_items as evenly as possible (the first `n_items % count`
    processes get one extra), covering every item exactly once across the
    processes: the automated form of the reference's manual
    --subset_start / --subset_end job sharding. Under a spatial grid
    (make_mesh_2d with sp > 1) the images split over the data indices, not
    the ranks: pass the Grid's data_index and dp (the ranks of one spatial
    group restore the same images)."""
    rank, world = _group()
    p = rank if process_index is None else process_index
    c = world if process_count is None else process_count
    base, extra = divmod(n_items, c)
    start = p * base + min(p, extra)
    end = start + base + (1 if p < extra else 0)
    return start, end


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """The card of this rank: an explicit `cuda:N` as it is, else
    cuda:<local rank> (LOCAL_RANK, SLURM_LOCALID or
    OMPI_COMM_WORLD_LOCAL_RANK; 0 without one); the CPU as it is. A local
    rank at or beyond the visible cards raises."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    launch = launch_from_env()
    local = 0 if launch is None or launch["local_rank"] is None else launch["local_rank"]
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(f"local rank {local} has no card: {count} visible; give each "
                           "rank --device cuda:N or launch at most one rank per card")
    return torch.device("cuda", local)
