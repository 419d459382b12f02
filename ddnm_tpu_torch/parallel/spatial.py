"""The 2-D (data, spatial) grid of the JAX package's
ddnm_tpu/parallel/spatial.py, as a grid of processes.

The hq pipeline's reference-parity schedule is a sequential chain of
batch-1 tiles, whose latency data parallelism cannot cut; the JAX package
shards each tile's rows (the H axis) over a "spatial" mesh axis and lets
XLA's SPMD partitioner insert the convolution halos, the cross-shard
GroupNorm sums and the attention gather. PyTorch has no partitioner, and
in one process no mesh beat one card (PERF.md §6), so here the grid is
one process per (data index, spatial rank), dp * sp processes in all
(torchrun, or parallel/multihost.py's launch detection), and the
exchanges are written out:

  - every 3x3 convolution takes its halo rows from its neighbours
    (parallel/halo.py; models/nn.py `shard_spatially` attaches them);
  - every GroupNorm sums its shard's pixels per channel, adds every
    shard's sums in rank order and folds them (ops/groupnorm.py
    `spatial=`);
  - every attention takes its shard's queries against the keys and values
    gathered from every shard (models/nn.py `attention(spatial=)`).

Only the model call is sharded. Every rank of a spatial group runs the
same sampler and tiling arithmetic on the whole tile (the same per-tile
generators, the operators on the whole tile): `Grid.wrap` turns a model
function of the whole tile into one that keeps this rank's H / sp rows,
runs the sharded UNet and all_gathers the output back to the whole tile
on every rank, so the ranks' tiles stay bit-identical. The JAX package
shards the sampler's arrays too; the results agree within tolerance. The
data axis splits a tile group's batch over the data indices
(`grid_sampler`), each data row's output all_gathered over the ranks of
one spatial rank.

Gradients (classifier guidance under spatial shards): every exchange is a
`torch.autograd.Function` over `SpatialGroup.all_gather`, and its backward
depends on what consumes the gathered tensor:

  - a partitioned consumer (each shard uses it for its own rows: the
    attention's keys and values, a GroupNorm's summed statistics, the halo
    rows) gives a partial gradient on each shard: the backward gathers the
    shards' partials, adds them in rank order and keeps its own block
    (`gather_shards`; the halo's in parallel/halo.py, the GroupNorm's in
    ops/groupnorm.py);
  - a replicated consumer (every rank computes the same thing from it: a
    model output's rows, the classifier's pooled map, its logits and
    loss) gives every rank the whole gradient already: the backward is the
    slice of its own block, no collective (`gather_rows`,
    `sum_replicated`). A sum here would give sp times the gradient.

Every sum adds the shards in rank order, so every rank holds the same
bits. `Grid.wrap(guidance_fn=, classifier=)` runs the guidance hook on this
rank's rows of the tile, so the gradient is taken through the sharded
classifier, and gathers the gradient's rows back.

`make_mesh_2d(dp, sp)` with sp > 1 returns this process's `Grid`; with
sp == 1 it is the in-process data mesh (parallel/mesh.py). A spatial group
uses NCCL where each of its ranks has a card of its own, gloo otherwise
(the CPU, and ranks sharing one card, where NCCL refuses); a gloo
collective of CUDA tensors goes through host memory.

The scan loop driver (sampling/graphs.py): `grid_sampler` runs each rank's
trajectory as one CUDA graph with its NCCL collectives inside, as JAX's
scan runs one program with XLA's collectives inside. The group agrees on
every capture over a gloo control group of its own (`SpatialGroup.agree`,
with a time limit); the collectives a capture issues count at each replay.
A gloo group on a card cannot be captured (its host hop): its ranks run
host-driven and an explicit scan raises. Unlike the JAX
package, which replicates a leaf whose rows the axis does not divide,
`split_rows` raises ValueError, and `Grid.wrap` checks the model's lowest
grid before a call.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import socket
from typing import Callable, Optional, Sequence

import torch

from ddnm_tpu_torch.parallel import multihost
from ddnm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    _is_generators,
    _map_tensors,
    make_mesh,
    shard_batch,
    to_device,
    warn_unsharded,
)
from ddnm_tpu_torch.sampling import graphs

__all__ = ["SPATIAL_AXIS", "COLLECTIVES", "BACKWARD_COLLECTIVES", "SpatialGroup", "Grid",
           "make_mesh_2d", "shard_tiles", "split_rows", "gather_rows", "gather_shards",
           "sum_replicated", "grid_sampler", "lowest_rows", "reset_collective_counts"]

SPATIAL_AXIS = "spatial"

logger = logging.getLogger("ddnm_tpu_torch")

# collectives since the last reset, by what they carry: a convolution's
# halo rows, a GroupNorm's partial sums, an attention's keys and values,
# a replicated consumer's rows (a model output's, the classifier's pooled
# map or its pools' summed means), a data-sharded batch
COLLECTIVES = {"halo": 0, "groupnorm": 0, "attention": 0, "rows": 0, "batch": 0}
# the backward's collectives, apart: the halo rows' gradients returned to
# their senders, a GroupNorm's partial sums of its gradient, the partial
# gradients of an attention's gathered keys and values
BACKWARD_COLLECTIVES = {"halo_grad": 0, "groupnorm_grad": 0, "attention_grad": 0}
# how long a rank waits for the others to agree on a graph's capture
# (SpatialGroup.agree) before it raises: a first capture of the ranks'
# trajectory (warm-up, capture and instantiation) must fit in it
AGREE_TIMEOUT = datetime.timedelta(seconds=600)


def reset_collective_counts() -> None:
    for table in (COLLECTIVES, BACKWARD_COLLECTIVES):
        for k in table:
            table[k] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class SpatialGroup:
    """The processes that hold the shards of one map's rows: their process
    group, this process's rank in it (its rows are the rank-th of `size`
    equal blocks), the group's backend, and a gloo group of the same ranks
    with a time limit (`control`, made by `make_mesh_2d`; None: `group`
    itself, a gloo group) that carries the graphs' agreements."""

    group: object
    rank: int
    size: int
    backend: str = "gloo"
    control: object = None

    def all_gather(self, t: torch.Tensor, kind: str) -> list:
        """Every member's `t` (same shape and dtype), in rank order, on t's
        device; counted under `kind` (in a graph: at each replay). NCCL
        gathers into one tensor, which a CUDA graph captures (its stream
        joins the capture and leaves it at the wait); gloo goes through
        host memory for a CUDA tensor, which no graph can hold."""
        import torch.distributed as dist

        graphs.count_collective(
            BACKWARD_COLLECTIVES if kind in BACKWARD_COLLECTIVES else COLLECTIVES, kind)
        t = t.contiguous()
        if self.backend == "nccl":
            out = t.new_empty((self.size, *t.shape))
            dist.all_gather_into_tensor(out, t, group=self.group)
            return list(out.unbind(0))
        hop = t.is_cuda
        if hop and graphs.recording():
            raise ValueError(graphs.SCAN_OVER_GLOO)
        src = t.cpu() if hop else t
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        if hop:
            parts = [p.to(t.device, non_blocking=True) for p in parts]
        return parts

    def agree(self, value: int) -> list:
        """Every member's small integer `value`, in rank order (the scan
        driver's capture-or-replay decisions, sampling/graphs.py): one
        uncounted all_gather on the host over `control`, outside any graph;
        raises after AGREE_TIMEOUT where a member does not take part."""
        import torch.distributed as dist

        t = torch.tensor([int(value)], dtype=torch.int64)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group if self.control is None else self.control)
        return [int(p.item()) for p in parts]

    def gather(self, t: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        """Every member's `t` concatenated along `dim` in rank order."""
        return torch.cat(self.all_gather(t, kind), dim=dim)

    def sum_shards(self, t: torch.Tensor, kind: str = "groupnorm") -> torch.Tensor:
        """The sum of every member's `t`, added in rank order (the same bits
        on every member)."""
        return _rank_order_sum(self.all_gather(t, kind))


def _rank_order_sum(parts) -> torch.Tensor:
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _GatherReplicated(torch.autograd.Function):
    """Every member's block concatenated along `dim`, for a replicated
    consumer: the backward is this member's block of the gradient."""

    @staticmethod
    def forward(ctx, t, spatial, dim, kind):
        ctx.conf = (spatial.rank, t.shape[dim], dim)
        return spatial.gather(t, dim, kind)

    @staticmethod
    def backward(ctx, g):
        rank, k, dim = ctx.conf
        return g.narrow(dim, rank * k, k), None, None, None


class _GatherShards(torch.autograd.Function):
    """Every member's block concatenated along `dim`, for a partitioned
    consumer: the backward adds every member's partial gradient in rank
    order (one all_gather, counted under `grad_kind`) and keeps this
    member's block."""

    @staticmethod
    def forward(ctx, t, spatial, dim, kind, grad_kind):
        ctx.conf = (spatial, t.shape[dim], dim, grad_kind)
        return spatial.gather(t, dim, kind)

    @staticmethod
    def backward(ctx, g):
        spatial, k, dim, grad_kind = ctx.conf
        total = spatial.sum_shards(g, grad_kind)
        return total.narrow(dim, spatial.rank * k, k), None, None, None, None


def gather_shards(t: torch.Tensor, spatial: SpatialGroup, dim: int, kind: str,
                  grad_kind: str) -> torch.Tensor:
    """Every member's `t` concatenated along `dim` in rank order, for a
    partitioned consumer (module docstring): with grad, the gradient of
    this member's block is every member's partial, added in rank order."""
    if _needs_grad(t):
        return _GatherShards.apply(t, spatial, dim, kind, grad_kind)
    return spatial.gather(t, dim, kind)


def sum_replicated(t: torch.Tensor, spatial: SpatialGroup, kind: str = "rows") -> torch.Tensor:
    """The sum of every member's `t` in rank order (one all_gather), for a
    replicated consumer: with grad, each member's `t` takes the whole
    gradient of the sum (the classifier's spatial pools' partial means)."""
    if _needs_grad(t):
        return _rank_order_sum(_GatherReplicated.apply(t[None], spatial, 0, kind).unbind(0))
    return spatial.sum_shards(t, kind)


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """This process's place in a (dp x sp) grid of processes: its data
    index (which share of a tile group it samples) and spatial rank (which
    rows of a tile it holds), its device, its spatial group, and the group
    of the dp processes of its spatial rank (None where dp == 1), which
    gathers a data-sharded batch."""

    dp: int
    sp: int
    data_index: int
    spatial_rank: int
    device: torch.device
    spatial: SpatialGroup
    data: Optional[SpatialGroup] = None

    @property
    def writer(self) -> bool:
        """Spatial rank 0 of its data row: the rank that writes files."""
        return self.spatial_rank == 0

    def spatial_only(self) -> "Grid":
        """The same spatial group with no data axis (each data row on its
        own images)."""
        return dataclasses.replace(self, dp=1, data_index=0, data=None)

    def wrap(self, model_fn=None, encode_fn=None, decode_fn=None, model=None, *,
             guidance_fn=None, classifier=None):
        """(model_fn, encode_fn, decode_fn) of the whole tile over this
        grid's spatial group (module docstring); None stays None. `model`
        (the sharded UNet) gives the lowest grid to check. With
        `guidance_fn`, (model_fn, encode_fn, decode_fn, guidance_fn): the
        guidance hook guidance_fn(x, t, ...) of a classifier sharded over
        this group runs on this rank's rows of the whole tile x (its
        gradient taken with respect to those rows, through the sharded
        classifier), and the gradient's rows are gathered back, the same
        bits on every rank; `classifier` gives its lowest grid to check."""
        sg = self.spatial

        def rows(x, net=model):
            if net is not None:
                lowest_rows(net, x.shape[1], sg.size)
            return split_rows(x, sg)

        def wrapped_model(x, t, *args, **kw):
            return gather_rows(model_fn(rows(x), t, *args, **kw), sg)

        def wrapped_encode(x, t):
            return encode_fn(rows(x), t)  # each rank caches its own rows

        def wrapped_decode(cache, x, t):
            return gather_rows(decode_fn(cache, rows(x), t), sg)

        if classifier is not None and getattr(classifier, "spatial", None) is not sg:
            raise ValueError("the guidance hook's classifier is not sharded over this grid's "
                             "spatial group: shard_spatially(classifier, grid.spatial) first")

        def wrapped_guidance(x, t, *args, **kw):
            return gather_rows(guidance_fn(rows(x, classifier), t, *args, **kw), sg)

        out = (None if model_fn is None else wrapped_model,
               None if encode_fn is None else wrapped_encode,
               None if decode_fn is None else wrapped_decode)
        return out if guidance_fn is None else out + (wrapped_guidance,)


def _host_devices(dev: torch.device) -> list:
    """(host name, device type, device index) of every rank, in rank order."""
    import torch.distributed as dist

    mine = (socket.gethostname(), dev.type, dev.index)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def make_mesh_2d(dp: int, sp: int, devices: Optional[Sequence] = None, *,
                 device="cuda", backend: Optional[str] = None):
    """The (dp x sp) grid. sp == 1: the in-process 1-D data mesh of dp
    entries over `devices` (parallel/mesh.py). sp > 1: this process's
    `Grid` in a process group of dp * sp ranks (rank r is data index r //
    sp, spatial rank r % sp), on multihost.local_device(device)
    (cuda:LOCAL_RANK, an explicit cuda:N, or the CPU). Every rank must call
    it, in the same order: it builds every row's spatial group (NCCL where
    the row's ranks hold distinct cards, gloo otherwise; `backend` "nccl"
    or "gloo" forces one) with its gloo control group (AGREE_TIMEOUT), and
    every column's data group (gloo). Raises RuntimeError without a process
    group of dp * sp ranks."""
    if sp == 1:
        return make_mesh(dp, devices, device=device)
    if dp < 1 or sp < 1:
        raise ValueError(f"the grid takes dp, sp >= 1, got {dp}, {sp}")
    if devices is not None:
        raise ValueError("a grid of processes places each rank by `device`, not `devices`")
    import torch.distributed as dist

    world = dp * sp
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a spatial grid of dp={dp} x sp={sp} runs as {world} processes: launch with "
            f"`torchrun --nproc_per_node {world} ...` (or set RANK, WORLD_SIZE={world}, "
            "MASTER_ADDR and MASTER_PORT for each rank), so that a process group exists")
    if dist.get_world_size() != world:
        raise RuntimeError(f"a spatial grid of dp={dp} x sp={sp} needs {world} processes, the "
                           f"process group has {dist.get_world_size()}")
    rank = dist.get_rank()
    dev = multihost.local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # NCCL's collectives run on the current card
    every = _host_devices(dev)
    spatial = data = None
    for d in range(dp):  # every rank builds every group, in one order
        ranks = list(range(d * sp, (d + 1) * sp))
        placed = [every[r] for r in ranks]
        distinct = (all(p[1] == "cuda" for p in placed) and len(set(placed)) == len(placed))
        chosen = backend or ("nccl" if distinct and dist.is_nccl_available() else "gloo")
        group = dist.new_group(ranks, backend=chosen)
        control = dist.new_group(ranks, backend="gloo", timeout=AGREE_TIMEOUT)
        if rank in ranks:
            spatial = SpatialGroup(group, rank - d * sp, sp, chosen, control)
    if dp > 1:
        for s in range(sp):
            ranks = list(range(s, world, sp))
            group = dist.new_group(ranks, backend="gloo")
            if rank in ranks:
                data = SpatialGroup(group, rank // sp, dp, "gloo")
    grid = Grid(dp, sp, rank // sp, rank % sp, dev, spatial, data)
    logger.info("grid dp=%d x sp=%d: rank %d is data %d, spatial %d on %s (%s)", dp, sp, rank,
                grid.data_index, grid.spatial_rank, dev, spatial.backend)
    return grid


def split_rows(x: torch.Tensor, spatial: SpatialGroup, axis: int = 1) -> torch.Tensor:
    """This rank's block of `axis` (the H of an NHWC tensor): a view.
    ValueError where the group's size does not divide it."""
    h = x.shape[axis]
    if h % spatial.size:
        raise ValueError(f"spatial axis (size {spatial.size}) does not divide {h} rows")
    k = h // spatial.size
    return x.narrow(axis, spatial.rank * k, k)


def gather_rows(x: torch.Tensor, spatial: SpatialGroup, axis: int = 1) -> torch.Tensor:
    """Every rank's block of `axis`, concatenated in rank order (the whole
    map on every rank), for a replicated consumer: with grad, the gradient
    of this rank's block is its block of the gradient."""
    if _needs_grad(x):
        return _GatherReplicated.apply(x, spatial, axis, "rows")
    return spatial.gather(x, axis, "rows")


def lowest_rows(model, rows: int, sp: int) -> int:
    """The rows of `model`'s lowest grid for an input of `rows` rows: rows
    halved at each of its downsamplings (a module with a true `down`).
    ValueError where sp does not divide them, nor the input's rows (each
    level above is then even on every shard)."""
    downs = sum(1 for m in model.modules() if getattr(m, "down", False) is True)
    lowest, rem = divmod(rows, 2 ** downs)
    if rem or lowest % sp:
        raise ValueError(f"spatial partitioning over {sp} shards needs the model's lowest grid "
                         f"({rows} / 2^{downs} rows) to be a multiple of {sp}")
    return lowest


def grid_sampler(sample_fn: Callable, grid: Grid) -> Callable:
    """`sample_fn(*args, **kw)` with its batch over the grid's data axis:
    the leading axis of the batch tensors (those of the first tensor
    argument's length) and the lists of per-image generators take this
    data index's share, and every tensor of the output is all_gathered over
    the data group in data-index order. A batch that dp does not divide
    runs whole on every data row (logged once). Under the scan driver each
    rank's trajectory is one graph of its spatial group, the data group's
    gather outside it; on a gloo group on a card the ranks run
    host-driven (sampling/graphs.py `capturable`)."""

    def wrapped(*args, **kw):
        if not graphs.capturable(grid):
            with graphs.host_only():
                return shard(*args, **kw)
        with graphs.placed(spatial=grid.spatial):
            return shard(*args, **kw)

    def shard(*args, **kw):
        n = next(int(v.shape[0]) for v in list(args) + list(kw.values())
                 if isinstance(v, torch.Tensor) and v.ndim >= 1)
        if grid.dp == 1 or grid.data is None or n % grid.dp:
            if grid.dp > 1:
                warn_unsharded(DATA_AXIS, grid.dp, n)
            return sample_fn(*args, **kw)
        k = n // grid.dp
        sl = slice(grid.data_index * k, (grid.data_index + 1) * k)

        def take(v):
            if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == n:
                return v[sl]
            if _is_generators(v) and len(v) == n:
                return list(v[sl])
            return v

        out = sample_fn(*[take(v) for v in args], **{key: take(v) for key, v in kw.items()})
        return _map_tensors(out, lambda t: grid.data.gather(t, 0, "batch"))

    return wrapped


def _take_grid(grid: Grid, x):
    """This process's part of one leaf (`shard_tiles` over a Grid)."""
    if isinstance(x, torch.Tensor) and x.ndim >= 1:
        if grid.dp > 1:
            if x.shape[0] % grid.dp == 0:
                k = x.shape[0] // grid.dp
                x = x[grid.data_index * k:(grid.data_index + 1) * k]
            else:
                warn_unsharded(DATA_AXIS, grid.dp, x.shape[0])
        if x.ndim >= 4:
            if x.shape[1] % grid.sp == 0:
                x = split_rows(x, grid.spatial)
            else:
                warn_unsharded(SPATIAL_AXIS, grid.sp, x.shape[1])
        return to_device(x, grid.device)
    return x


def shard_tiles(mesh, tree):
    """Place every leaf of `tree` on the mesh. A 1-D data mesh: each leaf
    becomes a tuple of per-entry values, the leading axis split where the
    mesh size divides it, else the whole leaf on every entry (logged once).
    A Grid: each tensor leaf becomes this process's part, the leading axis
    split over the data axis and the H axis of a 4-D leaf over the spatial
    axis where they divide (ddnm_tpu/parallel/spatial.py `_specs`), else
    kept whole on that axis (logged once)."""
    if isinstance(mesh, Grid):
        if isinstance(tree, dict):
            return {k: shard_tiles(mesh, v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)) and not _is_generators(tree):
            return type(tree)(shard_tiles(mesh, v) for v in tree)
        return _take_grid(mesh, tree)
    if isinstance(tree, torch.Tensor) or _is_generators(tree):
        n = len(tree) if not isinstance(tree, torch.Tensor) or tree.ndim else 0
        if n and n % mesh.size == 0:
            return shard_batch(mesh, tree)
        if n:
            warn_unsharded(DATA_AXIS, mesh.size, n)
        return tuple(to_device(tree, d) for d in mesh.devices)
    if isinstance(tree, dict):
        return {k: shard_tiles(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tiles(mesh, v) for v in tree)
    return tree

