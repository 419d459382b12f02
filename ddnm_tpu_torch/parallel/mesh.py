"""Batch sharding over a 1-D data mesh (port of ddnm_tpu/parallel/mesh.py).

DDNM's workload is embarrassingly parallel over images: the pattern is a
1-D data mesh with the weights replicated and the image batch sharded,
with no collective in the step loop. XLA partitions a jitted sampler from
its inputs' shardings; an eager PyTorch sampler is a host loop, so here
the mesh runs one copy of the loop per entry, one after the other on the
caller's thread. Host-driven on 4 H100s (PERF.md §6) that beat a
thread per entry (at batch 8 over 2 cards 0.79x against 0.29x of one
card's rate: the threads contend for the interpreter lock), but no mesh
beat one card. Under the scan driver a shard is one graph launch, so the
cards overlap: a mesh of 2 cards gave 1.72-1.73x one card's sampler
rate, of 4 cards 2.49x (PERF.md §6; NVIDIA H100 80GB HBM3,
700.00 W). One process a card (parallel/multihost.py) scaled 3.7-4.0x.

  - `make_mesh` gives the ordered devices of the mesh: every visible card
    by default; N entries of the one CPU with device="cpu" (the tests'
    counterpart of XLA's forced host devices). An entry may repeat a card
    only where the caller lists the devices itself; its shards then run on
    separate streams of that card.
  - `replicate` gives one copy per entry of a module, a mapping of them,
    an operator or a closure over any of those (a `Replicas`); entries on
    one device share one copy, so a mesh that repeats a card copies
    nothing.
  - `sharded_sampler(sample_fn, mesh)` splits every batch argument (a
    tensor whose leading axis is the batch, the list of per-image
    generators) into equal shards, picks each entry's copy of a `Replicas`
    argument, runs the shards and joins their outputs on the caller's
    device. A batch the mesh size does not divide runs unsharded on the
    first entry, with a warning once per (size, batch), as the JAX
    package's mesh replicates a leaf it cannot shard.

On a card each shard runs inside torch.cuda.device(d) and on a stream of
its own entry: its inputs are taken after an event on the caller's stream
(or copied by a copy that the caller's stream orders), and the caller's
stream waits on one event per shard (or on the copy back) before the
joined output is read, so a host copy enqueued after the call sees every
shard's result. Each shard draws from the generators of its own images,
moved to its device with their state where the device differs, so an
image's noise depends on (seed, global index, stream) alone, whichever
shard it lands in. Launches made while a shard runs (its backward on
autograd's device thread too) are counted under its index as well
(ops.tagged_launch_counts).

Under the scan loop driver (sampling/graphs.py, what "auto" resolves to
on a mesh, as JAX's scan runs on sharded arrays) each entry's trajectory
is a CUDA graph of its own (`graphs.placed(entry=i)`): captured on the
entry's card at the first call of its key, replayed on the entry's stream,
its per-image generators (cloned to the entry's card) in the graph's
generator slots, and its launches counted under the entry's index at each
replay. Two entries of one card keep two graphs, whose replays on the two
streams may overlap, and share the card's pool budget.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import types
from typing import Callable, Optional, Sequence

import torch

from ddnm_tpu_torch.ops import _build
from ddnm_tpu_torch.sampling import graphs

__all__ = ["DATA_AXIS", "Mesh", "Replicas", "make_mesh", "replicate", "replicate_all",
           "shard_batch", "sharded_sampler", "clone_generator"]

DATA_AXIS = "data"

logger = logging.getLogger("ddnm_tpu_torch")
_warned: set = set()  # (axis, mesh size, dimension) combinations already reported


def warn_unsharded(axis: str, n: int, dim: int) -> None:
    """Log once that a mesh axis of size n does not divide a dimension."""
    key = (axis, n, dim)
    if key not in _warned:
        _warned.add(key)
        logger.warning("mesh axis %r (size %d) does not divide dimension %d: that call runs "
                       "unsharded on the first entry (no speedup from the others)", axis, n, dim)


def _normalise(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {device!r} (cuda | cpu)")
    return dev


class Mesh:
    """The ordered devices of a 1-D data mesh (axis "data"), with a CUDA
    stream per entry, made at first use."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_normalise(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"a mesh holds devices of one type, got {self.devices}")
        self._streams = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def streams(self) -> tuple:
        """One CUDA stream per entry (None on the CPU), made once: a
        stream's launch state (GroupNorm's counters) lives as long as it."""
        if self._streams is None:
            self._streams = tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                                  for d in self.devices)
        return self._streams


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None, *,
              device="cuda") -> Mesh:
    """1-D data mesh over the first `n_devices` of `devices` (default: every
    visible card; with device="cpu", n_devices entries of the CPU). Raises
    ValueError when more devices are asked for than exist."""
    if devices is None:
        dev = torch.device(device)
        if dev.type == "cpu":
            devices = [dev] * (1 if n_devices is None else n_devices)
        elif dev.index is not None:
            devices = [dev]
        else:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


class Replicas(tuple):
    """One value per mesh entry (`replicate`); entries of one device are
    one object."""

    def map(self, fn: Callable) -> "Replicas":
        """fn of each entry, called once per distinct object."""
        done: dict = {}
        for v in self:
            if id(v) not in done:
                done[id(v)] = fn(v)
        return Replicas(done[id(v)] for v in self)


def clone_generator(g: torch.Generator, device) -> torch.Generator:
    """A generator of `device` in the state of `g` (the same numbers next)."""
    h = torch.Generator(device=device)
    h.set_state(g.get_state())
    return h


def _walks(obj) -> bool:
    """Objects whose attributes `to_device` moves: dataclass instances and
    the port's own classes (operators, tables); anything else is kept."""
    if isinstance(obj, type):
        return False
    return dataclasses.is_dataclass(obj) or type(obj).__module__.startswith("ddnm_tpu_torch.")


def _module_to(m: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    tensors = list(m.parameters()) + list(m.buffers())
    if all(t.device == dev for t in tensors):
        return m
    memo = {}
    for p in m.parameters():
        memo[id(p)] = torch.nn.Parameter(p.detach().to(dev), requires_grad=p.requires_grad)
    for b in m.buffers():
        memo[id(b)] = b.to(dev)
    return copy.deepcopy(m, memo)


def _function_to(f: types.FunctionType, dev: torch.device, memo: dict):
    cells = tuple(types.CellType() for _ in f.__closure__)
    new = types.FunctionType(f.__code__, f.__globals__, f.__name__, f.__defaults__, cells)
    memo[id(f)] = new  # a closure that reaches itself gets the copy
    moved = []
    for c in f.__closure__:
        try:
            v = c.cell_contents
        except ValueError:  # an empty cell
            moved.append((False, None))
            continue
        moved.append((True, to_device(v, dev, memo)))
    if all(not full or v is c.cell_contents for (full, v), c in zip(moved, f.__closure__)):
        memo[id(f)] = f
        return f
    for cell, (full, v) in zip(cells, moved):
        if full:
            cell.cell_contents = v
    new.__kwdefaults__ = f.__kwdefaults__
    new.__qualname__ = f.__qualname__
    new.__dict__.update(f.__dict__)
    return new


def to_device(obj, dev: torch.device, memo: Optional[dict] = None):
    """`obj` with every tensor, module and generator it holds on `dev`:
    tensors, modules (their parameters and buffers; a deep copy), dicts,
    lists and tuples, closures (their cells) and the attributes of
    dataclasses and of the port's own classes (the operators). Returns
    `obj` itself where nothing moves."""
    memo = {} if memo is None else memo
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, torch.Tensor):
        out = obj if obj.device == dev else obj.to(dev)
    elif isinstance(obj, torch.nn.Module):
        out = _module_to(obj, dev)
    elif isinstance(obj, torch.Generator):
        out = obj if obj.device == dev else clone_generator(obj, dev)
    elif isinstance(obj, types.FunctionType) and obj.__closure__:
        out = _function_to(obj, dev, memo)
    elif isinstance(obj, dict):
        items = {k: to_device(v, dev, memo) for k, v in obj.items()}
        out = obj if all(items[k] is v for k, v in obj.items()) else type(obj)(items)
    elif isinstance(obj, (list, tuple)):
        items = [to_device(v, dev, memo) for v in obj]
        out = obj if all(a is b for a, b in zip(items, obj)) else type(obj)(items)
    elif _walks(obj) and hasattr(obj, "__dict__"):
        attrs = {k: to_device(v, dev, memo) for k, v in vars(obj).items()}
        if all(attrs[k] is v for k, v in vars(obj).items()):
            out = obj
        else:
            out = copy.copy(obj)
            vars(out).update(attrs)  # frozen dataclasses too
    else:
        out = obj
    memo[key] = out
    return out


def replicate(mesh: Mesh, value) -> Replicas:
    """One copy of `value` per mesh entry, on the entry's device (entries
    of one device share one copy; the copy on `value`'s own device is
    `value`). A `Replicas` of the mesh's size is returned as it is."""
    if isinstance(value, Replicas):
        if len(value) != mesh.size:
            raise ValueError(f"{len(value)} replicas for a mesh of {mesh.size}")
        return value
    per_device: dict = {}
    for d in mesh.devices:
        if d not in per_device:
            per_device[d] = to_device(value, d)
    return Replicas(per_device[d] for d in mesh.devices)


def replicate_all(mesh: Mesh, *values) -> tuple:
    """`replicate` of each value, in one pass, so that what they share (the
    model in several closures) is copied once a device; a `Replicas` is
    kept as it is."""
    todo = [v for v in values if not isinstance(v, Replicas)]
    reps = replicate(mesh, tuple(todo))
    parts = iter([reps.map(lambda t, k=k: t[k]) for k in range(len(todo))])
    return tuple(v if isinstance(v, Replicas) else next(parts) for v in values)


def _is_generators(x) -> bool:
    return isinstance(x, (list, tuple)) and bool(x) and all(
        isinstance(g, torch.Generator) for g in x)


def shard_batch(mesh: Mesh, tree):
    """Split the leading (batch) axis of every tensor (and every list of
    per-image generators) of `tree` into mesh.size equal shards, each on
    its entry's device: each leaf becomes a tuple of shards. Raises
    ValueError where the size does not divide."""
    if isinstance(tree, torch.Tensor) or _is_generators(tree):
        n = len(tree)
        if n % mesh.size:
            raise ValueError(f"batch {n} does not divide over the {mesh.size}-entry mesh")
        k = n // mesh.size
        return tuple(_take(tree, slice(i * k, (i + 1) * k), d)
                     for i, d in enumerate(mesh.devices))
    if isinstance(tree, dict):
        return {key: shard_batch(mesh, v) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return tree


def _take(x, sl: slice, dev: torch.device):
    """Rows `sl` of a batch leaf on `dev` (a view where it is there)."""
    if isinstance(x, torch.Tensor):
        part = x[sl]
        return part if part.device == dev else part.to(dev, non_blocking=True)
    return [g if g.device == dev else clone_generator(g, dev) for g in x[sl]]


def _batch_size(args, kw) -> Optional[int]:
    for v in list(args) + list(kw.values()):
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            return int(v.shape[0])
    return None


def _pick(value, i: int, n: int, sl: slice, dev: torch.device, record):
    """Entry i's argument: its replica, its rows of a batch leaf, a tensor
    on its device, or the value as it is."""
    if isinstance(value, Replicas):
        return value[i]
    if isinstance(value, torch.Tensor):
        if value.ndim >= 1 and value.shape[0] == n:
            part = _take(value, sl, dev)
        else:
            part = value if value.device == dev else value.to(dev, non_blocking=True)
        if part.device.type == "cuda" and part.device == value.device:
            record(part)
        return part
    if _is_generators(value) and len(value) == n:
        return _take(value, sl, dev)
    return value


def _map_tensors(out, fn):
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_map_tensors(o, fn) for o in out)
    if isinstance(out, dict):
        return {k: _map_tensors(v, fn) for k, v in out.items()}
    return out


def _join(outs: list):
    first = outs[0]
    if len(outs) == 1:
        return first
    if isinstance(first, torch.Tensor):
        return torch.cat(outs)
    if isinstance(first, (list, tuple)):
        return type(first)(_join([o[j] for o in outs]) for j in range(len(first)))
    if isinstance(first, dict):
        return {k: _join([o[k] for o in outs]) for k in first}
    return first


def sharded_sampler(sample_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap `sample_fn(*args, **kw)` so that its batch runs sharded over
    `mesh` (module docstring): the batch size is the leading dimension of
    the first tensor argument; `Replicas` arguments give each entry its
    copy (the model's closure, the operator, the guidance hook); tensors
    with that leading dimension and the list of per-image generators are
    split; other tensors are copied to each entry's device; the rest is
    passed as it is. Returns sample_fn's output with its tensors joined
    along the batch on the caller's device."""

    def wrapped(*args, **kw):
        n = _batch_size(args, kw)
        if n is None:
            raise ValueError("sharded_sampler needs a tensor argument (the batch)")
        k = mesh.size
        if n % k:
            warn_unsharded(DATA_AXIS, k, n)
            plan = [(0, slice(0, n))]
        else:
            plan = [(i, slice(i * (n // k), (i + 1) * (n // k))) for i in range(k)]
        caller = next(v.device for v in list(args) + list(kw.values())
                      if isinstance(v, torch.Tensor) and v.ndim >= 1)
        return _run(sample_fn, mesh, args, kw, n, plan, caller)

    return wrapped


def _run(sample_fn, mesh: Mesh, args, kw, n: int, plan, caller: torch.device):
    if not mesh.is_cuda:
        outs = []
        for i, sl in plan:
            dev = mesh.devices[i]
            with _build.launch_tag(i), graphs.placed(entry=i):
                a = [_pick(v, i, n, sl, dev, None) for v in args]
                k = {key: _pick(v, i, n, sl, dev, None) for key, v in kw.items()}
                outs.append(sample_fn(*a, **k))
        return _join(outs)
    caller_stream = torch.cuda.current_stream(caller)
    ready = torch.cuda.Event()
    ready.record(caller_stream)
    streams = mesh.streams()
    outs, done = [], []
    for i, sl in plan:
        dev, s = mesh.devices[i], streams[i]
        with (_build.launch_tag(i), graphs.placed(entry=i), torch.cuda.device(dev),
              torch.cuda.stream(s)):
            record = lambda t, s=s: t.record_stream(s)
            if dev == caller:
                s.wait_event(ready)
                a = [_pick(v, i, n, sl, dev, record) for v in args]
                k = {key: _pick(v, i, n, sl, dev, record) for key, v in kw.items()}
            else:
                # a copy between cards runs on the source's current
                # stream and orders the destination's after it
                with torch.cuda.stream(caller_stream):
                    a = [_pick(v, i, n, sl, dev, record) for v in args]
                    k = {key: _pick(v, i, n, sl, dev, record) for key, v in kw.items()}
            out = sample_fn(*a, **k)
            if dev == caller:
                ev = torch.cuda.Event()
                ev.record(s)
                done.append((ev, out))
        outs.append(out)
    # the copies back only once every shard is launched: a copy between
    # cards makes the caller's stream wait on the shard, and the next
    # shard's inputs are copied on the caller's stream
    for j, (i, _) in enumerate(plan):
        dev, s = mesh.devices[i], streams[i]
        if dev != caller:
            with torch.cuda.device(dev), torch.cuda.stream(s), torch.cuda.stream(caller_stream):
                outs[j] = _map_tensors(outs[j], lambda t: t.to(caller, non_blocking=True))
    for ev, out in done:
        caller_stream.wait_event(ev)
        _map_tensors(out, lambda t: t.record_stream(caller_stream))
    return _join(outs)
