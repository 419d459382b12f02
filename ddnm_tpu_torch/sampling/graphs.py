"""The scan loop driver: a sampler's whole trajectory as one CUDA graph.

The JAX package drives a trajectory either as one `lax.scan` under
`jax.jit` (`_run_scan`, one device program) or from the host, one jitted
step a timestep (`_run_host`), and `auto` picks the scan on every local
backend (ddnm_tpu/sampling/ddnm.py `_resolve_loop`, posterior.py
`_resolve_posterior_loop`). This module plays the part `jax.jit` plays
for the scan. A sampler hands `run` the body of its trajectory, unrolled
over the static schedule, and `run` makes it one program on the card: a
`torch.cuda.CUDAGraph`, captured once per key and then replayed.

  - Capture: the body runs first on a few representative steps (the
    first step of each kind after each kind) on a side stream of the device, with
    throwaway noise sources, so that every lazy set-up (the kernels'
    build, their function attributes, cuBLAS and cuDNN workspaces) happens
    outside the graph and the caller's generators and key are not
    consumed. Then the whole trajectory is captured on that stream in
    `thread_local` mode (another thread may wait on an event meanwhile:
    the runner's drain pool), instantiated, and replayed for this call.
    A failure to capture or to replay raises; nothing falls back to the
    eager loop.
  - Static buffers: the graph reads its tensor inputs (x_T, y or A+y, the
    masks, the operator context) from copies it owns; a call copies its
    inputs in, replays, and returns copies of the outputs. The model,
    the operator, the guidance hook and the schedule are read as they were
    at capture: parameters updated in place (`RestorationService.
    swap_params`, `load_state_dict`) are seen, a parameter rebound to a new
    tensor is not (`clear_graphs` then).
  - The key: the sampler's name, its model, operator, schedule, eta,
    sigma_y, solver, guidance hook and noise function (`_fingerprint`:
    numbers and arrays by value, a function by its code and the objects it
    closes over, a frozen dataclass by its fields; a module, a tensor or
    any other object by identity, kept alive by the entry, with its plain
    settings by value and where its tensors live, so that `set_op_force`
    or a moved parameter makes another key), the inputs' shapes, strides,
    dtypes and devices, the noise source's kind, and the cuDNN / TF32
    flags.
  - Noise: every step draws what the eager loop draws, in its order.
    Per-image `torch.Generator`s get slots, generators of the graph's own
    registered with it (`CUDAGraph.register_generator_state`); a replay
    sets each slot's state from the caller's generator and copies the
    advanced state back, so the caller's generators end where the eager
    loop leaves them (tiles bring fresh generators every call). A
    `threefry.KeyNoise` key is a static buffer, split inside the graph, and
    the final key is copied back. A `noise_fn` is captured as the kernels it
    launches: it must draw from the generators it is given, or be constant.
  - Launch counts: a launch on the side stream during a capture is
    recorded in the graph's table (ops/_build.py `count_launch`), each
    replay adds that table to the wrappers' counters and under the current
    launch tag; the warm-up's launches are not counted. The GroupNorm
    kernels' launch counters are the graph's own, allocated in the warm-up.
  - Memory: each graph keeps one private memory pool, reused by its
    replays. At most `MAX_GRAPHS` graphs are kept a place (a device, or a
    mesh entry), and the pools of one card's graphs take at most
    `POOL_BUDGET` of its memory (least recently used dropped first; a
    256 px fp32 trajectory with TF32 off holds ~18 GB, a bf16 batch-8 one
    ~1.9 GB); a capture that runs out of memory drops the kept graphs and
    captures once more. `clear_graphs` drops them all and
    returns their pools, and a `scope()` drops those captured inside it
    (the runner's run, the hq CLI's images).

Over a mesh (JAX runs its scan on sharded arrays, one program a
trajectory): the samplers of a shard run inside `placed`, which names the
mesh entry or the spatial group they run in.

  - A data mesh's entry (parallel/mesh.py): each entry's trajectory is a
    graph of its own, captured on the entry's card and replayed on the
    entry's stream, so that two entries of one card keep two graphs whose
    replays may overlap. The key holds the device and the entry's index.
  - A rank of a spatial group (parallel/spatial.py `grid_sampler`): the
    rank's sharded trajectory is one graph, its NCCL collectives (halo
    rows, GroupNorm sums, attention keys, the model output's rows, and
    the guidance backward's) captured inside it. The key holds the group
    by identity. Every capture-or-replay decision is agreed over the group
    (`SpatialGroup.agree`, one small gloo collective before the
    trajectory, outside the graph): a rank that lacks the graph (dropped,
    evicted, or never captured) makes every rank capture, and an
    out-of-memory capture on one rank makes every rank drop its graphs and
    capture once more, so that no rank replays while another runs the
    warm-up's eager collectives. A rank that fails otherwise raises on
    every rank. The collectives a capture issues are recorded like its
    launches and counted at each replay (`count_collective`).
  - Not capturable: a spatial group over gloo whose tensors live on a card
    (gloo's collectives copy through host memory, which a graph cannot
    hold). There `auto` is `host` and `scan` raises (`SCAN_OVER_GLOO`);
    `host_only` marks such a block.

On a CPU tensor, or while torch.export traces the sampler, `run` runs the
same body eagerly: the CPU has no graphs, and a tracer makes the unrolled
body one program itself (serving.py). The port has no remote-compile
backend, so JAX's size-aware `auto` (`_AUTO_SCAN_PARAM_BYTES`, host for
big models on that backend) has no counterpart: `auto` is the scan, except
with the encoder cache (sampling/accel.py is host-only, in JAX too) and on
a gloo spatial group on a card.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import itertools
import threading
import time
import types
from typing import Callable, Sequence

import numpy as np
import torch

from ddnm_tpu_torch.ops import _build
from ddnm_tpu_torch.sampling.threefry import KeyNoise

__all__ = ["LOOPS", "MAX_GRAPHS", "SCAN_OVER_GLOO", "capturable", "clear_graphs", "capturing",
           "count_collective", "graph_stats", "host_only", "placed", "recording",
           "resolve_loop", "run", "scope"]

LOOPS = ("auto", "host", "scan")
# graphs kept at once a place (a device, or a mesh entry): a Mask-Shift
# canvas runs wavefront groups of up to six sizes (1 and 4-8 tiles), each
# a graph of its own
MAX_GRAPHS = 8
# the share of a card's memory its kept graphs' pools may hold together
# (the entries of a mesh that repeats the card share it)
POOL_BUDGET = 0.25
SCAN_OVER_GLOO = (
    "loop='scan' cannot capture a spatial group over gloo whose tensors are on a card: "
    "gloo's collectives copy through host memory, which a CUDA graph cannot hold; give "
    "each rank of the group a card of its own (NCCL), or use loop='auto' or 'host'")
ENCODER_CACHE_SCAN = ("encoder_cache > 1 uses the host-driven accel samplers "
                      "(sampling/accel.py); loop='scan' is incompatible")

_CACHE: collections.OrderedDict = collections.OrderedDict()
_LOCK = threading.RLock()
_LOCAL = threading.local()
_STREAMS: dict = {}
_DEPTH = 8  # closures followed this deep; deeper objects count by identity


def capturable(mesh) -> bool:
    """Whether a trajectory over `mesh` can be one graph a shard: a data
    mesh always, a grid at sp 1 (no collective inside the trajectory), a
    grid at sp > 1 where its spatial group is NCCL or its tensors are on
    the CPU; not a gloo spatial group on a card (module docstring)."""
    spatial = getattr(mesh, "spatial", None)
    if spatial is None or spatial.size == 1 or spatial.backend != "gloo":
        return True
    return torch.device(mesh.device).type == "cpu"


def resolve_loop(loop: str, *, mesh=None, encoder_cache: int = 1) -> str:
    """The loop driver `loop` names: "auto" is "scan", as JAX's
    `_resolve_loop` is on a local backend, on one device and over a data
    mesh or a spatial grid (`mesh`, where `capturable`); over a gloo
    spatial group on a card (`mesh` not capturable, or inside `host_only`)
    "auto" is "host" and "scan" raises ValueError(SCAN_OVER_GLOO); with
    `encoder_cache > 1` "auto" is "host" and "scan" raises ValueError (the
    service's refusal). Another value raises ValueError."""
    if loop not in LOOPS:
        raise ValueError(f"loop must be auto|host|scan, got {loop!r}")
    if encoder_cache > 1:
        if loop == "scan":
            raise ValueError(ENCODER_CACHE_SCAN)
        return "host"
    if (mesh is not None and not capturable(mesh)) or getattr(_LOCAL, "host_only", 0):
        if loop == "scan":
            raise ValueError(SCAN_OVER_GLOO)
        return "host"
    return "scan" if loop == "auto" else loop


@contextlib.contextmanager
def host_only():
    """Samplers called inside the block run host-driven (`resolve_loop`):
    the ranks of a gloo spatial group on a card (parallel/spatial.py
    `grid_sampler`), or a model wrapped over such a group and called
    without it."""
    _LOCAL.host_only = getattr(_LOCAL, "host_only", 0) + 1
    try:
        yield
    finally:
        _LOCAL.host_only -= 1


@contextlib.contextmanager
def placed(*, entry=None, spatial=None):
    """Samplers called inside the block run as mesh entry `entry`'s shard
    (parallel/mesh.py) or as this process's rank of `spatial`, a
    SpatialGroup (parallel/spatial.py `grid_sampler`): their graphs are
    keyed by it, and a group of more than one rank agrees on every
    capture (module docstring)."""
    prev = getattr(_LOCAL, "place", None)
    _LOCAL.place = (entry, spatial)
    try:
        yield
    finally:
        _LOCAL.place = prev


def recording() -> bool:
    """True while some thread warms up, captures or replays a graph's body
    (`run`): a host copy there cannot be captured (parallel/spatial.py)."""
    return _build._capture is not None


def count_collective(table: dict, kind: str) -> None:
    """Count one collective of `kind` in `table` (parallel/spatial.py
    `COLLECTIVES`). One issued on the stream of a graph's warm-up or
    capture goes to that graph instead, which adds its table at each
    replay, as `_build.count_launch` does for a launch."""
    cap = _build._capture
    if cap is not None and cap.owns_stream():
        cap.record_collective(table, kind)
        return
    table[kind] += 1


def capturing() -> bool:
    """True while this thread warms up or captures a graph: a host-side
    draw copied onto the card cannot be captured (sampling/rng.py)."""
    return getattr(_LOCAL, "capturing", False)


def _warm_steps(kinds: Sequence) -> list[int]:
    """The steps a warm-up runs, in order: the first step of each kind
    after each kind (or after none). A step's input comes from the step
    before it, so each kind meets every layout its input takes in the
    trajectory (a layout's first call may probe it: server.py
    `_LanePinnedConv`)."""
    seen, out, prev = set(), [], None
    for i, k in enumerate(kinds):
        if (k, prev) not in seen:
            seen.add((k, prev))
            out.append(i)
        prev = k
    return out


# ------------------------------------------------------------------ the key


def _fingerprint(obj, pins: list, depth: int = 0):
    """A hashable stand-in for `obj` in a graph's key (module docstring);
    objects taken by identity are appended to `pins`, which the entry keeps
    alive, so that no other object takes their id meanwhile."""
    if obj is None or isinstance(obj, (bool, int, float, complex, str, bytes)):
        return (type(obj).__name__, obj)
    if isinstance(obj, (torch.dtype, torch.device)):
        return ("torch", str(obj))
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, np.generic):
        return ("numpy", obj.dtype.str, obj.item())
    if depth < _DEPTH:
        fp = functools.partial(_fingerprint, pins=pins, depth=depth + 1)
        if isinstance(obj, (tuple, list)):
            return (type(obj).__name__, tuple(fp(o) for o in obj))
        if isinstance(obj, dict):
            return ("dict", tuple((fp(k), fp(v)) for k, v in obj.items()))
        if isinstance(obj, functools.partial):
            return ("partial", fp(obj.func), fp(obj.args), fp(obj.keywords))
        if isinstance(obj, types.MethodType):
            return ("method", fp(obj.__func__), fp(obj.__self__))
        if isinstance(obj, types.FunctionType):
            pins.append(obj.__code__)
            cells = tuple(fp(_cell(c)) for c in obj.__closure__ or ())
            return ("function", id(obj.__code__), cells, fp(obj.__defaults__),
                    fp(obj.__kwdefaults__))
        if (dataclasses.is_dataclass(obj) and not isinstance(obj, type)
                and obj.__dataclass_params__.frozen):
            return (type(obj).__qualname__, id(type(obj)),
                    tuple(fp(getattr(obj, f.name)) for f in dataclasses.fields(obj)))
    pins.append(obj)
    if isinstance(obj, torch.Tensor):
        return ("tensor", id(obj), _place(obj))
    if isinstance(obj, torch.nn.Module):
        # its modules' settings (`force`, `training`, ...) and where its
        # parameters and buffers live: what the graph read at capture
        return ("module", id(obj), tuple(_attrs(m) for m in obj.modules()),
                tuple(_place(t) for t in itertools.chain(obj.parameters(), obj.buffers())))
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return ("object", id(obj), _attrs(obj))
    return ("id", id(obj))


def _place(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)


def _attrs(obj) -> tuple:
    """An object's plain attributes by value and its tensors by place (a
    setting changed, or a tensor rebound, makes another key)."""
    out = []
    for k, v in vars(obj).items():
        if v is None or isinstance(v, (bool, int, float, str, torch.dtype, torch.device)):
            out.append((k, v))
        elif isinstance(v, torch.Tensor):
            out.append((k, _place(v)))
    return tuple(out)


def _cell(cell):
    try:
        return cell.cell_contents
    except ValueError:  # an empty cell (a name bound later)
        return None


def _dense_strides(t: torch.Tensor):
    """t's strides if its elements tile its storage without overlap or gaps
    (a permuted contiguous tensor too), else None (an expanded view)."""
    expect = 1
    for d in sorted(range(t.ndim), key=lambda d: (t.stride(d), t.size(d))):
        if t.size(d) != 1 and t.stride(d) != expect:
            return None
        expect *= t.size(d)
    return tuple(t.stride())


def _spec(t):
    if t is None:
        return None
    return (tuple(t.shape), _dense_strides(t), t.dtype, t.device, t.requires_grad)


def _static_copy(t):
    """A buffer the graph owns, with t's strides where t is dense (so that
    every op sees the layout the eager loop sees), else contiguous."""
    if t is None:
        return None
    strides = _dense_strides(t)
    buf = (torch.empty_strided(t.shape, strides, dtype=t.dtype, device=t.device)
           if strides is not None else torch.empty(t.shape, dtype=t.dtype, device=t.device))
    return buf.copy_(t)


def _noise_spec(noise, pins: list):
    if isinstance(noise, KeyNoise):
        return ("key", tuple(noise.key.shape), str(noise.key.device))
    return ("sources", tuple(("generator", str(g.device)) if isinstance(g, torch.Generator)
                             else _fingerprint(g, pins) for g in noise))


def _flags():
    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.is_grad_enabled())


# ------------------------------------------------------------ the CUDA graph


def _side_stream(device: torch.device):
    """The stream of every warm-up and capture on `device`: no eager work
    of the program runs on it."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    s = _STREAMS.get(index)
    if s is None:
        s = _STREAMS[index] = torch.cuda.Stream(device=index)
    return s


class _CudaGraph:
    """A torch.cuda.CUDAGraph captured on the device's side stream,
    instantiated apart (keep_graph), replayed on the caller's stream;
    replays of one graph are ordered by an event, whatever their streams."""

    def __init__(self, device: torch.device):
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        self.stream = _side_stream(device)
        self.handle = self.stream.cuda_stream
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.done = None
        self.pool_estimate = 0  # bytes the capture reserved (its pool)
        self.budget = POOL_BUDGET * torch.cuda.get_device_properties(self.index).total_memory

    def owns_stream(self) -> bool:
        return torch._C._cuda_getCurrentRawStream(self.index) == self.handle

    def register_generator(self, gen: torch.Generator) -> None:
        # a CPU generator's draw is copied to the card, which rng.py refuses
        # in the warm-up already
        if gen.device.type == "cuda":
            self.graph.register_generator_state(gen)

    def _on_side(self, fn):
        cur = torch.cuda.current_stream(self.index)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def warm(self, fn) -> None:
        self._on_side(fn)
        torch.cuda.synchronize(self.index)

    def capture(self, fn):
        def captured():
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                with contextlib.suppress(Exception):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
            return out

        reserved = torch.cuda.memory_reserved(self.index)
        out = self._on_side(captured)
        self.pool_estimate = max(0, torch.cuda.memory_reserved(self.index) - reserved)
        return out

    def instantiate(self) -> None:
        self.graph.instantiate()

    def begin(self) -> None:
        if self.done is not None:
            torch.cuda.current_stream(self.index).wait_event(self.done)

    def replay(self, rerun):
        self.graph.replay()

    def end(self) -> None:
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(self.index))

    def release(self) -> None:
        if self.done is not None:
            self.done.synchronize()
        self.graph.reset()

    def pool_bytes(self) -> int:
        pool = tuple(self.graph.pool())
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


# the graph of each device type; a device type without one runs eagerly
_BACKENDS: dict = {"cuda": _CudaGraph}


class _Entry:
    """One captured trajectory: its graph, static buffers, noise slots,
    launch table and GroupNorm counters, and what its capture cost."""

    def __init__(self, graph, key, pins, body, inputs, noise, label):
        self.graph, self.key, self.pins, self.body = graph, key, pins, body
        self.phase = "warm"
        self.launches: dict = {}
        self.collectives: dict = {}
        self._counters: dict = {}
        self.static = [_static_copy(t) for t in inputs]
        self.outputs = None
        self.stats = dict(label, replays=0)
        if isinstance(noise, KeyNoise):
            self.key_in = noise.key.clone()
            self.slot = copy.copy(noise)
            self.pairs = []
        else:
            self.key_in = None
            self.slot = [torch.Generator(device=g.device) if isinstance(g, torch.Generator)
                         else g for g in noise]
            self.pairs = [i for i, g in enumerate(noise) if isinstance(g, torch.Generator)]
            for i in self.pairs:
                graph.register_generator(self.slot[i])

    # the hooks of ops/_build.py `_capture` (and ops/groupnorm.py `_counters`)
    def owns_stream(self) -> bool:
        return self.graph.owns_stream()

    def record(self, table: dict, name: str) -> None:
        if self.phase == "capture":
            rec = self.launches.setdefault((id(table), name), [table, name, 0])
            rec[2] += 1

    def record_collective(self, table: dict, kind: str) -> None:
        if self.phase == "capture":
            rec = self.collectives.setdefault((id(table), kind), [table, kind, 0])
            rec[2] += 1

    def counters(self, device, n: int) -> torch.Tensor:
        c = self._counters.get(device.index)
        if c is None or c.numel() < n:
            if self.phase != "warm":
                raise RuntimeError(
                    f"a GroupNorm launch in the capture needs {n} launch counters, more than "
                    "its warm-up allocated: the warm-up must run every kind of step")
            c = self._counters[device.index] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                                           device=device)
        return c

    @contextlib.contextmanager
    def _in(self, phase: str):
        prev = _build._capture
        self.phase, _build._capture = phase, self
        _LOCAL.capturing = phase in ("warm", "capture")
        try:
            yield
        finally:
            _build._capture, _LOCAL.capturing = prev, False

    def _trace(self):
        """The body on the static inputs and the noise slots: what the
        graph captures (and a stand-in graph reruns at each replay)."""
        if self.key_in is not None:
            self.slot.key = self.key_in
        out = self.body(*self.static, noise=self.slot)
        self.key_out = self.slot.key if self.key_in is not None else None
        return tuple(out)

    def capture(self, noise, warm: Sequence[int]) -> None:
        if self.key_in is not None:
            throwaway = copy.copy(noise)
            throwaway.key = noise.key.clone()
        else:
            throwaway = [_clone_generator(g) if isinstance(g, torch.Generator) else g
                         for g in noise]
        t0 = time.perf_counter()
        with self._in("warm"):
            self.graph.warm(lambda: self.body(*self.static, noise=throwaway, steps=warm))
        t1 = time.perf_counter()
        with self._in("capture"):
            self.outputs = self.graph.capture(self._trace)
        t2 = time.perf_counter()
        self.graph.instantiate()
        t3 = time.perf_counter()
        self.stats.update(warmup_s=t1 - t0, capture_s=t2 - t1, instantiate_s=t3 - t2,
                          launches_per_replay={n: c for _, n, c in self.launches.values()},
                          collectives_per_replay={k: c for _, k, c in
                                                  self.collectives.values()})

    def replay(self, inputs, noise) -> tuple:
        self.graph.begin()
        for buf, t in zip(self.static, inputs):
            if t is not None and t is not buf:
                buf.copy_(t)
        if self.key_in is not None:
            self.key_in.copy_(noise.key)
        for i in self.pairs:
            self.slot[i].set_state(noise[i].get_state())
        with self._in("replay"):
            out = self.graph.replay(self._trace)
        if out is not None:  # a stand-in graph reran the body
            self.outputs = out
        for table, name, n in self.launches.values():
            _build.count_launch(table, name, n)
        for table, kind, n in self.collectives.values():
            table[kind] += n
        if self.key_in is not None:
            noise.key = self.key_out.clone()
        for i in self.pairs:
            noise[i].set_state(self.slot[i].get_state())
        result = tuple(o.clone() for o in self.outputs)
        self.graph.end()
        self.stats["replays"] += 1
        return result

    def release(self) -> None:
        self.graph.release()
        self.outputs = self.static = self.body = self.pins = None


def _clone_generator(g: torch.Generator) -> torch.Generator:
    w = torch.Generator(device=g.device)
    w.set_state(g.get_state())
    return w


# --------------------------------------------------------------- the driver


def run(parts: tuple, make_body: Callable, inputs: Sequence, noise, kinds: Sequence) -> tuple:
    """Run a trajectory as one program. `make_body()` returns `body(*inputs,
    noise, steps=None) -> tuple of tensors`, the trajectory unrolled over
    its static schedule (every step when `steps` is None, else those);
    `parts` names what the body closes over (the key's sampler part);
    `inputs` are its tensors (x_T first; None where absent); `noise` the
    caller's generators (a list, None entries allowed) or KeyNoise; `kinds`
    each step's kind (hashable), which picks the warm-up's steps. On a
    device without graphs, or under a tracer, the body runs eagerly on the
    caller's inputs. Inside `placed`, the graph is the mesh entry's or the
    spatial rank's, and a spatial group agrees on its capture."""
    x = inputs[0]
    backend = _BACKENDS.get(x.device.type)
    if backend is None or _build.tracing(x):
        return tuple(make_body()(*inputs, noise=noise))
    entry_index, spatial = getattr(_LOCAL, "place", None) or (None, None)
    group = spatial if spatial is not None and spatial.size > 1 else None
    with _LOCK:
        pins: list = [spatial]
        key = (_fingerprint(parts, pins), tuple(_spec(t) for t in inputs),
               _noise_spec(noise, pins), _flags(),
               ("place", str(x.device), entry_index, id(spatial)))
        entry = _CACHE.get(key)
        if group is not None and not all(group.agree(int(entry is not None))):
            # a member lacks this graph: every member captures it afresh
            if entry is not None:
                _CACHE.pop(key).release()
            entry = None
        if entry is None:
            label = {"sampler": parts[0], "shape": tuple(x.shape), "dtype": str(x.dtype),
                     "device": str(x.device), "entry": entry_index}

            def capture():
                entry = _Entry(backend(x.device), key, pins, make_body(), inputs, noise, label)
                entry.capture(noise, _warm_steps(kinds))
                return entry

            entry = _capture(capture, group)
            _CACHE[key] = entry
            for keys in getattr(_LOCAL, "scopes", ()):
                keys.append(key)
            _evict()
        else:
            _CACHE.move_to_end(key)
        return entry.replay(inputs, noise)


def _out_of_memory(err: BaseException) -> bool:
    return isinstance(err, RuntimeError) and "out of memory" in str(err)


def _capture(capture: Callable, group) -> "_Entry":
    """capture(), once more after dropping the kept graphs where it ran out
    of memory (their pools hold what it needs). With a spatial `group`
    every member decides alike: each capture's outcome is agreed, an
    out-of-memory capture on any member makes every member drop its graphs
    and capture again, and any other failure raises on every member."""
    if group is None:
        try:
            return capture()
        except RuntimeError as err:  # torch.OutOfMemoryError, a CUDA error
            if not _out_of_memory(err) or not _CACHE:
                raise
            clear_graphs()
            return capture()
    retry = False
    while True:
        entry = err = None
        try:
            entry = capture()
        except Exception as e:  # agreed on below, then raised
            err = e
        every = group.agree(0 if err is None else 1 if _out_of_memory(err) else 2)
        if not any(every):
            return entry
        if entry is not None:
            entry.release()
        if retry or max(every) == 2:
            if err is not None:
                raise err
            failed = [r for r, v in enumerate(every) if v]
            raise RuntimeError(f"spatial rank(s) {failed} failed to capture the trajectory's "
                               "graph: every rank of the group drops it")
        clear_graphs()
        retry = True


def _evict() -> None:
    """Drop the least recently used graphs of the newest graph's place (its
    device and mesh entry) while more than MAX_GRAPHS are kept there, and
    of its card while their pools hold more than POOL_BUDGET of it (the
    newest graph stays)."""
    newest = next(reversed(_CACHE.values()))
    card = getattr(newest.graph, "index", None)
    while True:
        place = [k for k in _CACHE if k[-1] == newest.key[-1]]
        same_card = [k for k, e in _CACHE.items() if getattr(e.graph, "index", None) == card]
        pools = sum(getattr(_CACHE[k].graph, "pool_estimate", 0) for k in same_card)
        if len(place) > MAX_GRAPHS:
            victim = place[0]
        elif len(same_card) > 1 and pools > getattr(newest.graph, "budget", float("inf")):
            victim = same_card[0]
        else:
            return
        _CACHE.pop(victim).release()


def graph_stats() -> list[dict]:
    """Each kept graph, least recently used first: its sampler, x_T's shape,
    dtype and device, its mesh entry (None outside a data mesh), warm-up,
    capture and instantiate seconds, replays, the launches and collectives
    of one replay and its memory pool's bytes (None where the graph has no
    pool of its own)."""
    with _LOCK:
        out = []
        for entry in _CACHE.values():
            pool = getattr(entry.graph, "pool_bytes", None)
            out.append(dict(entry.stats, pool_bytes=pool() if pool is not None else None))
        return out


def clear_graphs() -> None:
    """Drop every kept graph and return their memory pools to the card."""
    with _LOCK:
        entries = list(_CACHE.values())
        _CACHE.clear()
        for entry in entries:
            entry.release()
    if entries and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def scope():
    """Drop the graphs this thread captures inside the block when it ends
    (a run whose model and operator die with it)."""
    keys: list = []
    _LOCAL.scopes = getattr(_LOCAL, "scopes", ()) + (keys,)
    try:
        yield
    finally:
        _LOCAL.scopes = _LOCAL.scopes[:-1]
        with _LOCK:
            dropped = [_CACHE.pop(k) for k in keys if k in _CACHE]
            for entry in dropped:
                entry.release()
        if dropped and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()
