"""Online micro-batching restoration server (port of ddnm_tpu/server.py).

Two pieces, with the JAX module's contract, refusals, HTTP surface and
JSON keys:

  - `RestorationService`, the device side. It owns the models, the DDNM
    schedule, a set of degradation operators and a fixed serving batch
    size. `restore()` pads any group of <= max_batch requests to that size
    and gives every request its own generators, keyed by (base seed, the
    request's sequence number) (sampling/rng.py `image_generators`:
    STREAM_INIT for x_T, STREAM_SAMPLE for the sampler's noise), so a
    request's output is bit-identical whether it runs alone, padded or
    coalesced with strangers. Pad lanes get generators of their own. On a
    card, a convolution whose cuDNN engine computes some lane in another
    order than lane 0 runs one image at a time (`_LanePinnedConv`).

  - `RestorationServer`, a stdlib ThreadingHTTPServer front. Handler
    threads decode uploads into numpy (the port's decoders, data/io.py
    `decode_image`: PNG, JPEG, WebP, BMP, PNM, in PIL's modes) and
    enqueue; ONE worker thread drains the queue (micro-batching with a
    max-wait deadline) and is the only
    thread that touches the device (over a mesh, it launches each group's
    shards in turn). `POST
    /restore?deg=<task>[&input=degraded|gt][&class=N]` with an image
    body returns the restored PNG; `GET /healthz` returns JSON stats (counters,
    realized batch, queue depth, request-latency percentiles).

The worker runs a one-deep dispatch/fetch pipeline. `restore_async`
launches a group's whole trajectory (under `loop` "auto" or "scan" one
replay of the CUDA graph of its task and shapes, captured by the first
group of that key, `warmup` included; under "host" the eager loop's
launches), enqueues the copy of its result into pinned host memory and
records a CUDA event; `fetch` waits on that event, never on the whole
device. The worker dispatches group N+1 before it fetches group N, so
group N's copy-out and the PNG encode of its replies overlap group N+1's
launches. A capture, and the host loop's set-up (it copies the step
tables to the device with a blocking copy), wait for the work queued
before them.

Per-request masks: for context-parameterised tasks (inpainting,
mask_color_sr: FunctionalOperator.A_ctx) a request may upload an RGBA PNG
whose alpha channel is the keep-mask; masked and maskless requests never
share a group. Class-conditional services (`PosteriorRestorationService`)
take one label per request (`?class=N`), carried as params["classes"].

`swap_params` replaces the served weights without landing mid-trajectory:
it stores the new state, and the worker copies it into the models before
the next group it launches, so stream order keeps the group in flight on
the old weights. The copy is in place, so a captured graph reads the new
weights at its next replay; the labels of a class-conditional group are
copied into one buffer of the service's for the same reason.

Several devices (`mesh`, parallel/mesh.py; serve_torch.py `--dp`): the
served params and operators are replicated on each entry (every replica's
convolutions lane-pinned on its own card, at its own batch), and each
padded group shards over the mesh, each entry's requests on a stream of
their own; `max_batch` must divide by the mesh size, and
`swap_params` reaches every replica. A request's reply stays bit-identical
alone, padded or coalesced: its lane lands on the same entry at the same
position of that entry's batch whatever else rides in the group.
"""

from __future__ import annotations

import copy
import json
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Mapping, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ddnm_tpu_torch.data.io import convert, decode_image, encode_png
from ddnm_tpu_torch.data.io import has_alpha as image_has_alpha  # a handler local is has_alpha
from ddnm_tpu_torch.data.transforms import data_transform, inverse_data_transform
from ddnm_tpu_torch.operators.functional import FunctionalOperator
from ddnm_tpu_torch.parallel.mesh import replicate, sharded_sampler
from ddnm_tpu_torch.runtime import to_device, to_host
from ddnm_tpu_torch.sampling import DDNMSchedule, sample_simplified, sample_svd
from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec
from ddnm_tpu_torch.sampling.graphs import resolve_loop
from ddnm_tpu_torch.sampling.rng import (
    STREAM_INIT,
    STREAM_SAMPLE,
    NoiseFn,
    default_noise,
    image_generators,
)

__all__ = [
    "RestorationService",
    "PosteriorRestorationService",
    "RestorationServer",
    "ServiceStats",
]

_MAX_BODY = 32 << 20  # 32 MB request cap


def _modules(params) -> dict:
    """The nn.Modules of a params object: one module, or a mapping of them."""
    if isinstance(params, torch.nn.Module):
        return {"": params}
    return {k: v for k, v in params.items() if isinstance(v, torch.nn.Module)}


class _LanePinnedConv:
    """The forward of a served Conv2d that gives each lane the same bits
    whatever its position in the group. At the first call with an input
    layout (shape, strides, dtype) it checks, on random data of that
    layout, that every lane of one batched call equals the same image
    computed at lane 0 of a batch of its copies; where it does not (on the
    H100, cuDNN's engines for 3x3 convolutions with deep inputs on small
    maps at batch 8 reduce the last lane's output tiles in other splits),
    calls with that layout run one image at a time."""

    def __init__(self, conv: torch.nn.Conv2d):
        self.conv = conv
        self.per_lane: dict = {}

    def __deepcopy__(self, memo):
        # a copy of the served module (a replica on another card,
        # parallel/mesh.py) checks its layouts afresh: one card's verdicts
        # do not hold on another
        return _LanePinnedConv(copy.deepcopy(self.conv, memo))

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv._conv_forward(x, self.conv.weight, self.conv.bias)

    def _lanes_agree(self, x: torch.Tensor) -> bool:
        gen = torch.Generator(device=x.device).manual_seed(0)
        with torch.no_grad():
            probe = torch.empty_like(x).normal_(generator=gen)
            full = self._conv(probe)
            copies = torch.empty_like(probe)
            for k in range(x.shape[0]):
                copies.copy_(probe[k:k + 1].expand_as(probe))
                if not torch.equal(self._conv(copies)[0], full[k]):
                    return False
        return True

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] == 1:
            return self._conv(x)
        key = (tuple(x.shape), x.stride(), x.dtype)
        if key not in self.per_lane:
            self.per_lane[key] = not self._lanes_agree(x)
        if self.per_lane[key]:
            return torch.cat([self._conv(x[i:i + 1]) for i in range(x.shape[0])])
        return self._conv(x)


def _pin_conv_lanes(params) -> None:
    """Route every Conv2d of the served modules through _LanePinnedConv, so
    that a request's reply does not depend on its lane (the service's
    contract: bit-identical alone, padded or coalesced)."""
    for module in _modules(params).values():
        for conv in module.modules():
            if type(conv) is torch.nn.Conv2d and not isinstance(conv.forward, _LanePinnedConv):
                conv.forward = _LanePinnedConv(conv)


def _state(params) -> dict:
    """{module name: {state-dict key: shape}} of a params object."""
    return {name: {k: tuple(v.shape) for k, v in m.state_dict().items()}
            for name, m in _modules(params).items()}


@dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0
    batched_requests: int = 0  # requests that rode a >1-request batch
    errors: int = 0
    cancelled: int = 0  # timed-out requests skipped before device work

    def __post_init__(self):
        # enqueue->completion wall times of the most recent requests, locked:
        # the worker appends while /healthz handlers snapshot
        self._latencies = deque(maxlen=512)
        self._lat_lock = threading.Lock()

    def record_latency(self, seconds: float) -> None:
        with self._lat_lock:
            self._latencies.append(seconds)

    def as_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if not k.startswith("_")}
        d["mean_batch"] = self.requests / self.batches if self.batches else 0.0
        with self._lat_lock:
            lat = sorted(self._latencies)
        if lat:
            pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
            d["latency_s"] = {"p50": round(pick(0.50), 4),
                              "p95": round(pick(0.95), 4),
                              "p99": round(pick(0.99), 4),
                              "n": len(lat)}
        return d


@dataclass
class _Dispatched:
    """A group's result on its way to the host: `out` is (B, H, W, 3)
    float32 in [0, 1], valid once `ready` (a CUDA event; None on the CPU)
    has completed."""

    out: torch.Tensor
    ready: Optional[torch.cuda.Event] = None


class RestorationService:
    """Device-side restoration: fixed-shape, padded, per-request generators.

    model_fn(params, x, t) -> epsilon, NHWC; `params` is an nn.Module or a
    mapping of them (the state `swap_params` replaces). `operators` maps
    task strings to `FunctionalOperator`s or SVD operators
    (`operators.svd_ops`), all at this service's `image_size` on the
    device of the models' parameters (`self.device`; the CPU without any).

    SVD tasks take `input=gt` always; `input=degraded` also works where the
    measurement is an image in the operator's channel-major layout, as the
    operator declares (`SVDOperator.measurement_image`).

    `noise_fn(gens, shape)` draws the samplers' per-step noise (the port's
    hook for parity runs under the zero-noise protocol); x_T always comes
    from each request's STREAM_INIT generator. `loop`: the samplers'
    driver (sampling/graphs.py `resolve_loop`: "auto" is "scan", a graph
    a shard over a mesh; "host" with the encoder cache, where "scan"
    raises). `mesh` (a parallel.Mesh whose first entry holds the
    params) shards each group over its entries (module docstring).
    """

    def __init__(
        self,
        model_fn: Callable,
        params,
        sched: Optional[DDNMSchedule],
        operators: Mapping[str, object],
        *,
        image_size: int,
        max_batch: int = 8,
        eta: float = 0.85,
        sigma_y: float = 0.0,
        base_seed: int = 1234,
        mesh=None,
        require_ctx: Sequence[str] = (),
        encoder_cache: int = 1,
        encoder_cache_policy: str = "uniform",
        split_fns=None,
        loop: str = "auto",
        noise_fn: NoiseFn = default_noise,
    ):
        self._model_fn = model_fn
        self._require_ctx = frozenset(require_ctx)
        self._encoder_cache = int(encoder_cache)
        self._encoder_policy = str(encoder_cache_policy)
        self._split_fns = split_fns
        self._key_steps = None
        self._loop = resolve_loop(loop, mesh=mesh, encoder_cache=self._encoder_cache)
        if self._encoder_cache > 1:
            # approximate opt-in (sampling/accel.py): split_fns = (encode_fn(p,
            # x, t), decode_fn(p, cache, x, t)) over the same params model_fn takes
            if split_fns is None:
                raise ValueError(
                    "encoder_cache > 1 requires split_fns=(encode_fn, "
                    "decode_fn) — see sampling.accel.ddpm_split_fns /"
                    " adm_split_fns")
            bad = [n for n, op in operators.items()
                   if not isinstance(op, FunctionalOperator)]
            if bad:
                raise ValueError(
                    f"encoder_cache has no SVD-mode sampler; serve "
                    f"{sorted(bad)} from a separate exact service")
        unknown = self._require_ctx - set(operators)
        if unknown:
            raise ValueError(f"require_ctx names unknown tasks: {sorted(unknown)}")
        if mesh is not None and max_batch % mesh.size != 0:
            raise ValueError(f"max_batch {max_batch} must divide over the {mesh.size}-device "
                             "mesh")
        self._mesh = mesh
        self._params = params
        # one copy of the served modules a mesh device (params itself on its own)
        self._replicas = (params,) if mesh is None else replicate(mesh, params)
        self._pending_state = None  # swap_params -> applied before the next group
        self._swap_lock = threading.Lock()
        first = next((p for m in _modules(params).values() for p in m.parameters()), None)
        self.device = first.device if first is not None else torch.device("cpu")
        if self.device.type == "cuda":
            for replica in self._distinct_replicas():
                _pin_conv_lanes(replica)
        self._noise_fn = noise_fn
        self._labels = None  # a class-conditional group's labels (restore_async)
        self._sched = sched
        if self._encoder_cache > 1 and sched is not None:
            from ddnm_tpu_torch.sampling.accel import key_steps_for_policy, n_model_calls

            self._key_steps = key_steps_for_policy(
                n_model_calls(sched), self._encoder_cache, self._encoder_policy)
        self._operators = dict(operators)
        self._op_replicas = ({} if mesh is None else
                             {name: replicate(mesh, op) for name, op in self._operators.items()})
        self.image_size = int(image_size)
        self.max_batch = int(max_batch)
        self._eta = float(eta)
        self._sigma_y = float(sigma_y)
        self._base_seed = int(base_seed)
        # Per-task mode and degraded-upload shape, from each operator's A on
        # a zero input (one call each). SVD measurements are channel-major
        # flat vectors; where the vector is an image its (h, w, c) is exposed
        # so that HTTP clients can upload the degraded PNG directly.
        size = self.image_size
        with torch.no_grad():
            img = torch.zeros((1, size, size, 3), device=self.device)
            vec = torch.zeros((1, size * size * 3), device=self.device)
            self._is_svd = {}
            self._y_shapes = {}  # deg -> (h, w, c) accepted as degraded upload
            for name, op in self._operators.items():
                if isinstance(op, FunctionalOperator):
                    self._is_svd[name] = False
                    self._y_shapes[name] = tuple(op.A(img).shape[1:])
                    continue
                self._is_svd[name] = True
                m = int(op.A(vec).shape[1])
                # the OPERATOR declares whether its measurement is an image;
                # length alone cannot tell an image from coefficients
                kind = getattr(op, "measurement_image", None)
                shape = None
                if kind == "gray":
                    s = round(m**0.5)
                    if s * s != m:
                        raise ValueError(
                            f"{name!r} declares a grayscale measurement but "
                            f"its length {m} is not a square")
                    shape = (s, s, 1)
                elif kind == "rgb":
                    s = round((m / 3) ** 0.5) if m % 3 == 0 else 0
                    if s * s * 3 != m:
                        raise ValueError(
                            f"{name!r} declares an RGB measurement but its "
                            f"length {m} is not 3*k^2")
                    shape = (s, s, 3)
                elif kind is not None:
                    raise ValueError(
                        f"{name!r}: unknown measurement_image {kind!r}")
                self._y_shapes[name] = shape  # None -> gt uploads only
            # Which ctx tasks accept a *degraded* masked upload: only those
            # whose A_ctx is the pure keep-mask projection (then the masked
            # upload times its own mask IS A(x) exactly). Checked numerically
            # on a tiny probe (the JAX service's seeds), not guessed from the
            # task name.
            self._ctx_mask_projection = {}
            for name, op in self._operators.items():
                if (self._is_svd[name] or not op.has_ctx
                        or self._y_shapes[name] != (size, size, 3)):
                    self._ctx_mask_projection[name] = False
                    continue
                probe = torch.as_tensor(
                    np.random.default_rng(0).uniform(-1, 1, (1, 8, 8, 3)),
                    dtype=torch.float32, device=self.device)
                pmask = torch.as_tensor(
                    np.random.default_rng(1).random((1, 8, 8, 1)) > 0.5,
                    dtype=torch.float32, device=self.device)
                self._ctx_mask_projection[name] = bool(np.allclose(
                    op.A_ctx(probe, pmask).cpu().numpy(), (probe * pmask).cpu().numpy()))

    def swap_params(self, params) -> None:
        """Replace the served weights: `params` must have the served
        structure (the same modules, state-dict keys and shapes). The new
        state is stored here and copied into the served models by the thread
        that launches the next group, before its first launch; a group
        already launched keeps the old weights (the copies run after it on
        the stream)."""
        old, new = _state(self._params), _state(params)
        if ({k: sorted(v) for k, v in old.items()}
                != {k: sorted(v) for k, v in new.items()}):
            raise ValueError(
                f"param tree structure mismatch: served {sorted(old)}, got {sorted(new)}")
        if old != new:
            raise ValueError("param leaf shapes differ from the served tree")
        state = {name: {k: v.detach() for k, v in m.state_dict().items()}
                 for name, m in _modules(params).items()}
        with self._swap_lock:
            self._pending_state = state

    def _distinct_replicas(self) -> list:
        """The served params objects, one a device."""
        return list({id(r): r for r in self._replicas}.values())

    def _apply_pending_params(self) -> None:
        with self._swap_lock:
            state, self._pending_state = self._pending_state, None
        if state is None:
            return
        # over a mesh on cards the copies run on each card's current stream:
        # after the shards' streams (the group in flight), and before the
        # next group's shards
        streams = (self._mesh.streams() if self._mesh is not None and self._mesh.is_cuda
                   else ())
        for st in streams:
            torch.cuda.current_stream(st.device).wait_stream(st)
        with torch.no_grad():
            for replica in self._distinct_replicas():
                for name, m in _modules(replica).items():
                    m.load_state_dict(state[name], strict=True)
        for st in streams:
            st.wait_stream(torch.cuda.current_stream(st.device))

    @property
    def tasks(self) -> tuple:
        return tuple(sorted(self._operators))

    @property
    def ctx_tasks(self) -> tuple:
        """Tasks that accept a per-request mask (RGBA upload)."""
        return tuple(sorted(
            n for n, op in self._operators.items()
            if not self._is_svd[n] and op.has_ctx))

    def ctx_degraded_ok(self, deg: str) -> bool:
        """True if `deg` accepts a *degraded* RGBA upload (pure mask op)."""
        return self._ctx_mask_projection.get(deg, False)

    def y_shape(self, deg: str):
        """(h, w, c) a degraded upload must have for `deg`, or None when
        the task only accepts `input=gt` (non-image SVD measurements)."""
        return self._y_shapes[deg]

    def is_svd(self, deg: str) -> bool:
        return self._is_svd[deg]

    def restore(
        self,
        images: np.ndarray,
        deg: str,
        seqs: Sequence[int],
        *,
        input_kind: str = "degraded",
        ctxs: Optional[np.ndarray] = None,
        classes: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        """Restore a group of <= max_batch requests for one task.

        images: (B, h, w, c) float32 in [0, 1] — the degraded observations
        (input_kind="degraded", default) or ground-truth images to degrade
        first (input_kind="gt"). seqs: one sequence number per request (its
        generators' identity). `ctxs`: optional (B, H, W, 1) per-image
        keep-masks for ctx-capable tasks. `classes`: optional per-image
        class labels for class-conditional services. Returns (B, H, W, 3)
        float32 in [0, 1].

        Blocking form of restore_async + fetch.
        """
        return self.fetch(
            self.restore_async(images, deg, seqs, input_kind=input_kind,
                               ctxs=ctxs, classes=classes)
        )

    @property
    def class_cond(self) -> bool:
        """True if requests MUST carry a class label (?class=N)."""
        return False

    @property
    def num_classes(self):
        """Upper bound (exclusive) for class labels, or None if unknown."""
        return None

    def requires_ctx(self, deg: str) -> bool:
        """True if `deg` must get a per-request mask (it was configured
        without a real static one)."""
        return deg in self._require_ctx

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a float32 tensor of its own on the service's
        device, copied without waiting."""
        return to_device(torch.tensor(np.asarray(a, dtype=np.float32)), self.device)

    @torch.no_grad()
    def restore_async(
        self,
        images: np.ndarray,
        deg: str,
        seqs: Sequence[int],
        *,
        input_kind: str = "degraded",
        ctxs: Optional[np.ndarray] = None,
        classes: Optional[Sequence[int]] = None,
    ) -> _Dispatched:
        """Launch a group's full trajectory and return without waiting for
        the device: the result is (B, H, W, 3) on its way into pinned host
        memory behind an event; `fetch` waits for it. Applies a pending
        `swap_params` first."""
        op = self._operators.get(deg)
        if op is None:
            raise KeyError(f"unknown task {deg!r}; serving {self.tasks}")
        b = int(images.shape[0])
        if not 1 <= b <= self.max_batch:
            raise ValueError(f"group size {b} not in [1, {self.max_batch}]")
        if len(seqs) != b:
            raise ValueError("one sequence number per image required")

        if classes is not None and not self.class_cond:
            raise ValueError("this service is not class-conditional")
        if ctxs is None and deg in self._require_ctx:
            raise ValueError(
                f"{deg!r} was configured without a static mask; every "
                "request must carry its own (HTTP: RGBA upload)")
        is_svd = self._is_svd[deg]
        ctx = None
        if ctxs is not None:
            if is_svd or not op.has_ctx:
                raise ValueError(
                    f"{deg!r} takes no per-request masks (no A_ctx forms)")
            expected_ctx = (b, self.image_size, self.image_size, 1)
            if tuple(np.shape(ctxs)) != expected_ctx:
                raise ValueError(
                    f"ctxs must be {expected_ctx}, got {tuple(np.shape(ctxs))}")
            ctx = self._tensor(ctxs)

        shape_in = tuple(images.shape[1:])
        if input_kind == "gt":
            expected = (self.image_size, self.image_size, 3)
            if shape_in != expected:
                raise ValueError(
                    f"gt input must be {expected}, got {shape_in}"
                )
        elif input_kind == "degraded":
            if is_svd:
                spec = self._y_shapes[deg]
                if spec is None:
                    raise ValueError(
                        f"{deg!r}'s measurement is not an image; send "
                        "input=gt")
                if shape_in != spec:
                    raise ValueError(
                        f"degraded input for {deg!r} must be {spec}, "
                        f"got {shape_in}")
            elif ctx is not None:
                # masked upload: valid only for pure keep-mask projections,
                # where (masked image) * mask == A(x) exactly (A idempotent)
                if not self.ctx_degraded_ok(deg):
                    raise ValueError(
                        f"{deg!r} cannot take a degraded masked upload; "
                        "send input=gt with the RGBA mask instead")
                expected = (self.image_size, self.image_size, 3)
                if shape_in != expected:
                    raise ValueError(
                        f"masked degraded input must be {expected}, "
                        f"got {shape_in}")
            elif shape_in != self._y_shapes[deg]:
                raise ValueError(
                    f"degraded input for {deg!r} must be "
                    f"{self._y_shapes[deg]}, got {shape_in}"
                )
        else:
            raise ValueError(f"input_kind must be 'degraded' or 'gt', got {input_kind!r}")

        cls = None
        if self.class_cond:
            if classes is None:
                raise ValueError(
                    "this service is class-conditional: pass one class "
                    "label per image (HTTP: ?class=N)")
            cls = [int(c) for c in classes]
            if len(cls) != b:
                raise ValueError("one class label per image required")
            n_cls = self.num_classes
            bad = [c for c in cls if c < 0 or (n_cls and c >= n_cls)]
            if bad:
                raise ValueError(
                    f"class labels out of range [0, {n_cls}): {bad}")

        self._apply_pending_params()
        x_in = self._tensor(images)
        if input_kind == "gt":
            xg = data_transform(x_in)
            if is_svd:
                y = op.A(_nhwc_to_vec(xg))
            else:
                y = op.A_ctx(xg, ctx) if ctx is not None else op.A(xg)
        elif is_svd:
            yt = data_transform(x_in)
            # channel-major flat, the SVD operator layout; grayscale
            # measurements are already single-plane
            y = yt.reshape(b, -1) if self._y_shapes[deg][-1] == 1 else _nhwc_to_vec(yt)
        elif ctx is not None:
            y = data_transform(x_in) * ctx
        else:
            y = data_transform(x_in)

        # Pad to the serving batch size: pad lanes replicate lane 0 and draw
        # from generators of their own (sequence number 0), so real lanes
        # are bit-identical across any grouping.
        pad = self.max_batch - b
        if pad:
            y = torch.cat([y, y[:1].expand(pad, *y.shape[1:])], dim=0)
            if ctx is not None:
                ctx = torch.cat([ctx, ctx[:1].expand(pad, *ctx.shape[1:])], dim=0)
        seq_all = [int(s) for s in seqs] + [0] * pad
        hw = (self.max_batch, self.image_size, self.image_size, 3)
        x_init = default_noise(
            image_generators(self._base_seed, seq_all, STREAM_INIT, self.device), hw)
        gens = image_generators(self._base_seed, seq_all, STREAM_SAMPLE, self.device)
        if cls is not None:
            # one buffer, copied into in stream order: the graph of a group
            # of this key reads it at every replay (a fresh tensor would
            # make a key of its own)
            if self._labels is None:
                self._labels = torch.zeros(self.max_batch, dtype=torch.long, device=self.device)
            cls = self._labels.copy_(torch.as_tensor(cls + [0] * pad, dtype=torch.long))
        if self._mesh is None:
            x = self._sample(self._params, op, is_svd, x_init, y, ctx, gens, cls)
        else:
            x = sharded_sampler(self._sample, self._mesh)(
                self._replicas, self._op_replicas[deg], is_svd, x_init, y, ctx, gens, cls)
        out = to_host(inverse_data_transform(x[:b]).float())
        if self.device.type != "cuda":
            return _Dispatched(out)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return _Dispatched(out, ready)

    def _sample(self, params, op, is_svd, x_init, y, ctx, gens, cls):
        """Run the padded group's trajectory (or one mesh entry's share of
        it) on `params`; returns x_final (padded)."""
        model_fn = lambda x, t: self._model_fn(params, x, t)
        kw = dict(eta=self._eta, sigma_y=self._sigma_y, noise_fn=self._noise_fn)
        if is_svd:
            x, _ = sample_svd(model_fn, x_init, y, op, self._sched, gens, loop=self._loop, **kw)
        elif self._encoder_cache > 1:
            from ddnm_tpu_torch.sampling.accel import sample_simplified_encoder_prop

            encode_fn, decode_fn = self._split_fns
            x, _ = sample_simplified_encoder_prop(
                lambda x, t: encode_fn(params, x, t),
                lambda cache, x, t: decode_fn(params, cache, x, t),
                x_init, y, op, self._sched, gens, interval=self._encoder_cache,
                key_steps=self._key_steps, op_ctx=ctx, **kw)
        else:
            x, _ = sample_simplified(model_fn, x_init, y, op, self._sched, gens,
                                     op_ctx=ctx, loop=self._loop, **kw)
        return x

    @staticmethod
    def fetch(out: _Dispatched) -> np.ndarray:
        """Wait for a restore_async result (its event, not the device) and
        return it as host float32."""
        if out.ready is not None:
            out.ready.synchronize()
        return out.out.numpy().astype(np.float32, copy=False)

    def warmup(self) -> None:
        """Run every task once before taking traffic (the kernels' build
        and load, cuDNN's algorithm choice) — the per-request-mask variant
        of ctx-capable tasks too."""
        zero = np.zeros((1, self.image_size, self.image_size, 3), np.float32)
        ones = np.ones((1, self.image_size, self.image_size, 1), np.float32)
        cls = [0] if self.class_cond else None
        for deg in self.tasks:
            if deg in self._require_ctx:
                continue  # the maskless form is unreachable
            self.restore(zero, deg, [0], input_kind="gt", classes=cls)
        for deg in self.ctx_tasks:
            self.restore(zero, deg, [0], input_kind="gt", ctxs=ones,
                         classes=cls)


class PosteriorRestorationService(RestorationService):
    """hq-pipeline serving: respaced posterior DDNM with time-travel.

    The online form of the reference's hq_demo face256/imagenet flow (one
    tile per request). model_fn(params, x, t_orig) -> (B, H, W, 2C)
    learned-range head; `tables` from `build_posterior_tables` carry the
    respacing, the jump schedule and sigma_y. Functional operators only.

    Per-request masks as the base service, plus — when `class_cond=True` —
    per-request class labels (`?class=N`): the padded label batch rides as
    params["classes"] (a dict copy of the served params, per group), so
    mixed-class requests coalesce into one group. model_fn and
    guidance_fn(params, x, t, at=None) read p["classes"] (serve_torch.py
    `build_hq_service`).
    """

    def __init__(
        self,
        model_fn: Callable,
        params,
        tables,
        operators: Mapping[str, FunctionalOperator],
        *,
        image_size: int,
        max_batch: int = 8,
        base_seed: int = 1234,
        mesh=None,
        guidance_fn: Optional[Callable] = None,
        clip_denoised: bool = True,
        class_cond: bool = False,
        num_classes: Optional[int] = None,
        require_ctx: Sequence[str] = (),
        encoder_cache: int = 1,
        encoder_cache_policy: str = "uniform",
        split_fns=None,
        loop: str = "auto",
        noise_fn: NoiseFn = default_noise,
    ):
        super().__init__(
            model_fn, params, None, operators, image_size=image_size,
            max_batch=max_batch, base_seed=base_seed, mesh=mesh,
            require_ctx=require_ctx, encoder_cache=encoder_cache,
            encoder_cache_policy=encoder_cache_policy, split_fns=split_fns,
            loop=loop, noise_fn=noise_fn,
        )
        bad = [n for n, svd in self._is_svd.items() if svd]
        if bad:
            raise ValueError(
                f"the posterior pipeline serves functional operators only; "
                f"got SVD operators for {bad}")
        self._tables = tables
        if self._encoder_cache > 1:
            from ddnm_tpu_torch.sampling.accel import key_steps_for_policy, n_model_calls

            self._key_steps = key_steps_for_policy(
                n_model_calls(tables), self._encoder_cache, self._encoder_policy)
        self._guidance_fn = guidance_fn
        self._clip_denoised = bool(clip_denoised)
        self._class_cond = bool(class_cond)
        self._num_classes = None if num_classes is None else int(num_classes)

    @property
    def class_cond(self) -> bool:
        return self._class_cond

    @property
    def num_classes(self):
        return self._num_classes

    def _sample(self, params, op, is_svd, x_init, y, ctx, gens, cls):
        from ddnm_tpu_torch.sampling.posterior import sample_posterior

        # the posterior loop consumes A+y (the reference passes Apy into
        # p_sample_loop, hq_demo gaussian_diffusion.py:495-530)
        apy = op.Ap_ctx(y, ctx) if ctx is not None else op.Ap(y)
        if self._class_cond:
            params = dict(params)
            params["classes"] = cls
        guidance = None
        if self._guidance_fn is not None:
            guidance = lambda x, t, at=None: self._guidance_fn(params, x, t, at)
        kw = dict(guidance_fn=guidance, clip_denoised=self._clip_denoised, op_ctx=ctx,
                  noise_fn=self._noise_fn)
        if self._encoder_cache > 1:
            from ddnm_tpu_torch.sampling.accel import sample_posterior_encoder_prop

            encode_fn, decode_fn = self._split_fns
            x, _ = sample_posterior_encoder_prop(
                lambda x, t: encode_fn(params, x, t),
                lambda cache, x, t: decode_fn(params, cache, x, t),
                x_init, apy, op, self._tables, gens, interval=self._encoder_cache,
                key_steps=self._key_steps, **kw)
        else:
            x, _ = sample_posterior(lambda x, t: self._model_fn(params, x, t), x_init,
                                    apy, op, self._tables, gens, loop=self._loop, **kw)
        return x


@dataclass
class _Request:
    image: np.ndarray
    deg: str
    input_kind: str
    seq: int
    ctx: Optional[np.ndarray] = None  # per-request keep-mask (H, W, 1)
    cls: Optional[int] = None  # per-request class label (class-cond only)
    event: threading.Event = field(default_factory=threading.Event)
    # set by the handler when its client stopped waiting; the worker skips
    # cancelled requests instead of burning a device batch nobody reads
    cancelled: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None
    error_code: int = 500  # worker-side failures are server errors
    batch_size: int = 1
    t_enqueue: float = field(default_factory=time.monotonic)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the stdlib default listen backlog (5) drops connections under a
    # burst of simultaneous clients — size it to the worst batch burst
    request_queue_size = 128


class RestorationServer:
    """HTTP front: micro-batching queue over a RestorationService."""

    def __init__(
        self,
        service: RestorationService,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_wait_ms: float = 20.0,
        queue_size: int = 64,
        request_timeout_s: float = 600.0,
    ):
        self.service = service
        self.stats = ServiceStats()
        self._queue: queue.Queue[_Request] = queue.Queue(maxsize=queue_size)
        self._held: Optional[_Request] = None  # task-mismatched leftover
        self._max_wait = max_wait_ms / 1000.0
        self._request_timeout = float(request_timeout_s)
        self._seq_lock = threading.Lock()
        self._seq = 0
        self._running = False
        self._stopped = False
        self._httpd = _Server((host, port), _make_handler(self))
        self._worker: Optional[threading.Thread] = None
        self._server_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> tuple:
        return self._httpd.server_address

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._running = True
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._worker.start()
        self._server_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._server_thread.start()

    def stop(self) -> None:
        """Stop accepting work, shut the HTTP front down, and fail anything
        still pending so waiting handlers return promptly.

        The worker drains the queue itself on exit (it owns `_held`). If the
        worker is still launching past the join timeout, the drain happens
        when that group is done; `submit` rejects from this point on."""
        self._stopped = True  # reject new submits before draining
        self._running = False
        if self._server_thread is not None:
            # shutdown() blocks on serve_forever's exit handshake, so it
            # deadlocks if the serve loop was never started — skip it then
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._worker is not None:
            self._worker.join(timeout=30)
        if self._worker is None or not self._worker.is_alive():
            self._drain_pending()

    def _drain_pending(self) -> None:
        """Fail every un-serviced request. Called by the worker thread on
        exit, or by stop() when no worker is alive — never concurrently."""
        pending = [] if self._held is None else [self._held]
        self._held = None
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for r in pending:
            r.error = "server shutting down"
            r.error_code = 503
            r.event.set()

    # -- request path -------------------------------------------------------

    def submit(self, image: np.ndarray, deg: str, input_kind: str,
               ctx: Optional[np.ndarray] = None,
               cls: Optional[int] = None) -> _Request:
        if self._stopped:
            raise RuntimeError("server is shut down")
        with self._seq_lock:
            seq = self._seq
            self._seq += 1
        req = _Request(image=image, deg=deg, input_kind=input_kind, seq=seq,
                       ctx=ctx, cls=cls)
        self._queue.put_nowait(req)  # raises queue.Full -> 503 upstream
        if self._stopped and not req.event.is_set():
            # raced with stop(): the drains may already have run
            req.error = "server shutting down"
            req.error_code = 503
            req.event.set()
        return req

    def _collect(self, first: _Request) -> list:
        """Coalesce up to max_batch same-(task, input_kind, maskedness)
        requests, waiting at most max_wait for stragglers. A mismatched
        request is held for the next group rather than reordered."""
        group = [first]
        deadline = time.monotonic() + self._max_wait
        while len(group) < self.service.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if (nxt.deg == first.deg and nxt.input_kind == first.input_kind
                    and (nxt.ctx is None) == (first.ctx is None)):
                group.append(nxt)
            else:
                self._held = nxt
                break
        return group

    def _worker_loop(self) -> None:
        """Drain the queue with a one-deep dispatch/fetch pipeline: while
        the in-flight group's copy-out runs, collect and launch the next
        group, then fetch the in-flight one. When the queue is idle the
        in-flight group is fetched at once."""
        in_flight = None  # (live_requests, dispatched) awaiting fetch
        while self._running:
            first = None
            if self._held is not None:
                first, self._held = self._held, None
            else:
                try:
                    if in_flight is not None:
                        first = self._queue.get_nowait()
                    else:
                        first = self._queue.get(timeout=0.1)
                except queue.Empty:
                    pass
            if first is None:
                if in_flight is not None:
                    self._finish_group(*in_flight)
                    in_flight = None
                continue
            dispatched = self._dispatch_group(self._collect(first))
            if in_flight is not None:
                self._finish_group(*in_flight)
            in_flight = dispatched
        if in_flight is not None:
            self._finish_group(*in_flight)
        self._drain_pending()

    def _serve_group(self, group: list) -> None:
        """Run one coalesced group synchronously (dispatch + fetch)."""
        dispatched = self._dispatch_group(group)
        if dispatched is not None:
            self._finish_group(*dispatched)

    def _dispatch_group(self, group: list):
        """Launch one coalesced group. Requests whose clients already gave
        up are acknowledged (504) without device work. Returns
        (live_requests, dispatched) for `_finish_group`, or None if nothing
        reached the device (all cancelled, or the dispatch failed)."""
        live = [r for r in group if not r.cancelled.is_set()]
        for r in group:
            if r.cancelled.is_set():
                r.error = "cancelled: client stopped waiting"
                r.error_code = 504
                r.event.set()
        self.stats.cancelled += len(group) - len(live)
        if not live:
            return None
        try:
            images = np.stack([r.image for r in live])
            ctxs = (np.stack([r.ctx for r in live])
                    if live[0].ctx is not None else None)
            classes = ([r.cls if r.cls is not None else 0 for r in live]
                       if self.service.class_cond else None)
            out = self.service.restore_async(
                images, live[0].deg, [r.seq for r in live],
                input_kind=live[0].input_kind, ctxs=ctxs, classes=classes,
            )
        except Exception as exc:  # shape or launch failure: fail the group
            self._complete(live, None, exc)
            return None
        return live, out

    def _finish_group(self, live: list, out) -> None:
        """Wait for a dispatched group's result and wake its handlers."""
        try:
            self._complete(live, self.service.fetch(out), None)
        except Exception as exc:  # execution-time failure surfaces here
            self._complete(live, None, exc)

    def _complete(self, live: list, results, exc) -> None:
        """Deliver results or a shared error to a group, once."""
        now = time.monotonic()
        if exc is not None:  # propagate per-request as a server error
            for r in live:
                r.error = f"{type(exc).__name__}: {exc}"
            self.stats.errors += len(live)
        else:
            for i, r in enumerate(live):
                r.result = results[i]
                r.batch_size = len(live)
        self.stats.batches += 1
        self.stats.requests += len(live)
        if len(live) > 1:
            self.stats.batched_requests += len(live)
        for r in live:
            self.stats.record_latency(now - r.t_enqueue)
            r.event.set()


def _make_handler(server: RestorationServer):
    class Handler(BaseHTTPRequestHandler):
        # quiet by default; the service is the log surface
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                svc = server.service
                self._send_json(200, {
                    "status": "ok",
                    "tasks": list(svc.tasks),
                    "ctx_tasks": list(svc.ctx_tasks),
                    "svd_tasks": [t for t in svc.tasks if svc.is_svd(t)],
                    "class_cond": svc.class_cond,
                    "num_classes": svc.num_classes,
                    "mask_required": [t for t in svc.tasks
                                      if svc.requires_ctx(t)],
                    "degraded_upload": {
                        t: (list(svc.y_shape(t))
                            if svc.y_shape(t) is not None else None)
                        for t in svc.tasks},
                    "image_size": server.service.image_size,
                    "max_batch": server.service.max_batch,
                    "queue_depth": server._queue.qsize(),
                    **server.stats.as_dict(),
                })
            else:
                self._send_json(404, {"error": f"no route {path}"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/restore":
                self._send_json(404, {"error": f"no route {parsed.path}"})
                return
            q = parse_qs(parsed.query)
            deg = q.get("deg", [""])[0]
            input_kind = q.get("input", ["degraded"])[0]
            if deg not in server.service.tasks:
                self._send_json(
                    400, {"error": f"unknown deg {deg!r}",
                          "tasks": list(server.service.tasks)})
                return
            if input_kind not in ("degraded", "gt"):
                self._send_json(
                    400, {"error": f"input must be 'degraded' or 'gt', "
                                   f"got {input_kind!r}"})
                return
            cls = None
            if "class" in q:
                if not server.service.class_cond:
                    self._send_json(
                        400, {"error": "this service is not "
                                       "class-conditional"})
                    return
                n_cls = server.service.num_classes
                try:
                    cls = int(q["class"][0])
                    if cls < 0 or (n_cls is not None and cls >= n_cls):
                        raise ValueError
                except ValueError:
                    self._send_json(
                        400, {"error": f"class must be an integer in "
                                       f"[0, {n_cls}), got {q['class'][0]!r}"})
                    return
            elif server.service.class_cond:
                self._send_json(
                    400, {"error": "this service is class-conditional: "
                                   "pass ?class=N"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if not 0 < length <= _MAX_BODY:
                    self._send_json(413, {"error": "bad content length"})
                    return
                # serve.py's Image.open: the pixels in PIL's mode, and its
                # "A" in img.getbands()
                img, mode = decode_image(self.rfile.read(length), "upload")
                has_alpha = image_has_alpha(mode)
            except Exception as exc:
                self._send_json(400, {"error": f"bad image: {exc}"})
                return
            # Validate kind/shape HERE so one malformed request cannot
            # poison the coalesced batch it would have ridden in.
            size = server.service.image_size
            if not has_alpha and server.service.requires_ctx(deg):
                self._send_json(
                    400, {"error": f"{deg!r} was configured without a "
                                   "static mask; upload an RGBA PNG whose "
                                   "alpha channel is the keep-mask"})
                return
            if has_alpha:
                if deg not in server.service.ctx_tasks:
                    self._send_json(
                        400, {"error": f"{deg!r} takes no per-request mask "
                                       "(RGBA upload); tasks with mask "
                                       "support: "
                                       f"{list(server.service.ctx_tasks)}"})
                    return
                if (input_kind == "degraded"
                        and not server.service.ctx_degraded_ok(deg)):
                    self._send_json(
                        400, {"error": f"{deg!r} cannot take a degraded "
                                       "masked upload; send input=gt with "
                                       "the RGBA mask instead"})
                    return
                expected = (size, size, 3)  # masked uploads are gt-sized
            elif input_kind == "gt":
                expected = (size, size, 3)
            else:
                expected = server.service.y_shape(deg)
                if expected is None:
                    self._send_json(
                        400, {"error": f"{deg!r}'s measurement is not an "
                                       "image; send input=gt"})
                    return
            ctx = None
            if has_alpha:
                # RGBA upload: alpha is the per-request keep-mask
                rgba = convert(img, mode, "RGBA").astype(np.float32)
                arr = rgba[..., :3] / 255.0
                ctx = (rgba[..., 3:] > 127.0).astype(np.float32)
            elif expected[-1] == 1:  # grayscale measurement
                arr = (convert(img, mode, "L").astype(np.float32) / 255.0)[..., None]
            else:
                arr = convert(img, mode, "RGB").astype(np.float32) / 255.0
            if arr.shape != expected:
                self._send_json(
                    400, {"error": f"{input_kind} input for {deg!r} must be "
                                   f"{expected}, got {tuple(arr.shape)}"})
                return
            try:
                req = server.submit(arr, deg, input_kind, ctx=ctx, cls=cls)
            except queue.Full:
                self._send_json(503, {"error": "queue full"})
                return
            except RuntimeError as exc:
                self._send_json(503, {"error": str(exc)})
                return
            if not req.event.wait(timeout=server._request_timeout):
                req.cancelled.set()  # worker skips it instead of computing
                self._send_json(504, {"error": "restoration timed out"})
                return
            if req.error is not None:
                self._send_json(req.error_code, {"error": req.error})
                return
            out = np.clip(req.result * 255.0 + 0.5, 0, 255).astype(np.uint8)
            self._send(
                200, encode_png(out), "image/png",
                extra=[("X-Seq", str(req.seq)),
                       ("X-Batch-Size", str(req.batch_size))],
            )

    return Handler
