"""Serving export: the sampling step or trajectory as a torch.export artifact
(port of ddnm_tpu/serving.py).

Each `export_*` traces a small module that wraps one simplified or
posterior DDNM step, or the whole trajectory, with `torch.export.export`,
saves the program with `torch.export.save` and returns its bytes (and
writes them to `path` when given). `load_exported` loads one in any
process that can import `ddnm_tpu_torch`: no sampler, schedule or model
code of the caller is needed, only the `ddnm::` kernel ops
(ops/library.py), which importing the package registers.

**Arguments.** Each program takes the JAX artifact's arguments in JAX's
order, minus `params`: in torch the weights are the program's lifted
state. `load_exported(...)` returns the program's module
(`ExportedProgram.module()`), and its `load_state_dict` swaps the weights
of another checkpoint of the same model in.

  - simplified step: (x, y, key, t, at, at_next) -> (x_next, x0_pred);
  - simplified trajectory: (x_init, y, key) -> (x_final, x0_pred);
  - posterior step: (x, apy[, op_ctx], key, t_orig, sqrt_recip,
    sqrt_recipm1, lam, coef1, coef2, gamma, nonzero) -> (x_next, x0_hat);
  - posterior trajectory: (x_init, apy[, paste_mask, paste_content]
    [, op_ctx], key) -> (x_final, x0_hat).

Images are NHWC float32; the scalars are 0-dim float32 tensors. A key is
the JAX key data (`jax.random.key_data(PRNGKey(s))`, its uint32 words) as
int64, shape (2,) (shared by the batch) or (batch, 2) (`per_image_keys`:
every image its own stream, as the online server draws): torch.export's
serializer (torch 2.11) has no uint32. The program draws JAX's own noise
from it
(sampling/threefry.py), so it can be held to the JAX artifact on the same
key. A trajectory unrolls its static schedule in Python at export time,
with the schedule's tables as constants, as JAX bakes them into its scan.

**The kernels.** While torch.export traces, the GroupNorm and attention
wrappers take the `ddnm::gn_stats_affine`, `ddnm::gn_apply` and
`ddnm::attention` custom ops, so the program holds one node for each
kernel launch of the eager model call, never a decomposition into aten
ops. Run on CUDA tensors the nodes launch the kernels (and count their
launches); on CPU tensors they run the kernels' plain versions.

**Where it runs.** `device` (default: the model's) is where the example
inputs, and so the program, live: JAX's `platforms`. A program exported
with CPU tensors runs on a card after `load_exported(..., device="cuda")`
(`torch.export.passes.move_to_device_pass`): the same graph, with the
kernels' CUDA implementations (JAX's ("cpu", "tpu") artifacts).

Classifier guidance closes over a gradient and is left out, as in the
JAX module. `with_ctx=True` needs an operator with A_ctx / Ap_ctx.
"""

from __future__ import annotations

import io
from pathlib import Path

import torch
from torch import nn

import ddnm_tpu_torch.ops  # noqa: F401  (registers the ddnm:: ops)
from ddnm_tpu_torch.operators.functional import FunctionalOperator
from ddnm_tpu_torch.sampling.ddnm import DDNMSchedule, _simplified_update, sample_simplified
from ddnm_tpu_torch.sampling.posterior import (
    PosteriorTables,
    _posterior_update,
    sample_posterior,
)
from ddnm_tpu_torch.sampling.threefry import KeyNoise, normal

__all__ = [
    "export_simplified_step",
    "export_simplified_trajectory",
    "export_posterior_step",
    "export_posterior_trajectory",
    "load_exported",
]

_POSTERIOR_SCALARS = ("t_orig", "sqrt_recip", "sqrt_recipm1", "lam", "coef1", "coef2",
                      "gamma", "nonzero")


class _SimplifiedStep(nn.Module):
    def __init__(self, model, operator, eta, sigma_y):
        super().__init__()
        self.model, self.operator, self.eta, self.sigma_y = model, operator, eta, sigma_y

    def forward(self, x, y, key, t, at, at_next):
        noise = normal(key, x.shape)
        et = self.model(x, t.expand(x.shape[0]))
        return _simplified_update(self.operator, self.eta, self.sigma_y, x, y, et, at, at_next,
                                  noise)


class _SimplifiedTrajectory(nn.Module):
    def __init__(self, model, operator, sched, eta, sigma_y):
        super().__init__()
        self.model, self.operator, self.sched = model, operator, sched
        self.eta, self.sigma_y = eta, sigma_y

    def forward(self, x_init, y, key):
        # the sampler without its no_grad decorator: `_export` traces with
        # grad off already, and a grad-mode switch inside the graph costs
        # torch.export a pass over every node. The host loop: the tracer
        # makes the unrolled trajectory one program itself
        return sample_simplified.__wrapped__(self.model, x_init, y, self.operator, self.sched,
                                             KeyNoise(key), eta=self.eta, sigma_y=self.sigma_y,
                                             loop="host")


class _PosteriorStep(nn.Module):
    def __init__(self, model, operator, clip_denoised, with_ctx):
        super().__init__()
        self.model, self.operator = model, operator
        self.clip_denoised, self.with_ctx = clip_denoised, with_ctx

    def forward(self, x, apy, *rest):
        op_ctx, rest = (rest[0], rest[1:]) if self.with_ctx else (None, rest)
        key, scalars = rest[0], dict(zip(_POSTERIOR_SCALARS, rest[1:]))
        noise = normal(key, x.shape)
        t_b = scalars["t_orig"].expand(x.shape[0])
        s = {k: scalars[k] for k in _POSTERIOR_SCALARS[1:7]}
        s.update(noise_scale=scalars["nonzero"] * torch.sqrt(torch.clamp(s["gamma"], min=0.0)),
                 op_ctx=op_ctx)
        return _posterior_update(self.operator, None, self.clip_denoised, x, apy, None, None,
                                 noise, self.model(x, t_b), t_b, s)


class _PosteriorTrajectory(nn.Module):
    def __init__(self, model, operator, tables, clip_denoised, with_paste, with_ctx):
        super().__init__()
        self.model, self.operator, self.tables = model, operator, tables
        self.clip_denoised, self.with_paste, self.with_ctx = clip_denoised, with_paste, with_ctx

    def forward(self, x_init, apy, *rest):
        paste_mask = paste_content = op_ctx = None
        if self.with_paste:
            paste_mask, paste_content, rest = rest[0], rest[1], rest[2:]
        if self.with_ctx:
            op_ctx, rest = rest[0], rest[1:]
        return sample_posterior.__wrapped__(  # as _SimplifiedTrajectory's
            self.model, x_init, apy, self.operator, self.tables, KeyNoise(rest[0]),
            paste_mask=paste_mask, paste_content=paste_content, op_ctx=op_ctx,
            clip_denoised=self.clip_denoised, loop="host")


def _device(model, device):
    if device is not None:
        return torch.device(device)
    p = next(model.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def _check_ctx(operator, with_ctx: bool) -> None:
    if with_ctx and not getattr(operator, "has_ctx", False):
        raise ValueError("with_ctx=True needs an operator with A_ctx/Ap_ctx")


def _export(module: nn.Module, args: tuple, path) -> bytes:
    """torch.export the module on `args` (grad off: the program is a
    sampler's), save it, return the bytes (and write `path`)."""
    with torch.no_grad():
        ep = torch.export.export(module.eval(), args)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


def _img(batch, image_size, channels, dev):
    return torch.zeros((batch, image_size, image_size, channels), device=dev)


def _scalars(n: int, dev) -> tuple:
    # one tensor each: export takes a tensor passed twice for one input
    return tuple(torch.zeros((), device=dev) for _ in range(n))


def _key(per_image: bool, batch: int, dev):
    return torch.zeros((batch, 2) if per_image else (2,), dtype=torch.int64, device=dev)


def export_simplified_step(model: nn.Module, operator: FunctionalOperator, *, batch: int,
                           image_size: int, y_shape: tuple, eta: float = 0.85,
                           sigma_y: float = 0.0, device=None, path=None) -> bytes:
    """Export one simplified-DDNM step: (x, y, key, t, at, at_next) ->
    (x_next, x0_pred). `model(x, t[B]) -> eps` (NHWC). The noise is
    normal(key, x.shape), as the JAX step draws it."""
    dev = _device(model, device)
    args = (_img(batch, image_size, 3, dev), torch.zeros(tuple(y_shape), device=dev),
            _key(False, batch, dev)) + _scalars(3, dev)
    return _export(_SimplifiedStep(model, operator, eta, sigma_y), args, path)


def export_simplified_trajectory(model: nn.Module, operator: FunctionalOperator,
                                 sched: DDNMSchedule, *, batch: int, image_size: int,
                                 y_shape: tuple, eta: float = 0.85, sigma_y: float = 0.0,
                                 per_image_keys: bool = False, device=None,
                                 path=None) -> bytes:
    """Export the whole simplified-DDNM trajectory over `sched` (travel
    steps included): (x_init, y, key) -> (x_final, x0_pred), what
    `sample_simplified` gives with a `KeyNoise(key)`."""
    dev = _device(model, device)
    args = (_img(batch, image_size, 3, dev), torch.zeros(tuple(y_shape), device=dev),
            _key(per_image_keys, batch, dev))
    return _export(_SimplifiedTrajectory(model, operator, sched, eta, sigma_y), args, path)


def export_posterior_step(model: nn.Module, operator: FunctionalOperator, *, batch: int,
                          image_size: int, clip_denoised: bool = True, with_ctx: bool = False,
                          device=None, path=None) -> bytes:
    """Export one posterior-DDNM step (the hq pipeline's inner step):
    (x, apy[, op_ctx], key, t_orig, sqrt_recip, sqrt_recipm1, lam, coef1,
    coef2, gamma, nonzero) -> (x_next, x0_hat). `model(x, t_orig[B]) ->
    (B, H, W, 2C)`; the scalars come from `build_posterior_tables`, and the
    caller drives the jump schedule. `with_ctx` adds the (B, H, W, 1)
    operator context between apy and the key."""
    _check_ctx(operator, with_ctx)
    dev = _device(model, device)
    ctx = (_img(batch, image_size, 1, dev),) if with_ctx else ()
    args = ((_img(batch, image_size, 3, dev), _img(batch, image_size, 3, dev)) + ctx
            + (_key(False, batch, dev),) + _scalars(8, dev))
    return _export(_PosteriorStep(model, operator, clip_denoised, with_ctx), args, path)


def export_posterior_trajectory(model: nn.Module, operator: FunctionalOperator,
                                tables: PosteriorTables, *, batch: int, image_size: int,
                                clip_denoised: bool = True, with_paste: bool = False,
                                with_ctx: bool = False, per_image_keys: bool = False,
                                device=None, path=None) -> bytes:
    """Export the whole posterior jump-schedule loop over `tables`:
    (x_init, apy[, paste_mask, paste_content][, op_ctx], key) -> (x_final,
    x0_hat), what `sample_posterior` gives with a `KeyNoise(key)`.
    `with_paste` adds the Mask-Shift blend's (B, H, W, 1) mask and
    (B, H, W, 3) content, `with_ctx` the (B, H, W, 1) operator context."""
    _check_ctx(operator, with_ctx)
    dev = _device(model, device)
    img = lambda c: _img(batch, image_size, c, dev)
    args = ((img(3), img(3)) + ((img(1), img(3)) if with_paste else ())
            + ((img(1),) if with_ctx else ()) + (_key(per_image_keys, batch, dev),))
    return _export(_PosteriorTrajectory(model, operator, tables, clip_denoised, with_paste,
                                        with_ctx), args, path)


def load_exported(blob_or_path, device=None) -> nn.Module:
    """Load an exported program (bytes, or a file's path) and return its
    module; its weights are its state (`load_state_dict` swaps them).
    `device`: move the whole program there first (a CPU-built program onto
    a card: `torch.export.passes.move_to_device_pass`)."""
    src = (Path(blob_or_path) if isinstance(blob_or_path, (str, Path))
           else io.BytesIO(bytes(blob_or_path)))
    ep = torch.export.load(src)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, torch.device(device))
    module = ep.module()
    module.requires_grad_(False)
    return module
