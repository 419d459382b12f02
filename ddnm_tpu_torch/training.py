"""The training path of the port: the loop the golden trainers share
(tools/train_*_golden_torch.py; the JAX package's trainers are
tools/train_*_golden.py over jax.grad and optax).

One step, as the JAX tools write it: split the step's threefry key in
three (images, timesteps, noise), draw x0 from the tier's image family
(data/synthetic.py), t = randint(0, T), noise = normal, x_t = sqrt(abar_t)
x0 + sqrt(1 - abar_t) noise, then either the epsilon MSE on the model's
first three output channels (a learn_sigma ADM's variance head is not
trained) or, for a classifier, the mean softmax cross entropy of its
logits against the labels. The keys, images, timesteps and noise are
JAX's bit for bit or to float32 rounding, so a run from the same weights
follows the JAX trainer's.

The optimiser is `torch.optim.Adam` with optax's defaults (b1 0.9, b2
0.999, eps 1e-8 added after the square root, bias correction) at a
learning rate set before each step from the step count, as optax's
`scale_by_schedule` reads its count before it increments it: the first
update takes schedule(0). `cosine_decay` is
`optax.cosine_decay_schedule(lr, steps, alpha)`.

In training mode every GroupNorm and attention of the port's UNets runs
through `ops.GroupNormFunction` / `ops.AttentionFunction`, whose
backward on a card is the hand-written kernels (the GroupNorm parameter
gradients in the backward finalize kernel, the attention backward at the DDPM heads'
C = 256 / 512 too); cuDNN serves the convolutions.

`train` adds what a long run needs: a snapshot every 1000 steps (model,
Adam state, step, loss curve, key) under a name keyed by a hash of the
run's configuration, so that a killed run resumes bit for bit and a
changed run never resumes stale state; `export` writes the weights as a
state dict under the reference checkpoints' keys (the port's own module
names), which `data/checkpoints.load_checkpoint` reads back.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch.nn import functional as F

from ddnm_tpu_torch.sampling import threefry

__all__ = ["TrainSpec", "abar_table", "arch_meta", "batch_loss", "cosine_decay", "device_name",
           "draw_batch", "export", "make_optimizer", "param_count", "per_step_seconds",
           "train", "train_step"]

@dataclass
class TrainSpec:
    """One trainer's run. `kind`: "eps" (epsilon MSE on out[..., :3]) or
    "classifier" (cross entropy); `data(key, n, res)` gives x0, or (x0,
    labels) for a classifier; `abar` the float32 (T,) cumulative product
    of 1 - beta; `cosine`: optax.cosine_decay_schedule(lr, steps, 0.1),
    else a constant learning rate (optax.adam(lr))."""

    kind: str
    res: int
    batch: int
    lr: float
    steps: int
    data: Callable
    abar: np.ndarray
    cosine: bool = False

    def lr_at(self, count: int) -> float:
        return cosine_decay(self.lr, self.steps)(count) if self.cosine else self.lr


def abar_table(betas: np.ndarray, cumprod_dtype) -> np.ndarray:
    """float32 (T,) prod(1 - beta): the cumulative product in
    `cumprod_dtype` (float32 for the DDPM tiers and every tier of the
    shared loop, float64 for the toy ADM and toy classifier), as each JAX
    trainer takes it."""
    return np.cumprod(1.0 - np.asarray(betas).astype(cumprod_dtype)).astype(np.float32)


def cosine_decay(lr: float, steps: int, alpha: float = 0.1) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(lr, steps, alpha) in float32: lr ((1 -
    alpha) (1 + cos(pi min(count, steps) / steps)) / 2 + alpha)."""
    def schedule(count: int) -> float:
        c = np.float32(min(count, steps))
        cos = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(np.pi) * c
                                                          / np.float32(steps)))
        decayed = np.float32(1.0 - alpha) * cos + np.float32(alpha)
        return float(np.float32(lr) * decayed)
    return schedule


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def draw_batch(key, spec: TrainSpec, device) -> dict:
    """One step's x0, t, noise (and labels) from its threefry key, on
    `device`: the JAX trainers' split into images, timesteps and noise."""
    k_img, k_t, k_noise = threefry.split(threefry.as_key(key).to(device), 3)
    drawn = spec.data(k_img, spec.batch, spec.res)
    x0, labels = drawn if spec.kind == "classifier" else (drawn, None)
    t = threefry.randint(k_t, (spec.batch,), 0, len(spec.abar))
    noise = threefry.normal(k_noise, tuple(x0.shape))
    return {"x0": x0, "t": t, "noise": noise, "labels": labels}


def batch_loss(model, batch: dict, abar: torch.Tensor, kind: str):
    """(loss, accuracy or None) of one batch: x_t from x0 and the noise,
    then the epsilon MSE or the classifier's cross entropy."""
    at = abar[batch["t"]][:, None, None, None]
    xt = torch.sqrt(at) * batch["x0"] + torch.sqrt(1 - at) * batch["noise"]
    out = model(xt, batch["t"].to(torch.float32))
    if kind == "classifier":
        labels = batch["labels"]
        return (F.cross_entropy(out.float(), labels),
                (out.argmax(-1) == labels).to(torch.float32).mean())
    return ((out[..., :3] - batch["noise"]) ** 2).mean(), None


def train_step(model, opt, key, spec: TrainSpec, count: int, abar: torch.Tensor):
    """One Adam step at step `count`; returns (loss, accuracy or None) as
    device tensors (no host sync)."""
    batch = draw_batch(key, spec, abar.device)
    for group in opt.param_groups:
        group["lr"] = spec.lr_at(count)
    opt.zero_grad(set_to_none=True)
    loss, acc = batch_loss(model, batch, abar, spec.kind)
    loss.backward()
    opt.step()
    return loss.detach(), acc


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _run_hash(name: str, spec: TrainSpec) -> str:
    return hashlib.md5(repr((name, spec.kind, spec.res, len(spec.abar), spec.steps, spec.batch,
                             spec.lr, spec.cosine)).encode()).hexdigest()[:10]


def train(model, spec: TrainSpec, *, name: str, out: Path, seed: int = 1,
          log_every: int = 500, snapshot_every: int = 1000, log=print) -> dict:
    """The whole run from `model`'s current weights: keys from
    PRNGKey(`seed`), `key, k = split(key)` before every step, a snapshot
    (`out`/snapshot_<name>_<hash>.pt) every `snapshot_every` steps that a
    later call with the same configuration resumes from; returns {"tail":
    the logged losses, "seconds", "steps_run"}. The snapshot is deleted once
    the run completes."""
    dev = next(model.parameters()).device
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    abar = torch.as_tensor(spec.abar, dtype=torch.float32, device=dev)
    opt = make_optimizer(model, spec.lr)
    key = threefry.prng_key(seed, dev)
    snap = out / f"snapshot_{name}_{_run_hash(name, spec)}.pt"
    start, tail = 0, []
    if snap.exists():
        state = torch.load(snap, map_location=dev, weights_only=True)
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        start, tail, key = int(state["step"]), list(state["tail"]), state["key"].to(dev)
        log(f"# {name}: resumed from {snap} at step {start}")
    model.train()
    t0 = time.time()
    for step in range(start, spec.steps):
        ks = threefry.split(key)
        key, k = ks[0], ks[1]
        loss, acc = train_step(model, opt, k, spec, step, abar)
        if step % log_every == 0 or step == spec.steps - 1:
            row = {"step": step, "loss": round(float(loss), 5)}
            if acc is not None:
                row["acc"] = round(float(acc), 4)
            tail.append(row)
            log(f"# {name} step {step} loss {row['loss']:.4f}"
                + (f" acc {row['acc']:.3f}" if acc is not None else "")
                + f" ({time.time() - t0:.0f}s)")
        if step % snapshot_every == snapshot_every - 1 and step + 1 < spec.steps:
            torch.save({"model": model.state_dict(), "opt": opt.state_dict(), "step": step + 1,
                        "tail": tail, "key": key.cpu()}, snap)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.time() - t0
    snap.unlink(missing_ok=True)
    return {"tail": tail, "seconds": seconds, "steps_run": spec.steps - start}


def export(model: torch.nn.Module, out: Path, name: str, meta: dict,
           dtype: torch.dtype = torch.float16) -> Path:
    """`out`/<name>.pt (the state dict in `dtype`, under the reference
    checkpoints' keys) and `out`/<name>.json (`meta`); returns the .pt."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.pt"
    torch.save({k: v.detach().to("cpu", dtype) for k, v in model.state_dict().items()}, path)
    (out / f"{name}.json").write_text(json.dumps(meta, indent=2))
    return path


def arch_meta(kw: dict) -> dict:
    """A builder's keyword arguments as JSON values (tuples as lists)."""
    return {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}


def device_name(dev: torch.device) -> str:
    """The card's name, or "cpu": written beside every time a trainer keeps."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def per_step_seconds(result: dict) -> float:
    return result["seconds"] / max(1, result["steps_run"])

