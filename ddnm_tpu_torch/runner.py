"""Restoration runner: config -> model -> operator -> sampler -> PNGs + PSNR
(port of ddnm_tpu/runner.py: simplified mode and SVD mode, on the DDPM
("simple") and ADM ("openai") UNets).

The model comes from a torch checkpoint (`--ckpt`, the reference's state
dict, fp16 storage upcast to fp32) or from `--random_init` (weights from
the seed). A class-conditional ADM gets the label GUIDED_CLASS for every
image, as in the JAX runner. Images run in batches; every image draws its
x_T, its measurement noise (`--add_noise`) and its sampler noise from its
own generators keyed by (seed, global image index), so the outputs do not
depend on the batch size. Progress is plain log lines.

A class-conditional ADM whose config has a `classifier:` block is guided
toward GUIDED_CLASS in SVD mode, as in the JAX runner: the ADM classifier
from --classifier_ckpt, or from the seed under --random_init (otherwise
FileNotFoundError); with --simplified the classifier is built and not used,
as JAX does.

`--solver multistep` runs the second-order deterministic solver in both
modes (noise-free tasks only: with sigma_y or --add_noise it raises
ValueError, as JAX does). `--encoder_cache N > 1` runs the simplified mode
through the encoder propagation (sampling/accel.py) with the model's
split halves and `--encoder_cache_policy`; in SVD mode it has no effect
(the exact sampler runs, as in the JAX runner, and a log line says so).
Several cards: a run uses one card unless its caller passes a data mesh
(`Runner(..., mesh=)`, `main_torch.main(mesh=)`; parallel/mesh.py: the
model, the guidance classifier, the operator and the encoder cache's
halves replicated on each entry, each entry's images on a stream of its
own), which then shards every batch whose size it divides, on every route
(simplified, SVD, guided SVD, the multistep solver, the encoder cache).
The JAX runner shards over every device by default; this one does not:
host-driven on 4 H100s no mesh beat one card, one process a card scaled
3.7-4.0x, and under the scan a mesh of 2 cards gave 1.72-1.73x and of
4 cards 2.49x (PERF.md §6).
Under a multi-process launch (parallel/multihost.py, torchrun) each
process restores its own contiguous slice of the dataset on its own card,
under the images' global indices, and writes its metrics to
metrics_rank<r>.jsonl.

The host overlaps the device as the JAX runner does: batches decode ahead
on a thread pool (`iterate_batches`, prefetch 2), and after batch k's
sampler returns, its PSNR, SSIM and [0, 1] images are enqueued on the
device and copied without blocking into pinned host memory behind a CUDA
event; a drain job on a 4-thread pool waits on that event, writes the
three PNGs per image and the batch's metrics line (`MetricsLogger`,
in batch order) while the main thread launches batch k + 1. The sampler's
seconds come from CUDA events around each call, and max |A(x) - y| stays
on the device, both read once at the end. `trace_dir` writes a
torch.profiler trace of the loop.

`loop` is the JAX CLI's sampler driver (sampling/graphs.py): "auto" (the
default) and "scan" run each batch's trajectory as one CUDA graph,
captured at the first batch and replayed for the others (the graphs are
dropped when the run ends); "host" the eager loop. Under a data mesh
each shard's trajectory is a graph of its own (parallel/mesh.py), as JAX's
scan runs on sharded arrays; the encoder cache runs host-driven whatever
`loop` says, as in the JAX runner. The
sampler's CUDA events time a replay as a whole.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.config import Config
from ddnm_tpu_torch.data.checkpoints import load_checkpoint
from ddnm_tpu_torch.data.datasets import get_dataset, iterate_batches
from ddnm_tpu_torch.data.io import load_mask, save_image
from ddnm_tpu_torch.data.metrics import psnr, ssim
from ddnm_tpu_torch.data.noise import add_noise
from ddnm_tpu_torch.data.transforms import data_transform, inverse_data_transform
from ddnm_tpu_torch.models import (
    ADMClassifier,
    ADMUNet,
    DDPMUNet,
    cast_torso,
    classifier_guidance_fn,
)
from ddnm_tpu_torch.models.unet_adm import init_like_flax
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.parallel import multihost
from ddnm_tpu_torch.parallel.mesh import Mesh, replicate_all, sharded_sampler
from ddnm_tpu_torch.runtime import resolve_device, to_device, to_host
from ddnm_tpu_torch.sampling import build_schedule, graphs, sample_simplified, sample_svd
from ddnm_tpu_torch.sampling.accel import (
    adm_split_fns,
    ddpm_split_fns,
    key_steps_for_policy,
    n_model_calls,
    sample_simplified_encoder_prop,
)
from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec
from ddnm_tpu_torch.sampling.rng import (
    STREAM_INIT,
    STREAM_MEASUREMENT,
    STREAM_SAMPLE,
    default_noise,
    image_generators,
)
from ddnm_tpu_torch.utils.observability import MetricsLogger, profile

logger = logging.getLogger("ddnm_tpu_torch")

__all__ = ["GUIDED_CLASS", "RunArgs", "Runner", "load_checkpoint"]

# the ImageNet class every image of a class-conditional run is given (the
# reference's svd_ddnm.py:7, ddnm_tpu/runner.py:47)
GUIDED_CLASS = 951


@dataclasses.dataclass
class RunArgs:
    """CLI-facing arguments (main_torch.py)."""

    config: str = ""
    deg: str = "sr_averagepooling"
    deg_scale: float = 4.0
    sigma_y: float = 0.0
    eta: float = 0.85
    seed: int = 1234
    exp: str = "exp"
    path_y: str = "celeba_hq"
    image_folder: str = "output"
    simplified: bool = False
    add_noise: bool = False
    noise_type: str = "gaussian"  # data/noise.py NOISE_TYPES
    subset_start: int = -1
    subset_end: int = -1
    ckpt: Optional[str] = None
    classifier_ckpt: Optional[str] = None  # the guidance classifier (.pt)
    random_init: bool = False
    batch_size: Optional[int] = None
    dtype: str = "float32"  # model torso dtype: float32 | bfloat16
    mask_path: Optional[str] = None
    manifest: Optional[str] = None  # ImageNet (filename class) manifest
    max_images: Optional[int] = None
    resume: bool = False  # skip images whose output PNG already exists
    solver: str = "ddim"  # ddim | multistep
    encoder_cache: int = 1  # > 1: the encoder propagation's interval
    encoder_cache_policy: str = "uniform"  # uniform | end_dense
    device: str = "cuda"
    trace_dir: Optional[str] = None  # torch.profiler trace of the run
    loop: str = "auto"  # the sampler's loop driver: auto | scan | host (sampling/graphs.py)


class _SamplerClock:
    """Seconds of one sampler call: CUDA events around it on a card (read
    at the end of the run, no wait per batch), the host clock elsewhere."""

    def __init__(self, dev: torch.device):
        self._events = None
        if dev.type == "cuda":
            # on the run's card's stream (a sharded call makes that stream
            # wait for every shard before it returns)
            self._stream = torch.cuda.current_stream(dev)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._events is not None:
            self._events[1].record(self._stream)
        self._t1 = time.perf_counter()

    def seconds(self) -> float:
        if self._events is None:
            return self._t1 - self._t0
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1]) / 1e3


class Runner:
    def __init__(self, args: RunArgs, config: Config, mesh: Optional[Mesh] = None):
        self.device = resolve_device(args.device)
        if multihost.process_count() > 1:
            self.device = multihost.local_device(self.device)
        if config.model.type not in ("simple", "openai"):
            raise ValueError(f"unknown model type {config.model.type}")
        # the JAX runner's refusals of the multistep solver (ddnm_tpu/runner.py:112-123)
        if args.solver == "multistep" and (args.sigma_y != 0.0 or args.add_noise):
            raise ValueError(
                "--solver multistep is deterministic and supports noise-free "
                "tasks only (sigma_y == 0, no --add_noise)")
        if args.solver == "multistep" and args.encoder_cache > 1:
            raise ValueError(
                "--solver multistep does not compose with --encoder_cache (the "
                "encoder-propagation sampler is DDIM-only); drop one of the two")
        if args.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32 or bfloat16, got {args.dtype!r}")
        self.args = args
        self.config = config
        self.betas = sch.get_beta_schedule(
            config.diffusion.beta_schedule,
            beta_start=config.diffusion.beta_start,
            beta_end=config.diffusion.beta_end,
            num_diffusion_timesteps=config.diffusion.num_diffusion_timesteps,
        ).astype(np.float32)
        self.sched = build_schedule(
            betas=self.betas,
            t_sampling=config.time_travel.T_sampling,
            travel_length=config.time_travel.travel_length,
            travel_repeat=config.time_travel.travel_repeat,
        )
        self.dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
        self.mesh = self._data_mesh(mesh)
        self.loop = graphs.resolve_loop(args.loop, mesh=self.mesh)

    @property
    def batch_size(self) -> int:
        return self.args.batch_size or self.config.sampling.batch_size

    def _data_mesh(self, mesh: Optional[Mesh]) -> Optional[Mesh]:
        """The mesh each batch shards over, or None (one device): `mesh` as
        given, the run then building on its first entry."""
        if mesh is None:
            return None
        if mesh.devices[0].type != self.device.type:
            raise ValueError(f"a {mesh.devices[0].type} mesh for a {self.device} run")
        self.device = mesh.devices[0]
        return mesh if mesh.size > 1 else None

    # ------------------------------------------------------------------ model
    def build_model(self) -> DDPMUNet | ADMUNet:
        """The config's UNet on the run's device: a checkpoint loaded
        strictly, or under --random_init weights drawn from the seed (the
        ADM's as the JAX package's init draws them, init_like_flax); frozen,
        so that a call outside torch.no_grad runs the forward alone (the
        GroupNorm gradient gives dx only and refuses trainable parameters)."""
        args, cfg = self.args, self.config
        ckpt = args.ckpt if args.ckpt and Path(args.ckpt).exists() else None
        if ckpt is None and not args.random_init:
            raise FileNotFoundError(
                f"checkpoint {args.ckpt!r} not found; pass --ckpt or --random_init")
        if cfg.model.type == "openai":
            with torch.device(self.device):
                model = ADMUNet.from_config(cfg)
            if ckpt is None:
                init_like_flax(model, args.seed)
        else:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(args.seed)
                model = DDPMUNet.from_config(cfg)
        if ckpt is None:
            logger.warning("random-init model (no checkpoint): smoke/bench mode")
        else:
            logger.info("loading checkpoint %s", ckpt)
            load_checkpoint(model, ckpt)
        model = model.to(self.device).eval().requires_grad_(False)
        if self.dtype == torch.bfloat16:
            cast_torso(model, torch.bfloat16)
        return model

    def build_guidance(self):
        """The guidance hook, where the JAX runner builds one
        (ddnm_tpu/runner.py:173-191: a class-conditional ADM and a config
        with a classifier block; elsewhere None and --classifier_ckpt is
        ignored): the config's ADM classifier on the run's device in the
        run's dtype, loaded strictly from --classifier_ckpt or, under
        --random_init, drawn from the model's seed; guidance toward
        GUIDED_CLASS with the config's classifier_scale."""
        args, cfg = self.args, self.config
        if not (cfg.model.type == "openai" and cfg.model.class_cond
                and cfg.classifier is not None):
            return None
        ckpt = (args.classifier_ckpt if args.classifier_ckpt
                and Path(args.classifier_ckpt).exists() else None)
        if ckpt is None and not args.random_init:
            raise FileNotFoundError(
                f"classifier checkpoint {args.classifier_ckpt!r} not found; pass "
                "--classifier_ckpt or --random_init")
        with torch.device(self.device):
            classifier = ADMClassifier.from_config(cfg.classifier, cfg.data.image_size)
        if ckpt is not None:
            logger.info("loading classifier checkpoint %s", ckpt)
            load_checkpoint(classifier, ckpt)
        else:
            init_like_flax(classifier, args.seed)
        if self.dtype == torch.bfloat16:
            cast_torso(classifier, torch.bfloat16)
        return classifier_guidance_fn(classifier, GUIDED_CLASS,
                                      cfg.classifier.classifier_scale)

    def model_fn(self, model):
        """model(x, t), with the label GUIDED_CLASS for every image where the
        model is class-conditional (ddnm_tpu/runner.py:161-171)."""
        if not (self.config.model.type == "openai" and self.config.model.class_cond):
            return model
        return lambda x, t: model(x, t, torch.full((x.shape[0],), GUIDED_CLASS,
                                                   dtype=torch.long, device=x.device))

    def _encoder_key_steps(self):
        """key_steps of --encoder_cache_policy (None: the uniform interval)."""
        return key_steps_for_policy(n_model_calls(self.sched), self.args.encoder_cache,
                                    self.args.encoder_cache_policy)

    def _split_fns(self, model):
        """(encode_fn, decode_fn) of --encoder_cache: the DDPM UNet's halves,
        or the ADM's mode="encode" / "decode" forwards with the label
        GUIDED_CLASS where the model is class-conditional."""
        if self.config.model.type == "simple":
            return ddpm_split_fns(model)
        return adm_split_fns(model, label=GUIDED_CLASS if self.config.model.class_cond else None)

    # -------------------------------------------------------------- operators
    def _mask(self) -> np.ndarray:
        path = self.args.mask_path
        if path is None:
            default = Path(self.args.exp) / "inp_masks" / "mask.npy"
            if not default.exists():
                raise ValueError(f"task {self.args.deg} needs --mask_path (or {default})")
            mask = load_mask(default)
        else:
            mask = load_mask(path)
        size = self.config.data.image_size
        if mask.ndim >= 2 and mask.shape[-2:] != (size, size):
            logger.info("resizing %sx%s mask to %dpx (nearest)",
                        mask.shape[-2], mask.shape[-1], size)
            ys = (np.arange(size) * mask.shape[-2] // size).astype(np.int64)
            xs = (np.arange(size) * mask.shape[-1] // size).astype(np.int64)
            mask = mask[..., ys[:, None], xs[None, :]]
        return mask

    def build_operator(self):
        args, cfg = self.args, self.config
        needs_mask = args.deg in ("inpainting", "mask_color_sr", "diy")
        mask = self._mask() if needs_mask else None
        if args.simplified:
            return build_functional_operator(
                args.deg,
                image_size=cfg.data.image_size,
                deg_scale=args.deg_scale,
                mask=mask,
                device=self.device,
            )
        return build_svd_operator(
            args.deg,
            channels=cfg.data.channels,
            image_size=cfg.data.image_size,
            deg_scale=args.deg_scale,
            mask=mask,
            seed=args.seed,
            device=self.device,
        )

    def _apy_visualisation(self, operator, y, n):
        """SVD-mode A+y preview (NHWC) with the reference's task special
        cases: deblurring shows y itself, colorization the gray y over 3
        channels, inpainting fills the holes with 1 (white)."""
        size = self.config.data.image_size
        deg = self.args.deg
        if deg.startswith("deblur"):
            apy = y
        elif deg == "colorization":
            apy = y.reshape(n, 1, size, size).expand(n, 3, size, size)
        else:
            apy = operator.A_pinv(y)
            if deg == "inpainting":
                ones = torch.ones((n, 3 * size * size), device=y.device)
                apy = apy + operator.A_pinv(operator.A(ones)) - 1.0
        return apy.reshape(n, 3, size, size).permute(0, 2, 3, 1)

    # ------------------------------------------------------------------- data
    def build_dataset(self):
        args, cfg = self.args, self.config
        root = Path(args.path_y)
        if not root.is_absolute():
            root = Path(args.exp) / "datasets" / args.path_y
        subset = None
        if args.subset_start >= 0 and args.subset_end > 0:
            subset = (args.subset_start, args.subset_end)
        ds = get_dataset(
            cfg.data.dataset,
            root=root,
            image_size=cfg.data.image_size,
            manifest=args.manifest,
            subset=subset,
            out_of_dist=bool(getattr(cfg.data, "out_of_dist", False)),
        )
        if args.max_images:
            # the global cap, before the process's slice: a multi-process
            # run covers the images of a single-process one
            ds.paths = ds.paths[: args.max_images]
            if hasattr(ds, "labels"):
                ds.labels = ds.labels[: args.max_images]
        if subset is None and multihost.process_count() > 1:
            # every process takes a disjoint contiguous slice; output
            # indices and --resume stay global (ddnm_tpu/runner.py)
            p, c = multihost.process_index(), multihost.process_count()
            s, e = multihost.process_subset(len(ds.paths), p, c)
            ds.paths = ds.paths[s:e]
            if hasattr(ds, "labels"):
                ds.labels = ds.labels[s:e]
            args.subset_start = s
            logger.info("process %d of %d takes images [%d, %d)", p, c, s, e)
        return ds

    def _measurement_noise(self, y, idxs, sigma_y):
        """y with --add_noise's noise, each image's drawn from its own
        STREAM_MEASUREMENT generator (the JAX runner's k_noise)."""
        if not self.args.add_noise or sigma_y <= 0.0:
            return y
        gens = image_generators(self.args.seed, idxs, STREAM_MEASUREMENT, self.device)
        return torch.stack([add_noise(g, y[i], sigma_y, self.args.noise_type)
                            for i, g in enumerate(gens)])

    # ---------------------------------------------------------------- running
    def run(self) -> dict:
        args, cfg, dev = self.args, self.config, self.device
        model = self.build_model()
        guidance_fn = self.build_guidance()
        model_fn = self.model_fn(model)
        operator = self.build_operator()
        dataset = self.build_dataset()
        logger.info("dataset size %d, batch size %d, device %s, dtype %s%s",
                    len(dataset), self.batch_size, dev, args.dtype,
                    "" if self.mesh is None else f", mesh {self.mesh}")
        sigma_y = 2.0 * args.sigma_y  # [0,1] -> [-1,1] domain, as the reference
        encode_fn = decode_fn = key_steps = None
        if args.encoder_cache > 1 and args.simplified:
            encode_fn, decode_fn = self._split_fns(model)
            key_steps = self._encoder_key_steps()
        elif args.encoder_cache > 1:
            logger.info("--encoder_cache %d has no effect in SVD mode: the exact sampler "
                        "runs (the encoder propagation is simplified-mode only)",
                        args.encoder_cache)
        # what the samplers read on the device: as they are on one device,
        # else one copy a card (the model copied once) and the samplers
        # sharded over the mesh
        shard = lambda fn: fn
        samp_model, samp_guide, samp_op, samp_enc, samp_dec = (
            model_fn, guidance_fn, operator, encode_fn, decode_fn)
        if self.mesh is not None:
            samp_model, samp_guide, samp_op, samp_enc, samp_dec = replicate_all(
                self.mesh, model_fn, guidance_fn, operator, encode_fn, decode_fn)
            shard = lambda fn: sharded_sampler(fn, self.mesh)

        out_dir = Path(args.image_folder)
        (out_dir / "Apy").mkdir(parents=True, exist_ok=True)
        size = cfg.data.image_size
        rescaled = cfg.data.rescaled
        metrics = MetricsLogger(out_dir / ("metrics.jsonl" if multihost.process_count() == 1
                                           else f"metrics_rank{multihost.process_index()}.jsonl"))
        totals = {"psnr": 0.0, "count": 0}
        clocks, jobs = [], []
        consistency = None  # max |A(x) - y| so far, on the device
        prev_done = None  # the previous batch's metrics line is written
        idx_so_far = max(args.subset_start, 0)
        wall_start = time.perf_counter()

        def drain(ready, host, valid, idx0, prev, done):
            """Batch idx0's PNGs, then (after the previous batch's) its
            metrics line and running PSNR."""
            try:
                if ready is not None:
                    ready.synchronize()
                batch_psnr, batch_ssim, x01, apy01, orig01 = (t.numpy() for t in host)
                for i in range(valid):
                    save_image(apy01[i], out_dir / "Apy" / f"Apy_{idx0 + i}.png")
                    save_image(orig01[i], out_dir / "Apy" / f"orig_{idx0 + i}.png")
                    save_image(x01[i], out_dir / f"{idx0 + i}_0.png")
                if prev is not None:
                    prev.wait()
                for i in range(valid):
                    totals["psnr"] += float(batch_psnr[i])
                    totals["count"] += 1
                metrics.logkv_mean("psnr", float(np.mean(batch_psnr[:valid])))
                metrics.logkv_mean("ssim", float(np.mean(batch_ssim[:valid])))
                metrics.logkv("images", totals["count"])
                metrics.logkv("images_per_sec",
                              totals["count"] / (time.perf_counter() - wall_start))
                metrics.dumpkvs()
                logger.info("images %d, PSNR: %.2f", totals["count"],
                            totals["psnr"] / max(totals["count"], 1))
            finally:
                done.set()

        with (profile(args.trace_dir), ThreadPoolExecutor(max_workers=4) as io_pool,
              graphs.scope()):
            for imgs, _, valid in iterate_batches(dataset, self.batch_size):
                if args.resume and all(
                    (out_dir / f"{idx_so_far + i}_0.png").exists() for i in range(valid)
                ):
                    logger.info("resume: skipping images %d..%d", idx_so_far,
                                idx_so_far + valid - 1)
                    idx_so_far += valid
                    continue
                n = len(imgs)
                idxs = range(idx_so_far, idx_so_far + n)
                x_orig = data_transform(to_device(torch.from_numpy(imgs), dev), rescaled=rescaled)
                x_init = default_noise(
                    image_generators(args.seed, idxs, STREAM_INIT, dev), (n, size, size, 3))
                gens = image_generators(args.seed, idxs, STREAM_SAMPLE, dev)
                # the noise enters after A and before A+ y, in both modes
                if args.simplified:
                    y = self._measurement_noise(operator.A(x_orig), idxs, sigma_y)
                    apy = operator.Ap(y)
                    clock = _SamplerClock(dev)
                    if args.encoder_cache > 1:
                        x, _ = shard(sample_simplified_encoder_prop)(
                            samp_enc, samp_dec, x_init, y, samp_op, self.sched, gens,
                            eta=args.eta, sigma_y=sigma_y, interval=args.encoder_cache,
                            key_steps=key_steps)
                    else:
                        x, _ = shard(sample_simplified)(
                            samp_model, x_init, y, samp_op, self.sched, gens,
                            eta=args.eta, sigma_y=sigma_y, solver=args.solver,
                            loop=self.loop,
                        )
                else:
                    y = self._measurement_noise(operator.A(_nhwc_to_vec(x_orig)), idxs,
                                                sigma_y)
                    apy = self._apy_visualisation(operator, y, n)
                    clock = _SamplerClock(dev)
                    x, _ = shard(sample_svd)(
                        samp_model, x_init, y, samp_op, self.sched, gens,
                        eta=args.eta, sigma_y=sigma_y, guidance_fn=samp_guide,
                        solver=args.solver, loop=self.loop,
                    )
                clock.stop()
                clocks.append(clock)
                # range-space consistency of the sampler's output, unclipped
                ax = operator.A(x if args.simplified else _nhwc_to_vec(x))
                err = (ax - y)[:valid].abs().max()
                consistency = err if consistency is None else torch.maximum(consistency, err)

                x01 = inverse_data_transform(x, rescaled=rescaled)
                orig01 = inverse_data_transform(x_orig, rescaled=rescaled)
                apy01 = inverse_data_transform(apy, rescaled=rescaled)
                host = [to_host(t) for t in (psnr(x01, orig01), ssim(x01, orig01),
                                              x01[:valid], apy01[:valid], orig01[:valid])]
                ready = None
                if dev.type == "cuda":
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(dev))
                done = threading.Event()
                jobs.append(io_pool.submit(drain, ready, host, valid, idx_so_far, prev_done,
                                           done))
                prev_done = done
                idx_so_far += valid
            for job in jobs:
                job.result()
        metrics.close()

        wall = time.perf_counter() - wall_start
        count = totals["count"]
        avg = totals["psnr"] / max(count, 1)
        print(f"Total Average PSNR: {avg:.2f}")
        print(f"Number of samples: {count}")
        sample_seconds = sum(c.seconds() for c in clocks)
        consistency = 0.0 if consistency is None else float(consistency)
        return {
            "avg_psnr": avg,
            "num_samples": count,
            "wall_seconds": wall,
            "images_per_second": count / wall if wall > 0 else 0.0,
            "sample_seconds": sample_seconds,
            "range_space_max_abs": consistency,
        }
