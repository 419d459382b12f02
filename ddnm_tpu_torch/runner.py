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

Paths of the JAX runner that are not ported yet raise
NotImplementedError: the multistep solver and the encoder cache. A run uses
the one device given by `device`; the JAX runner's sharding over several
devices is not ported.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.config import Config
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
from ddnm_tpu_torch.runtime import resolve_device
from ddnm_tpu_torch.sampling import build_schedule, sample_simplified, sample_svd
from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec
from ddnm_tpu_torch.sampling.rng import (
    STREAM_INIT,
    STREAM_MEASUREMENT,
    STREAM_SAMPLE,
    default_noise,
    image_generators,
)

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
    solver: str = "ddim"
    encoder_cache: int = 1  # > 1 is not ported: raises
    device: str = "cuda"


def load_checkpoint(model: torch.nn.Module, path: str | Path) -> None:
    """Load a reference state dict (.pt) strictly, upcasting fp16 storage."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.float() if v.dtype == torch.float16 else v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)


class Runner:
    def __init__(self, args: RunArgs, config: Config):
        self.device = resolve_device(args.device)
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
        if args.solver == "multistep":
            raise NotImplementedError(
                "--solver multistep is not ported yet (ROADMAP.md Queue 1, later "
                "slice D: solvers and acceleration)")
        if args.encoder_cache > 1:
            raise NotImplementedError(
                "--encoder_cache is not ported yet (ROADMAP.md Queue 1, later "
                "slice D: solvers and acceleration)")
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

    @property
    def batch_size(self) -> int:
        return self.args.batch_size or self.config.sampling.batch_size

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
            ds.paths = ds.paths[: args.max_images]
            if hasattr(ds, "labels"):
                ds.labels = ds.labels[: args.max_images]
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
        logger.info("dataset size %d, batch size %d, device %s, dtype %s",
                    len(dataset), self.batch_size, dev, args.dtype)
        sigma_y = 2.0 * args.sigma_y  # [0,1] -> [-1,1] domain, as the reference

        out_dir = Path(args.image_folder)
        (out_dir / "Apy").mkdir(parents=True, exist_ok=True)
        size = cfg.data.image_size
        total_psnr, count, sample_seconds, consistency = 0.0, 0, 0.0, 0.0
        idx_so_far = max(args.subset_start, 0)
        wall_start = time.perf_counter()
        with open(out_dir / "metrics.jsonl", "a") as metrics:
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
                x_orig = data_transform(torch.from_numpy(imgs).to(dev),
                                        rescaled=cfg.data.rescaled)
                x_init = default_noise(
                    image_generators(args.seed, idxs, STREAM_INIT, dev), (n, size, size, 3))
                gens = image_generators(args.seed, idxs, STREAM_SAMPLE, dev)
                # the noise enters after A and before A+ y, in both modes
                if args.simplified:
                    y = self._measurement_noise(operator.A(x_orig), idxs, sigma_y)
                    apy = operator.Ap(y)
                    t0 = time.perf_counter()
                    x, _ = sample_simplified(
                        model_fn, x_init, y, operator, self.sched, gens,
                        eta=args.eta, sigma_y=sigma_y, solver=args.solver,
                    )
                else:
                    y = self._measurement_noise(operator.A(_nhwc_to_vec(x_orig)), idxs,
                                                sigma_y)
                    apy = self._apy_visualisation(operator, y, n)
                    t0 = time.perf_counter()
                    x, _ = sample_svd(
                        model_fn, x_init, y, operator, self.sched, gens,
                        eta=args.eta, sigma_y=sigma_y, guidance_fn=guidance_fn,
                        solver=args.solver,
                    )
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                sample_seconds += time.perf_counter() - t0
                # range-space consistency of the sampler's output, unclipped
                ax = operator.A(x if args.simplified else _nhwc_to_vec(x))
                consistency = max(consistency, float((ax - y)[:valid].abs().max()))

                x01 = inverse_data_transform(x, rescaled=cfg.data.rescaled)
                orig01 = inverse_data_transform(x_orig, rescaled=cfg.data.rescaled)
                apy01 = inverse_data_transform(apy, rescaled=cfg.data.rescaled)
                batch_psnr = psnr(x01, orig01).cpu().numpy()
                batch_ssim = ssim(x01, orig01).cpu().numpy()
                x01_np, apy_np, orig_np = (t.cpu().numpy() for t in (x01, apy01, orig01))
                for i in range(valid):
                    save_image(apy_np[i], out_dir / "Apy" / f"Apy_{idx_so_far + i}.png")
                    save_image(orig_np[i], out_dir / "Apy" / f"orig_{idx_so_far + i}.png")
                    save_image(x01_np[i], out_dir / f"{idx_so_far + i}_0.png")
                    total_psnr += float(batch_psnr[i])
                    count += 1
                metrics.write(json.dumps({
                    "psnr": float(np.mean(batch_psnr[:valid])),
                    "ssim": float(np.mean(batch_ssim[:valid])),
                    "images": count,
                    "images_per_sec": count / (time.perf_counter() - wall_start),
                }) + "\n")
                logger.info("images %d, PSNR: %.2f", count, total_psnr / max(count, 1))
                idx_so_far += valid

        wall = time.perf_counter() - wall_start
        avg = total_psnr / max(count, 1)
        print(f"Total Average PSNR: {avg:.2f}")
        print(f"Number of samples: {count}")
        return {
            "avg_psnr": avg,
            "num_samples": count,
            "wall_seconds": wall,
            "images_per_second": count / wall if wall > 0 else 0.0,
            "sample_seconds": sample_seconds,
            "range_space_max_abs": consistency,
        }
