"""Restoration runner: config -> model -> operator -> sampler -> PNGs + PSNR
(port of ddnm_tpu/runner.py: simplified mode and SVD mode).

The model comes from a torch checkpoint (`--ckpt`, the reference's state
dict, fp16 storage upcast to fp32) or from `--random_init` (weights from
the seed). Images run in batches; every image draws its x_T and sampler
noise from its own generators keyed by (seed, global image index), so the
outputs do not depend on the batch size. Progress is plain log lines.

Paths of the JAX runner that are not ported yet raise
NotImplementedError: the ADM model family, classifier guidance, the
encoder cache, measurement noise. A run uses the one device given by
`device`; the JAX runner's sharding over several devices is not ported.
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
from ddnm_tpu_torch.data.transforms import data_transform, inverse_data_transform
from ddnm_tpu_torch.models import DDPMUNet, cast_torso
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.runtime import resolve_device
from ddnm_tpu_torch.sampling import build_schedule, sample_simplified, sample_svd
from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec
from ddnm_tpu_torch.sampling.rng import (
    STREAM_INIT,
    STREAM_SAMPLE,
    default_noise,
    image_generators,
)

logger = logging.getLogger("ddnm_tpu_torch")

__all__ = ["RunArgs", "Runner", "load_checkpoint"]


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
    subset_start: int = -1
    subset_end: int = -1
    ckpt: Optional[str] = None
    classifier_ckpt: Optional[str] = None  # not ported: raises
    random_init: bool = False
    batch_size: Optional[int] = None
    dtype: str = "float32"  # model torso dtype: float32 | bfloat16
    mask_path: Optional[str] = None
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
        if config.model.type != "simple":
            raise NotImplementedError(
                f"model type {config.model.type!r} is not ported yet "
                "(ROADMAP.md Queue 1, later slice C: hq/ADM)")
        if args.classifier_ckpt:
            raise NotImplementedError(
                "classifier guidance is not ported yet: ADMClassifier comes with "
                "the hq/ADM models (ROADMAP.md Queue 1, later slice C)")
        if args.solver == "multistep":
            raise NotImplementedError(
                "--solver multistep is not ported yet (ROADMAP.md Queue 1, later "
                "slice D: solvers and acceleration)")
        if args.encoder_cache > 1:
            raise NotImplementedError(
                "--encoder_cache is not ported yet (ROADMAP.md Queue 1, later "
                "slice D: solvers and acceleration)")
        if args.add_noise:
            raise NotImplementedError(
                "--add_noise is not ported yet (data/noise.py, ROADMAP.md "
                "Queue 1, later slice E)")
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
    def build_model(self) -> DDPMUNet:
        args = self.args
        model = DDPMUNet.from_config(self.config)
        if args.ckpt and Path(args.ckpt).exists():
            logger.info("loading checkpoint %s", args.ckpt)
            load_checkpoint(model, args.ckpt)
        elif args.random_init:
            logger.warning("random-init model (no checkpoint): smoke/bench mode")
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(args.seed)
                model = DDPMUNet.from_config(self.config)
        else:
            raise FileNotFoundError(
                f"checkpoint {args.ckpt!r} not found; pass --ckpt or --random_init")
        model = model.to(self.device).eval()
        if self.dtype == torch.bfloat16:
            cast_torso(model, torch.bfloat16)
        return model

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
            subset=subset,
            out_of_dist=bool(getattr(cfg.data, "out_of_dist", False)),
        )
        if args.max_images:
            ds.paths = ds.paths[: args.max_images]
        return ds

    # ---------------------------------------------------------------- running
    def run(self) -> dict:
        args, cfg, dev = self.args, self.config, self.device
        model = self.build_model()
        operator = self.build_operator()
        dataset = self.build_dataset()
        logger.info("dataset size %d, batch size %d, device %s, dtype %s",
                    len(dataset), self.batch_size, dev, args.dtype)
        sigma_y = 2.0 * args.sigma_y  # [0,1] -> [-1,1] domain, as the reference

        out_dir = Path(args.image_folder)
        (out_dir / "Apy").mkdir(parents=True, exist_ok=True)
        size = cfg.data.image_size
        total_psnr, count, sample_seconds = 0.0, 0, 0.0
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
                if args.simplified:
                    y = operator.A(x_orig)
                    apy = operator.Ap(y)
                    t0 = time.perf_counter()
                    x, _ = sample_simplified(
                        model, x_init, y, operator, self.sched, gens,
                        eta=args.eta, sigma_y=sigma_y, solver=args.solver,
                    )
                else:
                    y = operator.A(_nhwc_to_vec(x_orig))
                    apy = self._apy_visualisation(operator, y, n)
                    t0 = time.perf_counter()
                    x, _ = sample_svd(
                        model, x_init, y, operator, self.sched, gens,
                        eta=args.eta, sigma_y=sigma_y, solver=args.solver,
                    )
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                sample_seconds += time.perf_counter() - t0

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
        }
