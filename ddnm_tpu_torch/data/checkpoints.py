"""Checkpoint registry (port of ddnm_tpu/data/checkpoints.py): the
published torch checkpoints of the model families the configs name, with
md5 verification of a file placed by hand.

The port downloads nothing: the card's machine and the development host
have no network, so `fetch` of a missing file raises FileNotFoundError
naming the URL and the path to place it at, as the JAX package's does
without `requests`.

The JAX package's `load_params`, `save_orbax` and `load_orbax` are not
ported: they convert a torch state dict into a flax parameter tree (with
an .npz cache) and save or restore that tree with orbax. The port's models
are torch modules that load the published `.pt` files directly
(`load_checkpoint`, fp16 storage upcast), the exports of the port's own
trainers (training.py `export`) included, so it has no tree to convert or
save.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import torch

__all__ = ["CHECKPOINTS", "fetch", "load_checkpoint", "md5sum"]

# name -> (url, md5 or None, target file name), as the reference's maps
CHECKPOINTS = {
    "celeba_hq": (
        "https://image-editing-test-12345.s3-us-west-2.amazonaws.com/checkpoints/celeba_hq.ckpt",
        None,
        "celeba_hq.ckpt",
    ),
    "imagenet_256_uncond": (
        "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/256x256_diffusion_uncond.pt",
        None,
        "256x256_diffusion_uncond.pt",
    ),
    "imagenet_256_cond": (
        "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/256x256_diffusion.pt",
        None,
        "256x256_diffusion.pt",
    ),
    "imagenet_256_classifier": (
        "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/256x256_classifier.pt",
        None,
        "256x256_classifier.pt",
    ),
    "ema_lsun_bedroom": (
        "https://heibox.uni-heidelberg.de/f/b95206528f384185889b/?dl=1",
        "1921fa46b66a3665e450e42f36c2720f",
        "ema_lsun_bedroom.ckpt",
    ),
    "ema_lsun_cat": (
        "https://heibox.uni-heidelberg.de/f/0701aac3aa69457bbe34/?dl=1",
        "646f23f4821f2459b8bafc57fd824558",
        "ema_lsun_cat.ckpt",
    ),
    "ema_lsun_church": (
        "https://heibox.uni-heidelberg.de/f/44ccb50ef3c6436db52e/?dl=1",
        "fdc68a23938c2397caba4a260bc2445f",
        "ema_lsun_church.ckpt",
    ),
}


def load_checkpoint(model: torch.nn.Module, path: str | Path) -> None:
    """Load a reference state dict (.pt) strictly, upcasting fp16 storage."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.float() if v.dtype == torch.float16 else v for k, v in sd.items()}
    model.load_state_dict(sd, strict=True)


def md5sum(path: Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def fetch(name: str, root: str | Path = "exp/logs", *, allow_download: bool = True) -> Path:
    """The local path of a registered checkpoint, md5-verified where the
    registry has a checksum. A missing file raises FileNotFoundError:
    with `allow_download` the message names the URL to fetch by hand."""
    if name not in CHECKPOINTS:
        raise KeyError(f"unknown checkpoint {name!r}; known: {sorted(CHECKPOINTS)}")
    url, md5, fname = CHECKPOINTS[name]
    path = Path(root) / fname
    if path.exists():
        if md5 and md5sum(path) != md5:
            raise IOError(f"{path} exists but fails md5 check ({md5})")
        return path
    if not allow_download:
        raise FileNotFoundError(f"checkpoint {name} missing; place it at {path}")
    raise FileNotFoundError(f"checkpoint {name} missing and the port downloads nothing; "
                            f"download {url} to {path} manually")
