"""The procedurally natural image family on the port (the PyTorch
counterpart of tools/experiments/natural_family.py).

`make_naturals` (data/synthetic.py: 1/f^alpha chromatic texture through
torch.fft.irfft2, a directional illumination gradient, four soft
elliptical objects, vignette and sensor grain) draws JAX's images from the
same threefry key to about 1e-5; `make_oldphoto_inputs` adds the old-photo
demo's irregular scratch mask. `main` writes the eval fixtures of a
resolution (PRNGKey(1234): n PNGs and one scratch mask from PRNGKey(77))
under --out only (default exp/train_torch/datasets/natural<res>); the
committed exp/datasets/natural* folders are the JAX script's.

  python tools/experiments/natural_family_torch.py [--res 64] [--n 8]
      [--out DIR] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from ddnm_tpu_torch.data.io import save_image  # noqa: E402
from ddnm_tpu_torch.data.synthetic import make_naturals  # noqa: E402
from ddnm_tpu_torch.sampling import threefry  # noqa: E402

__all__ = ["make_naturals", "make_oldphoto_inputs"]


def make_oldphoto_inputs(key, n: int, res: int):
    """(gt, keep): naturals and an irregular scratch mask (int64, 0 =
    damaged, about 14% of the pixels), a thresholded 1/f field."""
    k_img, k_scr = threefry.split(threefry.as_key(key))
    gt = make_naturals(k_img, n, res)
    dev = gt.device
    fy = torch.fft.fftfreq(res, device=dev)[:, None]
    fx = torch.fft.rfftfreq(res, device=dev)[None, :]
    f = torch.sqrt(fy ** 2 + fx ** 2)
    f[0, 0] = 1.0 / res
    re, im = threefry.normal(k_scr, (2, n, res, res // 2 + 1))
    field = torch.fft.irfft2(torch.complex(re, im) * f[None] ** -1.0, s=(res, res), dim=(1, 2))
    field = field / (field.std(dim=(1, 2), keepdim=True, correction=0) + 1e-6)
    return gt, (field.abs() > 0.18).to(torch.int64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cpu")
    ns = ap.parse_args(argv)

    out = Path(ns.out) if ns.out else REPO / f"exp/train_torch/datasets/natural{ns.res}"
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device(ns.device)
    gt = make_naturals(threefry.prng_key(1234, dev), ns.n, ns.res).cpu().numpy()
    for i in range(ns.n):
        save_image((gt[i] + 1.0) / 2.0, out / f"{i:05d}.png")
    _, keep = make_oldphoto_inputs(threefry.prng_key(77, dev), 1, ns.res)
    np.save(out / "scratch_keep_mask.npy", keep[0].cpu().numpy())
    print(f"wrote {ns.n} fixtures + scratch mask to {out}")


if __name__ == "__main__":
    main()
