"""Train the flagship (256 px, 114M) golden-tier DDPM on the port (the
PyTorch counterpart of tools/train_flagship_golden.py).

The reference's "simple" CelebA-HQ family at its published architecture
(configs/celeba_hq.yml: ch 128, mult (1, 1, 2, 2, 4, 4), two res blocks,
single-head attention at 16 px over C = 512, and at 8 px in the middle
block), trained by tools/train_mid_golden_torch.py's loop on the 50/50
blob + natural mix drawn at 256 px on the card. One step at batch 16 runs
71 GroupNorms and 6 attentions forward and back through the port's
kernels. Writes only under --out (default exp/train_torch/flag256/):
flag_ddpm256.pt (fp16), its metadata and flag256.yml.

  python tools/train_flagship_golden_torch.py [--steps 5000] [--batch 16]
      [--lr 2e-4] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import train_mid_golden_torch as mid  # noqa: E402
from train_toy_golden_torch import ddpm_config_yaml  # noqa: E402

RES = 256
DDPM_KW = dict(ch=128, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
               attn_resolutions=(16,), resolution=RES)

FLAG_CONFIG_YAML = ddpm_config_yaml(RES, DDPM_KW, """\
# Flagship golden-tier config: the reference's "simple" (CelebA-HQ) family
# at its exact published architecture and resolution (114M params,
# configs/celeba_hq.yml), trained locally on the blob+natural mix
# (tools/train_flagship_golden.py).""")


def build_ddpm(device="cpu"):
    return mid.build_ddpm(device, DDPM_KW)


def train(steps: int, batch: int, lr: float, out: Path, device="cuda", log_every=500):
    """The flagship run: (model, run result), the export and flag256.yml
    under `out`."""
    out = Path(out)
    model, result = mid.train_eps_family(
        "ddpm", steps, batch, lr, res=RES, build=build_ddpm, export_name="flag_ddpm256",
        arch_kw=DDPM_KW, extra_meta={"tier": "flag256"}, out=out, device=device,
        log_every=log_every)
    (out / "flag256.yml").write_text(FLAG_CONFIG_YAML)
    return model, result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--out", default=str(mid.DEFAULT_OUT / "flag256"))
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    train(ns.steps, ns.batch, ns.lr, Path(ns.out), ns.device)
    print(f"wrote {Path(ns.out) / 'flag256.yml'}")


if __name__ == "__main__":
    main()
