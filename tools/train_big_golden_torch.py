"""Train the big (128 px, 71.4M) golden-tier DDPM on the port (the
PyTorch counterpart of tools/train_big_golden.py).

The flagship "simple" family (ch 128, attention at 16 px, where its
AttnBlocks are single-head over C = 256, and C = 512 in the middle block)
with the 256 px stage dropped, trained by tools/train_mid_golden_torch.py's
loop (epsilon MSE, cosine-decayed Adam, 50/50 blob + natural mix at
128 px, snapshot and resume). Writes only under --out (default
exp/train_torch/big128/): big_ddpm128.pt (fp16), its metadata and
big128.yml.

  python tools/train_big_golden_torch.py [--steps 9000] [--batch 32]
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

RES = 128
DDPM_KW = dict(ch=128, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
               attn_resolutions=(16,), resolution=RES)

BIG_CONFIG_YAML = ddpm_config_yaml(RES, DDPM_KW, f"""\
# Big golden-tier config: the reference's "simple" (CelebA-HQ) family at
# {RES}px with the full channel ladder minus the last stage (71.4M params),
# trained locally on the blob+natural mix (tools/train_big_golden.py).""")


def build_ddpm(device="cpu"):
    return mid.build_ddpm(device, DDPM_KW)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=9000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--out", default=str(mid.DEFAULT_OUT / "big128"))
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    out = Path(ns.out)
    mid.train_eps_family("ddpm", ns.steps, ns.batch, ns.lr, res=RES, build=build_ddpm,
                         export_name="big_ddpm128", arch_kw=DDPM_KW,
                         extra_meta={"tier": "big128"}, out=out, device=ns.device)
    (out / "big128.yml").write_text(BIG_CONFIG_YAML)
    print(f"wrote {out / 'big128.yml'}")


if __name__ == "__main__":
    main()
