"""Train the big ADM golden tier on the port (the PyTorch counterpart of
tools/train_big_adm_golden.py): a 128 px ADM UNet attending at three
downsample rates (4, 8, 16: the flagship ADM's 32 / 16 / 8 token grids,
32 head channels) and a 128 px EncoderUNet classifier (64 head channels),
both through tools/train_mid_golden_torch.py's loops. Writes only under
--out (default exp/train_torch/big128/): big_adm128.pt, big_clf128.pt
(fp16) and their metadata.

  python tools/train_big_adm_golden_torch.py [--steps 7000]
      [--clf_steps 3000] [--batch 32] [--lr 2e-4]
      [--family adm|classifier|all] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import train_mid_golden_torch as mid  # noqa: E402

RES = 128
N_CLASSES = 4

ADM_KW = dict(
    image_size=RES, in_channels=3, model_channels=96, out_channels=6,
    num_res_blocks=2, attention_resolutions=(4, 8, 16),
    channel_mult=(1, 1, 2, 3, 4), num_heads=4, num_head_channels=32,
    use_scale_shift_norm=True, resblock_updown=True,
)

CLF_KW = dict(
    image_size=RES, in_channels=3, model_channels=64, out_channels=N_CLASSES,
    num_res_blocks=2, attention_resolutions=(4, 8, 16),
    channel_mult=(1, 1, 2, 3), num_heads=4, num_head_channels=64,
    use_scale_shift_norm=True, resblock_updown=True, pool="attention",
)


def build_adm(device="cpu"):
    return mid.build_adm(device, ADM_KW)


def build_clf(device="cpu"):
    return mid.build_clf(device, CLF_KW)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=7000)
    ap.add_argument("--clf_steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--family", default="all", choices=["adm", "classifier", "all"])
    ap.add_argument("--out", default=str(mid.DEFAULT_OUT / "big128"))
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    common = dict(res=RES, extra_meta={"tier": "big128"}, out=Path(ns.out), device=ns.device)
    if ns.family in ("adm", "all"):
        mid.train_eps_family("adm", ns.steps, ns.batch, ns.lr, build=build_adm,
                             export_name="big_adm128", arch_kw=ADM_KW, **common)
    if ns.family in ("classifier", "all"):
        mid.train_classifier(ns.clf_steps, ns.batch, 3e-4, build=build_clf,
                             export_name="big_clf128", arch_kw=CLF_KW, **common)


if __name__ == "__main__":
    main()
