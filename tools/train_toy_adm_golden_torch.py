"""Train the toy ADM UNet on the port (the PyTorch counterpart of
tools/train_toy_adm_golden.py).

A small ADM UNet with learn_sigma (6 output channels), scale-shift norm
(FiLM) and resblock up/down, 32 px, trained on the soft-blob family with
the epsilon MSE on its first three output channels (the variance head
keeps its zero-initialised output conv's share), Adam at a constant
learning rate, the ADM family's schedule (`named_beta_schedule("linear",
T, use_scale=True)`, cumulative product in float64), keys from PRNGKey(1).

Writes only under --out (default exp/train_torch/toy_adm32/): toy_adm32.pt
(fp32, under the reference UNetModel's keys) and toy_adm32.json.

  python tools/train_toy_adm_golden_torch.py [--steps 6000] [--batch 256]
      [--lr 2e-4] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from ddnm_tpu_torch import schedules, training  # noqa: E402
from ddnm_tpu_torch.data.synthetic import make_blobs  # noqa: E402
from ddnm_tpu_torch.models import ADMUNet, init_like_flax  # noqa: E402

RES = 32
T = 1000
# attention_resolutions holds downsample rates (the reference UNetModel's
# meaning): ds 2 is the 16 x 16 grid
ADM_KW = dict(
    image_size=RES, in_channels=3, model_channels=32, out_channels=6,
    num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
    num_heads=4, num_head_channels=32, use_scale_shift_norm=True,
    resblock_updown=True,
)


def adm_abar():
    """The toy ADM trainer's table: the named linear schedule, float64
    cumulative product, cast to float32."""
    return training.abar_table(schedules.named_beta_schedule("linear", T, use_scale=True),
                               "float64")


def build_model(device="cpu", seed: int = 0) -> ADMUNet:
    return init_like_flax(ADMUNet(**ADM_KW).to(device), seed)


def make_spec(steps: int, batch: int, lr: float) -> training.TrainSpec:
    return training.TrainSpec(kind="eps", res=RES, batch=batch, lr=lr, steps=steps,
                              data=make_blobs, abar=adm_abar())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--out", default=str(REPO / "exp/train_torch/toy_adm32"))
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    dev = torch.device(ns.device)
    model = build_model(dev)
    res = training.train(model, make_spec(ns.steps, ns.batch, ns.lr), name="toy_adm32",
                         out=Path(ns.out))
    path = training.export(model, Path(ns.out), "toy_adm32", {
        "res": RES, "T": T, "adm_kw": training.arch_meta(ADM_KW), "train_steps": ns.steps,
        "batch": ns.batch, "lr": ns.lr, "loss_curve": res["tail"],
        "s_per_step": training.per_step_seconds(res), "device": training.device_name(dev)},
        dtype=torch.float32)
    print(f"saved {path}")
    return res


if __name__ == "__main__":
    main()
