"""Train the toy noisy classifier on the port (the PyTorch counterpart of
tools/train_toy_classifier_golden.py).

An EncoderUNet half-UNet classifier (ADMClassifier, attention pool) at
32 px, trained on noised images of the 4-class blob family
(`make_class_blobs`: class = dominant colour channel 0 / 1 / 2, or 3 =
gray) with the mean softmax cross entropy (optax's
`softmax_cross_entropy_with_integer_labels(...).mean()`), Adam at a
constant learning rate, the ADM family's schedule (float64 cumulative
product), keys from PRNGKey(1). Prints the loss and the batch accuracy.

Writes only under --out (default exp/train_torch/toy_clf32/): toy_clf32.pt
(fp32, under the reference EncoderUNetModel's keys) and toy_clf32.json.

  python tools/train_toy_classifier_golden_torch.py [--steps 3000]
      [--batch 256] [--lr 3e-4] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import torch  # noqa: E402

from ddnm_tpu_torch import training  # noqa: E402
from ddnm_tpu_torch.data.synthetic import make_class_blobs  # noqa: E402,F401  (re-exported)
from ddnm_tpu_torch.models import ADMClassifier, init_like_flax  # noqa: E402
from train_toy_adm_golden_torch import adm_abar  # noqa: E402

RES = 32
T = 1000
N_CLASSES = 4

CLF_KW = dict(
    image_size=RES, in_channels=3, model_channels=32, out_channels=N_CLASSES,
    num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
    num_heads=4, num_head_channels=32, use_scale_shift_norm=True,
    resblock_updown=True, pool="attention",
)


def build_model(device="cpu", seed: int = 0) -> ADMClassifier:
    return init_like_flax(ADMClassifier(**CLF_KW).to(device), seed)


def make_spec(steps: int, batch: int, lr: float) -> training.TrainSpec:
    return training.TrainSpec(kind="classifier", res=RES, batch=batch, lr=lr, steps=steps,
                              data=make_class_blobs, abar=adm_abar())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default=str(REPO / "exp/train_torch/toy_clf32"))
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    dev = torch.device(ns.device)
    model = build_model(dev)
    res = training.train(model, make_spec(ns.steps, ns.batch, ns.lr), name="toy_clf32",
                         out=Path(ns.out))
    path = training.export(model, Path(ns.out), "toy_clf32", {
        "res": RES, "T": T, "n_classes": N_CLASSES, "clf_kw": training.arch_meta(CLF_KW),
        "train_steps": ns.steps, "batch": ns.batch, "lr": ns.lr, "curve": res["tail"],
        "s_per_step": training.per_step_seconds(res), "device": training.device_name(dev)},
        dtype=torch.float32)
    print(f"saved {path}")
    return res


if __name__ == "__main__":
    main()
