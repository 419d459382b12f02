"""Train the toy golden-suite DDPM on the port (the PyTorch counterpart of
tools/train_toy_golden.py).

The "simple" DDPM UNet at toy scale (ch 32, mult (1, 2), one res block,
attention at 16 px, 32 px) trained on the soft-blob family
(data/synthetic.py `make_blobs`) with the epsilon MSE and Adam at a
constant learning rate, keys, batches, timesteps and noise drawn from
PRNGKey(1) as the JAX trainer draws them, weights initialised from seed 0
as flax initialises them (by distribution, not bits).

Writes only under --out (default exp/train_torch/toy32/): toy_ddpm32.pt
(the fp32 state dict under the reference checkpoint's keys), its JSON
metadata (loss curve tail, seconds a step, device) and toy32.yml (the
config the JAX trainer writes to configs/toy32.yml). The committed
fixtures are the JAX trainer's and are never written here.

  python tools/train_toy_golden_torch.py [--steps 6000] [--batch 256]
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
from ddnm_tpu_torch.models import DDPMUNet, init_like_flax  # noqa: E402

RES = 32
T = 1000
CH = 32
CH_MULT = (1, 2)
NUM_RES_BLOCKS = 1
ATTN = (16,)
DDPM_KW = dict(ch=CH, ch_mult=CH_MULT, num_res_blocks=NUM_RES_BLOCKS, attn_resolutions=ATTN,
               resolution=RES)


def ddpm_config_yaml(res: int, kw: dict, header: str) -> str:
    """The "simple" family's config text (the JAX trainers' *_CONFIG_YAML)."""
    return f"""\
{header}
data:
    dataset: "CelebA_HQ"
    image_size: {res}
    channels: 3
    logit_transform: false
    uniform_dequantization: false
    gaussian_dequantization: false
    random_flip: false
    rescaled: true
    num_workers: 0
    out_of_dist: false

model:
    type: "simple"
    in_channels: 3
    out_ch: 3
    ch: {kw["ch"]}
    ch_mult: [{", ".join(str(m) for m in kw["ch_mult"])}]
    num_res_blocks: {kw["num_res_blocks"]}
    attn_resolutions: [{", ".join(str(a) for a in kw["attn_resolutions"])}]
    dropout: 0.0
    var_type: fixedsmall
    ema_rate: 0.999
    ema: True
    resamp_with_conv: True

diffusion:
    beta_schedule: linear
    beta_start: 0.0001
    beta_end: 0.02
    num_diffusion_timesteps: {T}

sampling:
    batch_size: 1

time_travel:
    T_sampling: 100
    travel_length: 1
    travel_repeat: 1
"""


TOY_CONFIG_YAML = ddpm_config_yaml(RES, DDPM_KW, """\
# Toy golden-suite config: the reference's "simple" (CelebA) family at
# 32px / 0.7M params, trained locally on synthetic blobs
# (tools/train_toy_golden.py). Used by the trained-weights fidelity suite.""")


def ddpm_abar():
    """The DDPM trainers' table: linear betas cast to float32, float32
    cumulative product."""
    betas = schedules.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                        num_diffusion_timesteps=T)
    return training.abar_table(betas, "float32")


def build_model(device="cpu", seed: int = 0) -> DDPMUNet:
    return init_like_flax(DDPMUNet(**DDPM_KW).to(device), seed)


def make_spec(steps: int, batch: int, lr: float) -> training.TrainSpec:
    return training.TrainSpec(kind="eps", res=RES, batch=batch, lr=lr, steps=steps,
                              data=make_blobs, abar=ddpm_abar())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--out", default=str(REPO / "exp/train_torch/toy32"))
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    dev = torch.device(ns.device)
    model = build_model(dev)
    res = training.train(model, make_spec(ns.steps, ns.batch, ns.lr), name="toy_ddpm32",
                         out=Path(ns.out))
    out = Path(ns.out)
    training.export(model, out, "toy_ddpm32", {
        "res": RES, "ch": CH, "ch_mult": list(CH_MULT), "T": T, "train_steps": ns.steps,
        "batch": ns.batch, "lr": ns.lr, "loss_curve": res["tail"],
        "s_per_step": training.per_step_seconds(res), "device": training.device_name(dev)},
        dtype=torch.float32)
    (out / "toy32.yml").write_text(TOY_CONFIG_YAML)
    print(f"saved {out / 'toy_ddpm32.pt'} and {out / 'toy32.yml'}")
    return res


if __name__ == "__main__":
    main()
