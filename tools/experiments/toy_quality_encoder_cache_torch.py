"""The encoder-cache approximation on a trained toy model, on the port
(the PyTorch counterpart of tools/experiments/toy_quality_encoder_cache.py).

Trains a small DDPM UNet (ch 64, mult (1, 2), one res block, attention at
16 px, 32 px) on the soft-blob family (`make_blobs`, data/synthetic.py)
with Adam 2e-4 through the port's training path (training.py: the
GroupNorm and attention backward kernels on a card), keys from
PRNGKey(1), then restores 4x average-pool SR of held-out blobs
(PRNGKey(99)) with the exact sampler and with the encoder cache at
intervals 2, 3 and 5 (sampling/accel.py `ddpm_split_fns`,
`sample_simplified_encoder_prop`), x_T = normal(PRNGKey(7)) and the
samplers' noise from PRNGKey(3) (JAX's keys), and prints one JSON line per
variant: PSNR against ground truth, and each cached run's PSNR against
the exact one; the training's seconds a step and final loss too.

  python tools/experiments/toy_quality_encoder_cache_torch.py
      [--steps 3000] [--res 32] [--eval 32] [--batch 128] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from ddnm_tpu_torch import schedules, training  # noqa: E402
from ddnm_tpu_torch.data.metrics import psnr  # noqa: E402
from ddnm_tpu_torch.data.synthetic import make_blobs  # noqa: E402,F401  (re-exported)
from ddnm_tpu_torch.models import DDPMUNet, init_like_flax  # noqa: E402
from ddnm_tpu_torch.operators import build_functional_operator  # noqa: E402
from ddnm_tpu_torch.sampling import build_schedule, sample_simplified  # noqa: E402
from ddnm_tpu_torch.sampling.accel import (  # noqa: E402
    ddpm_split_fns,
    sample_simplified_encoder_prop,
)
from ddnm_tpu_torch.sampling.threefry import KeyNoise, normal, prng_key  # noqa: E402

T = 1000


def toy_betas() -> np.ndarray:
    """Linear betas cast to float32 (the experiment's schedule)."""
    return schedules.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                       num_diffusion_timesteps=T).astype("float32")


def build_model(res: int, device="cpu") -> DDPMUNet:
    model = DDPMUNet(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                     resolution=res)
    return init_like_flax(model.to(device), 0)


def train_model(model, steps: int, batch: int, res: int, out: Path, log_every=500):
    spec = training.TrainSpec(kind="eps", res=res, batch=batch, lr=2e-4, steps=steps,
                              data=make_blobs, abar=training.abar_table(toy_betas(), "float32"))
    return training.train(model, spec, name="toy_quality_encoder_cache", out=out,
                          log_every=log_every)


@torch.no_grad()
def evaluate(model, n_eval: int, res: int, intervals=(2, 3, 5), t_sampling: int = 100) -> dict:
    """PSNR of the exact sampler and of the encoder cache at `intervals`
    against ground truth (images mapped to [0, 1] and clipped), and of each
    cached run against the exact one."""
    dev = next(model.parameters()).device
    model.eval()
    gt = make_blobs(prng_key(99, dev), n_eval, res)
    op = build_functional_operator("sr_averagepooling", image_size=res, deg_scale=4,
                                   device=dev)
    y = op.A(gt)
    sched = build_schedule(betas=toy_betas(), t_sampling=t_sampling)
    x_init = normal(prng_key(7, dev), gt.shape)
    to01 = lambda a: torch.clamp((a + 1) / 2, 0, 1)  # noqa: E731
    exact, _ = sample_simplified(lambda x, t: model(x, t), x_init, y, op, sched,
                                 KeyNoise(prng_key(3, dev)))
    results = {"exact": float(psnr(to01(exact), to01(gt)).mean())}
    enc_fn, dec_fn = ddpm_split_fns(model)
    for interval in intervals:
        x_acc, _ = sample_simplified_encoder_prop(enc_fn, dec_fn, x_init, y, op, sched,
                                                  KeyNoise(prng_key(3, dev)), interval=interval)
        results[f"encoder_cache_{interval}"] = float(psnr(to01(x_acc), to01(gt)).mean())
        results[f"drift_vs_exact_{interval}"] = float(psnr(to01(x_acc), to01(exact)).mean())
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--eval", type=int, default=32, help="eval images")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", default=str(REPO / "exp/train_torch/toy_quality_encoder_cache"))
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    dev = torch.device(ns.device)
    model = build_model(ns.res, dev)
    run = train_model(model, ns.steps, ns.batch, ns.res, Path(ns.out))
    device = training.device_name(dev)
    print(f"# trained {ns.steps} steps in {run['seconds']:.1f}s "
          f"({training.per_step_seconds(run):.4f} s a step on {device}), "
          f"final loss {run['tail'][-1]['loss']:.4f}", flush=True)
    results = evaluate(model, ns.eval, ns.res)
    print(json.dumps({"metric": "s_per_step", "value": training.per_step_seconds(run),
                      "unit": "s", "device": device}))
    print(json.dumps({"metric": "final_loss", "value": run["tail"][-1]["loss"], "unit": "mse"}))
    for k, v in results.items():
        print(json.dumps({"metric": k, "value": round(v, 3), "unit": "dB", "device": device}))
    return results


if __name__ == "__main__":
    main()
