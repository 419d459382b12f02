"""Train the mid-scale (64 px) golden tier on the port (the PyTorch
counterpart of tools/train_mid_golden.py), and the loop the bigger tiers
share (tools/train_big_golden_torch.py, train_big_adm_golden_torch.py,
train_flagship_golden_torch.py).

Families (--family, default all):
  ddpm       the 6.8M "simple" DDPM UNet, attention at 32 and 16 px
  adm        the 12.3M ADM UNet, learn_sigma, attention at ds 2 and 4
  classifier the EncoderUNet (attention pool) on the 4-class blob family

Data: a 50/50 mix of blobs and the natural family (`make_mix`); Adam over
optax.cosine_decay_schedule(lr, steps, alpha=0.1); a snapshot every 1000
steps keyed by a hash of the run's configuration (resumed by a rerun with
the same configuration, deleted once the export is written). Exports are
float16 state dicts under the reference checkpoints' keys, with their
metadata, written only under --out (default exp/train_torch/mid64/), with
mid64.yml for the DDPM; data/checkpoints.load_checkpoint reads them back.

  python tools/train_mid_golden_torch.py [--family ddpm|adm|classifier|all]
      [--steps 12000] [--clf_steps 4000] [--batch 128] [--lr 2e-4]
      [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import torch  # noqa: E402

from ddnm_tpu_torch import schedules, training  # noqa: E402
from ddnm_tpu_torch.data.synthetic import make_class_blobs, make_mix  # noqa: E402,F401
from ddnm_tpu_torch.models import ADMClassifier, ADMUNet, DDPMUNet, init_like_flax  # noqa: E402
from train_toy_golden_torch import ddpm_config_yaml  # noqa: E402

RES = 64
T = 1000
N_CLASSES = 4

DDPM_KW = dict(ch=64, ch_mult=(1, 2, 2), num_res_blocks=2,
               attn_resolutions=(16, 32), resolution=RES)

ADM_KW = dict(
    image_size=RES, in_channels=3, model_channels=64, out_channels=6,
    num_res_blocks=2, attention_resolutions=(2, 4), channel_mult=(1, 2, 3),
    num_heads=4, num_head_channels=32, use_scale_shift_norm=True,
    resblock_updown=True,
)

CLF_KW = dict(
    image_size=RES, in_channels=3, model_channels=64, out_channels=N_CLASSES,
    num_res_blocks=1, attention_resolutions=(2, 4), channel_mult=(1, 2, 2),
    num_heads=4, num_head_channels=32, use_scale_shift_norm=True,
    resblock_updown=True, pool="attention",
)

MID_CONFIG_YAML = ddpm_config_yaml(RES, DDPM_KW, f"""\
# Mid-scale golden-tier config: the reference's "simple" (CelebA) family at
# {RES}px / 6.8M params with attention at two feature resolutions, trained
# locally on the blob+natural mix (tools/train_mid_golden.py). Used by the
# trained-weights fidelity suite's mid tier.""")

DEFAULT_OUT = REPO / "exp/train_torch"


def build_ddpm(device="cpu", kw=None):
    return init_like_flax(DDPMUNet(**(kw or DDPM_KW)).to(device), 0)


def build_adm(device="cpu", kw=None):
    return init_like_flax(ADMUNet(**(kw or ADM_KW)).to(device), 0)


def build_clf(device="cpu", kw=None):
    return init_like_flax(ADMClassifier(**(kw or CLF_KW)).to(device), 0)


def _abar(family: str):
    """The shared loop's table: float32 betas, float32 cumulative product
    (the DDPM's linear schedule, the ADM's and the classifier's named one;
    the classifier loop takes the product in float64, as its JAX loop)."""
    if family == "ddpm":
        betas = schedules.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                            num_diffusion_timesteps=T)
        return training.abar_table(betas, "float32")
    betas = schedules.named_beta_schedule("linear", T, use_scale=True)
    return training.abar_table(betas, "float64" if family == "classifier" else "float32")


def _export(model, out: Path, name: str, meta: dict) -> Path:
    path = training.export(model, out, name, meta, dtype=torch.float16)
    print(f"saved {path} ({path.stat().st_size / 1e6:.1f} MB)")
    return path


def _device(device):
    return torch.device(device or "cuda")


def train_eps_family(family: str, steps: int, batch: int, lr: float, *, res: int | None = None,
                     build=None, export_name: str | None = None, arch_kw=None,
                     extra_meta=None, out: Path | None = None, device=None, log_every=500):
    """The epsilon-MSE loop for "ddpm" (3 output channels) or "adm"
    (learn_sigma: the first three trained): a fresh model from `build`
    (default this tier's), 50/50 mix at `res`, cosine-decayed
    Adam, snapshot and resume, then the fp16 export under `out` /
    <tier dir>. Returns (model, run result)."""
    res = RES if res is None else res
    dev = _device(device)
    kw = arch_kw if arch_kw is not None else (DDPM_KW if family == "ddpm" else ADM_KW)
    model = (build or (build_ddpm if family == "ddpm" else build_adm))(dev)
    n_par = training.param_count(model)
    print(f"# {family}: {n_par / 1e6:.2f}M params")
    spec = training.TrainSpec(kind="eps", res=res, batch=batch, lr=lr, steps=steps,
                              data=make_mix, abar=_abar(family), cosine=True)
    name = export_name or f"mid_{family}64"
    out = Path(out) if out is not None else DEFAULT_OUT / "mid64"
    result = training.train(model, spec, name=name, out=out, log_every=log_every)
    meta = {"res": res, "T": T, "params_m": round(n_par / 1e6, 2),
            "arch": training.arch_meta(kw), "train_steps": steps, "batch": batch, "lr": lr,
            "data": "50/50 blobs+naturals", "export_dtype": "float16",
            "loss_curve": result["tail"], "s_per_step": training.per_step_seconds(result),
            "device": training.device_name(dev), **(extra_meta or {})}
    _export(model, out, name, meta)
    if family == "ddpm" and export_name is None:
        (out / "mid64.yml").write_text(MID_CONFIG_YAML)
        print(f"wrote {out / 'mid64.yml'}")
    return model, result


def train_classifier(steps: int, batch: int, lr: float, *, res: int | None = None, build=None,
                     export_name: str | None = None, arch_kw=None, extra_meta=None,
                     out: Path | None = None, device=None):
    """The noisy-image classifier loop on the 4-class blob family, cosine-
    decayed Adam, snapshot and resume, fp16 export. Returns (model, run
    result)."""
    res = RES if res is None else res
    dev = _device(device)
    model = (build or build_clf)(dev)
    spec = training.TrainSpec(kind="classifier", res=res, batch=batch, lr=lr, steps=steps,
                              data=make_class_blobs, abar=_abar("classifier"), cosine=True)
    name = export_name or "mid_clf64"
    out = Path(out) if out is not None else DEFAULT_OUT / "mid64"
    result = training.train(model, spec, name=name, out=out)
    meta = {"res": res, "T": T, "n_classes": N_CLASSES,
            "arch": training.arch_meta(arch_kw if arch_kw is not None else CLF_KW),
            "train_steps": steps, "batch": batch, "lr": lr, "export_dtype": "float16",
            "curve": result["tail"], "s_per_step": training.per_step_seconds(result),
            "device": training.device_name(dev), **(extra_meta or {})}
    _export(model, out, name, meta)
    return model, result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="all", choices=["ddpm", "adm", "classifier", "all"])
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--clf_steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--out", default=str(DEFAULT_OUT / "mid64"))
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)

    common = dict(out=Path(ns.out), device=ns.device)
    if ns.family in ("ddpm", "all"):
        train_eps_family("ddpm", ns.steps, ns.batch, ns.lr, **common)
    if ns.family in ("adm", "all"):
        train_eps_family("adm", ns.steps, ns.batch, ns.lr, **common)
    if ns.family in ("classifier", "all"):
        train_classifier(ns.clf_steps, ns.batch, 3e-4, **common)


if __name__ == "__main__":
    main()
