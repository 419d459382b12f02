"""The port's CPU plain path at full width against the JAX package's goldens
(tools/make_torch_port_golden.py): the 114M DDPM UNet with the trained
flagship weights, 2 images at 256 px, 25 steps, zero noise; the simplified
sampler on 4x average-pooling SR, and SVD mode on 25% Walsh-Hadamard
compressed sensing, noise-free and noisy (the batch PSNR against the golden,
which reproduces tests/fixtures/flag_golden_psnr.json).

Gates: per-image PSNR within 0.1 dB of the golden (the bound of
tests/test_golden_trained.py) and the 8x8-pooled output within 1e-2 of the
golden's (fp32 in two frameworks through 25 steps of a 114M UNet). Marked
slow: 25 forwards of the full model on the CPU."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.data.io import load_image
from ddnm_tpu_torch.models import DDPMUNet
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.runner import load_checkpoint
from ddnm_tpu_torch.sampling import build_schedule, sample_simplified, sample_svd
from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators
from tests._golden import toy_perm

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "fixtures" / "flag_simplified_golden.json"
POOL8 = REPO / "tests" / "fixtures" / "flag_simplified_pool8.npy"
SVD_GOLDEN = REPO / "tests" / "fixtures" / "flag_svd_golden.json"
SVD_POOL8 = REPO / "tests" / "fixtures" / "flag_svd_pool8.npy"
FLAG_PSNR = REPO / "tests" / "fixtures" / "flag_golden_psnr.json"


def test_golden_files_spell_out_the_protocol():
    golden = json.loads(GOLDEN.read_text())
    p = golden["protocol"]
    assert (p["n_images"], p["res"], p["t_sampling"], p["x_T_seed"]) == (2, 256, 25, 42)
    assert p["deg"] == "sr_averagepooling" and p["noise"] == "zero"
    assert len(golden["per_image_psnr"]) == 2
    assert min(golden["per_image_psnr"]) > 14.0  # a restoration, not noise
    pool = np.load(POOL8)
    assert pool.shape == (2, 32, 32, 3) and pool.dtype == np.float32


@pytest.mark.slow
def test_port_cpu_matches_jax_golden_at_full_width():
    golden = json.loads(GOLDEN.read_text())
    p = golden["protocol"]
    n, res = p["n_images"], p["res"]
    paths = sorted((REPO / p["eval_dir"]).glob("*.png"))[:n]
    gt = torch.from_numpy(np.stack([load_image(q) for q in paths]) * 2.0 - 1.0)
    xt = np.random.RandomState(p["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1)))
    model = DDPMUNet(resolution=res)
    load_checkpoint(model, REPO / p["fixture"])
    op = build_functional_operator(p["deg"], image_size=res, deg_scale=p["deg_scale"])
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    x, _ = sample_simplified(model.eval(), xt, op.A(gt), op,
                             build_schedule(betas=betas, t_sampling=p["t_sampling"]),
                             image_generators(0, range(n), STREAM_SAMPLE, "cpu"),
                             eta=p["eta"], sigma_y=p["sigma_y"],
                             noise_fn=lambda gens, shape: torch.zeros(shape))
    x = x.numpy()
    to01 = lambda a: np.clip((a + 1) / 2, 0, 1)
    for i, want in enumerate(golden["per_image_psnr"]):
        mse = float(np.mean((to01(x[i]) - to01(gt[i].numpy())) ** 2))
        assert abs(10 * np.log10(1 / mse) - want) <= 0.1, (i, want)
    pool = x.reshape(n, res // 8, 8, res // 8, 8, 3).mean(axis=(2, 4))
    assert float(np.abs(pool - np.load(POOL8)).max()) <= 1e-2


def test_svd_golden_files_spell_out_the_protocol():
    golden = json.loads(SVD_GOLDEN.read_text())
    p = golden["protocol"]
    assert (p["n_images"], p["res"], p["t_sampling"], p["x_T_seed"]) == (2, 256, 25, 42)
    assert p["noise"] == "zero" and list(golden["tasks"]) == ["cs_wh_025", "cs_wh_noisy"]
    flag = json.loads(FLAG_PSNR.read_text())
    for name, r in golden["tasks"].items():
        assert r["batch_psnr"] == flag[name]["ours_psnr"]
    pool = np.load(SVD_POOL8)
    assert pool.shape == (2, 2, 32, 32, 3) and pool.dtype == np.float32


@pytest.mark.slow
@pytest.mark.parametrize("index,name", [(0, "cs_wh_025"), (1, "cs_wh_noisy")])
def test_port_cpu_matches_jax_svd_golden_at_full_width(index, name):
    golden = json.loads(SVD_GOLDEN.read_text())
    p, task = golden["protocol"], golden["protocol"]["tasks"][name]
    n, res = p["n_images"], p["res"]
    paths = sorted((REPO / p["eval_dir"]).glob("*.png"))[:n]
    gt = torch.from_numpy(np.stack([load_image(q) for q in paths]) * 2.0 - 1.0)
    xt = np.random.RandomState(p["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1)))
    model = DDPMUNet(resolution=res)
    load_checkpoint(model, REPO / p["fixture"])
    op = build_svd_operator(task["deg"], image_size=res, deg_scale=task["deg_scale"],
                            perm=toy_perm(res))
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    x, _ = sample_svd(model.eval(), xt, op.A(_nhwc_to_vec(gt)), op,
                      build_schedule(betas=betas, t_sampling=p["t_sampling"]),
                      image_generators(0, range(n), STREAM_SAMPLE, "cpu"),
                      eta=p["eta"], sigma_y=task["sigma_y"],
                      noise_fn=lambda gens, shape: torch.zeros(shape))
    x = x.numpy()
    to01 = lambda a: np.clip((a + 1) / 2, 0, 1)
    mse = float(np.mean((to01(x) - to01(gt.numpy())) ** 2))
    assert abs(10 * np.log10(1 / mse) - golden["tasks"][name]["batch_psnr"]) <= 0.1
    pool = x.reshape(n, res // 8, 8, res // 8, 8, 3).mean(axis=(2, 4))
    assert float(np.abs(pool - np.load(SVD_POOL8)[index]).max()) <= 1e-2
