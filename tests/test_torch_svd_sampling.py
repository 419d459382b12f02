"""Port parity of SVD mode as a whole: `sample_svd` against the JAX package's
on the trained toy32 fixture over the 8 golden tasks (zero noise, shared
x_T, 25 steps, the golden's perm and mask), one noisy step with a guidance
function against JAX's step body, and main_torch end to end in SVD mode on
the CPU.

Gates: trajectories max |x_ours - x_jax| <= 1e-3 and batch PSNR within
0.01 dB of JAX's (as tests/test_torch_sampling.py); PSNR within 0.1 dB of
the committed JAX golden (tests/fixtures/toy_golden_psnr.json, the bound of
tests/test_golden_trained.py); one step within 1e-5 relative to max |JAX|
(fp32 in another summation order)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.operators import build_svd_operator as j_build_op
from ddnm_tpu.sampling import build_schedule as j_build_schedule
from ddnm_tpu.sampling import sample_svd as j_sample_svd
from ddnm_tpu.sampling.ddnm import _svd_body as j_svd_body
from ddnm_tpu_torch.operators import build_svd_operator
from ddnm_tpu_torch.sampling import build_schedule, sample_svd
from ddnm_tpu_torch.sampling.ddnm import _svd_update
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators
from tests._golden import GOLDEN_N_IMAGES, TASKS, load_eval_images, psnr01, toy_mask, toy_perm
from tests._torch_port import TIERS, jax_model, port_model, x_T, zero_noise_torch
from tests.test_torch_sampling import BETAS

REPO = Path(__file__).resolve().parents[1]
TOY = TIERS["toy32"]


def _op_kwargs(deg, deg_scale, res):
    return dict(channels=3, image_size=res, deg_scale=deg_scale,
                mask=toy_mask(res) if deg == "inpainting" else None,
                perm=toy_perm(res) if deg == "cs_walshhadamard" else None)


@pytest.fixture(scope="module")
def toy_models():
    return jax_model(TOY), port_model(TOY)


@pytest.mark.parametrize("name,deg,deg_scale,sigma_y", TASKS, ids=[t[0] for t in TASKS])
def test_sample_svd_matches_jax_toy32(toy_models, name, deg, deg_scale, sigma_y):
    (fn, params), model = toy_models
    n, res = GOLDEN_N_IMAGES["toy32"], TOY.res
    gt = load_eval_images(n, TOY)  # NCHW [-1, 1]
    xt = x_T(n, res)
    jop = j_build_op(deg, **_op_kwargs(deg, deg_scale, res))
    y = np.array(jop.A(jnp.asarray(gt.reshape(n, -1))), np.float32)

    ref, _ = j_sample_svd(fn, jnp.asarray(xt), jnp.asarray(y), jop,
                          j_build_schedule(betas=BETAS, t_sampling=25),
                          jax.random.PRNGKey(0), eta=0.85, sigma_y=sigma_y,
                          noise_fn=lambda k, s: jnp.zeros(s), params=params, loop="host")
    ref = np.asarray(ref)

    op = build_svd_operator(deg, **_op_kwargs(deg, deg_scale, res))
    ours, _ = sample_svd(model, torch.from_numpy(xt), torch.from_numpy(y), op,
                         build_schedule(betas=BETAS, t_sampling=25),
                         image_generators(0, range(n), STREAM_SAMPLE, "cpu"),
                         eta=0.85, sigma_y=sigma_y, noise_fn=zero_noise_torch)
    ours = ours.numpy()
    assert float(np.abs(ours - ref).max()) <= 1e-3
    to01 = lambda a: np.clip((a + 1) / 2, 0, 1)
    gt01 = to01(np.transpose(gt, (0, 2, 3, 1)))
    ours_psnr = psnr01(to01(ours), gt01)
    assert abs(ours_psnr - psnr01(to01(ref), gt01)) <= 0.01
    if name != "deblur_gauss":  # its golden used the torch oracle's sort permutation
        golden = json.loads(TOY.golden_json.read_text())[name]["ours_psnr"]
        assert abs(ours_psnr - golden) <= 0.1


@pytest.mark.parametrize("deg,deg_scale", [
    ("cs_walshhadamard", 0.25), ("cs_blockbased", 0.25), ("inpainting", 4.0),
    ("denoising", 4.0), ("colorization", 4.0), ("sr_averagepooling", 4.0),
    ("sr_bicubic", 4.0), ("deblur_uni", 4.0), ("deblur_aniso", 4.0),
])
def test_svd_step_with_noise_and_guidance_matches_jax(deg, deg_scale):
    """One SVD step body with non-zero sampler noise, both sigma_y branches,
    and a linear guidance function; a toy linear eps stands in for the
    model, so the update arithmetic alone is compared."""
    res = 32
    rng = np.random.default_rng(4)
    x, x_gt, noise = (rng.standard_normal((2, res, res, 3)).astype(np.float32)
                      for _ in range(3))
    jop = j_build_op(deg, **_op_kwargs(deg, deg_scale, res))
    op = build_svd_operator(deg, **_op_kwargs(deg, deg_scale, res))
    y = np.array(jop.A(jnp.asarray(np.transpose(x_gt, (0, 3, 1, 2)).reshape(2, -1))))
    j_spec = jop.prepare_measurement(jnp.asarray(y))
    t_spec = op.prepare_measurement(torch.from_numpy(y))
    t_f = np.full((2,), 400.0, np.float32)

    def eps(x, t):
        return 0.3 * x + 0.1

    def guide(x, t, at):
        return 0.05 * x - 1e-4 * t[:, None, None, None]

    for sigma_y, at, at_next in ((0.0, 0.3, 0.5), (0.2, 0.3, 0.5), (0.05, 0.9, 0.95)):
        j_next, j_x0 = j_svd_body(eps, jop, 0.85, sigma_y, guide, None, jnp.asarray(x),
                                  j_spec, jnp.asarray(t_f), jnp.float32(at),
                                  jnp.float32(at_next), jnp.asarray(noise))
        tx = torch.from_numpy(x)
        t_next, t_x0 = _svd_update(op, 0.85, sigma_y, guide, tx, t_spec,
                                   eps(tx, torch.from_numpy(t_f)), torch.from_numpy(t_f),
                                   torch.tensor(at), torch.tensor(at_next),
                                   torch.from_numpy(noise))
        for ours, ref in ((t_next, j_next), (t_x0, j_x0)):
            ref = np.asarray(ref)
            err = float(np.abs(ours.numpy() - ref).max())
            assert err <= 1e-5 * float(np.abs(ref).max()), (sigma_y, err)


def test_sample_svd_multistep_not_ported():
    """SVD-mode multistep is ported (tests/test_torch_solvers.py): on the
    analytic Gaussian flow through the 2x average-pooling SVD operator it
    agrees with the JAX solver within 1e-5."""
    from tests._torch_port import linear_gaussian

    betas, j_model, t_model, _, _, x_init = linear_gaussian()
    op = build_svd_operator("sr_averagepooling", image_size=8, deg_scale=2.0)
    jop = j_build_op("sr_averagepooling", channels=3, image_size=8, deg_scale=2.0)
    vec = np.random.RandomState(1).uniform(-1, 1, (2, 192)).astype(np.float32)
    ours, _ = sample_svd(t_model, torch.from_numpy(x_init), op.A(torch.from_numpy(vec)), op,
                         build_schedule(betas=betas.astype(np.float32), t_sampling=12),
                         image_generators(0, [0, 1], 0, "cpu"), solver="multistep")
    ref, _ = j_sample_svd(j_model, jnp.asarray(x_init), jop.A(jnp.asarray(vec)), jop,
                          j_build_schedule(betas=betas, t_sampling=12), jax.random.PRNGKey(0),
                          loop="host", solver="multistep")
    assert float(np.abs(ours.numpy() - np.asarray(ref)).max()) <= 1e-5


def _run_main(out, *extra):
    cmd = [sys.executable, str(REPO / "main_torch.py"), "--config", "configs/toy32.yml",
           "--path_y", "toy32", "--deg", "cs_walshhadamard", "--deg_scale", "0.25",
           "--ckpt", "tests/fixtures/toy_ddpm32.pt", "--t_sampling", "10",
           "-i", str(out), "--ni", "--device", "cpu", *extra]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Total Average PSNR" in proc.stdout
    return [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]


def test_main_torch_svd_cpu_end_to_end(tmp_path):
    from ddnm_tpu_torch.data.io import decode_png

    rows = _run_main(tmp_path / "out", "--batch_size", "3", "--max_images", "5")
    for i in range(5):
        img = decode_png((tmp_path / "out" / f"{i}_0.png").read_bytes())
        assert img.shape == (32, 32, 3)
        assert (tmp_path / "out" / "Apy" / f"Apy_{i}.png").exists()
    # no PSNR floor: with sampler noise (eta 0.85) the toy model restores
    # little at 25% compressed sensing, in the JAX CLI as here (~5-8 dB)
    assert rows[-1]["images"] == 5 and np.isfinite(rows[-1]["psnr"])


def test_main_torch_svd_raises_without_a_card_unless_device_cpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(REPO / "main_torch.py"), "--config", "configs/toy32.yml",
         "--deg", "cs_walshhadamard", "--deg_scale", "0.25", "--random_init",
         "-i", str(tmp_path / "out"), "--ni"],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "out").exists()


def test_svd_runner_is_batch_size_invariant(tmp_path):
    """Per-image generators: an image restores the same whatever batch it
    runs in (<= 1 count of 8-bit quantisation, as the JAX CLI's test)."""
    import main_torch
    from ddnm_tpu_torch.data.io import decode_png

    for b in ("1", "3"):
        main_torch.main(["--config", "configs/toy32.yml", "--exp", str(REPO / "exp"),
                         "--path_y", "toy32", "--deg", "cs_walshhadamard",
                         "--deg_scale", "0.25", "--sigma_y", "0.05",
                         "--ckpt", str(TOY.fixture), "--t_sampling", "5",
                         "--max_images", "3", "--batch_size", b, "-i", str(tmp_path / b),
                         "--ni", "--device", "cpu", "--verbose", "warning"])
    for i in range(3):
        a = decode_png((tmp_path / "1" / f"{i}_0.png").read_bytes()).astype(int)
        b = decode_png((tmp_path / "3" / f"{i}_0.png").read_bytes()).astype(int)
        assert np.abs(a - b).max() <= 1, f"image {i} differs across batch size"


def test_chip_smoke_golden_perm_and_mask_are_the_golden_protocol():
    import chip_smoke

    for res in (32, 256):
        assert np.array_equal(chip_smoke.golden_perm(res), toy_perm(res))
        assert np.array_equal(chip_smoke.golden_mask(res), toy_mask(res))
