"""Port parity of the slice as a whole: sample_simplified against the JAX
package's on the trained toy32 and mid64 fixtures (zero noise, shared x_T,
25 steps, 4x average-pooling SR), and main_torch end to end on the CPU.

Gates: max |x_ours - x_jax| <= 1e-3 and PSNR within 0.01 dB."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu import schedules as jsch
from ddnm_tpu.operators import build_functional_operator as j_build_op
from ddnm_tpu.sampling import build_schedule as j_build_schedule
from ddnm_tpu.sampling import sample_simplified as j_sample
from ddnm_tpu_torch.operators import build_functional_operator
from ddnm_tpu_torch.sampling import build_schedule, sample_simplified
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, default_noise, image_generators
from tests._golden import load_eval_images, psnr01
from tests._torch_port import TIERS, jax_model, port_model, x_T, zero_noise_torch

REPO = Path(__file__).resolve().parents[1]
BETAS = jsch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                               num_diffusion_timesteps=1000).astype(np.float32)


@pytest.mark.parametrize("tier_name", ["toy32", "mid64"])
def test_sample_simplified_matches_jax(tier_name):
    tier = TIERS[tier_name]
    n, res = 2, tier.res
    gt = np.ascontiguousarray(np.transpose(load_eval_images(n, tier), (0, 2, 3, 1)))
    xt = x_T(n, res)

    fn, params = jax_model(tier)
    jop = j_build_op("sr_averagepooling", image_size=res, deg_scale=4.0)
    ref, _ = j_sample(fn, jnp.asarray(xt), jop.A(jnp.asarray(gt)), jop,
                      j_build_schedule(betas=BETAS, t_sampling=25),
                      jax.random.PRNGKey(0), noise_fn=lambda k, s: jnp.zeros(s),
                      params=params, loop="host")
    ref = np.asarray(ref)

    op = build_functional_operator("sr_averagepooling", image_size=res, deg_scale=4.0)
    gens = image_generators(0, range(n), STREAM_SAMPLE, "cpu")
    ours, _ = sample_simplified(port_model(tier), torch.from_numpy(xt),
                                op.A(torch.from_numpy(gt)), op,
                                build_schedule(betas=BETAS, t_sampling=25), gens,
                                noise_fn=zero_noise_torch)
    ours = ours.numpy()
    assert float(np.abs(ours - ref).max()) <= 1e-3
    to01 = lambda a: np.clip((a + 1) / 2, 0, 1)
    gt01 = to01(gt)
    assert abs(psnr01(to01(ours), gt01) - psnr01(to01(ref), gt01)) <= 0.01
    assert psnr01(to01(ours), gt01) > 14.0  # a trained model restores signal


@pytest.mark.parametrize("deg", ["sr_averagepooling", "inpainting", "colorization"])
def test_sampler_update_matches_jax_with_noise(deg):
    """One noisy DDNM+ step body (sigma_y > 0 branch included) on shared
    inputs, with an identity-free toy eps: the update arithmetic alone."""
    from ddnm_tpu.sampling.ddnm import _simplified_update as j_update
    from ddnm_tpu_torch.sampling.ddnm import _simplified_update as t_update

    rng = np.random.default_rng(5)
    x, y0, et, noise = (rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
                        for _ in range(4))
    mask = (rng.uniform(size=(16, 16)) > 0.3).astype(np.float32)
    jop = j_build_op(deg, image_size=16, deg_scale=4.0, mask=mask)
    op = build_functional_operator(deg, image_size=16, deg_scale=4.0, mask=mask)
    y = np.array(jop.A(jnp.asarray(y0)))
    for at, at_next, sigma_y in ((0.3, 0.5, 0.0), (0.3, 0.5, 0.8), (0.9, 1.0, 0.2)):
        a, a0 = j_update(jop, 0.85, sigma_y, jnp.asarray(x), jnp.asarray(y),
                         jnp.asarray(et), jnp.float32(at), jnp.float32(at_next),
                         jnp.asarray(noise))
        b, b0 = t_update(op, 0.85, sigma_y, torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(et), torch.tensor(at), torch.tensor(at_next),
                         torch.from_numpy(noise))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)
        np.testing.assert_allclose(b0.numpy(), np.asarray(a0), atol=1e-5, rtol=0)


def test_per_image_streams_do_not_depend_on_the_batch():
    gens = image_generators(7, [3, 4, 5], STREAM_SAMPLE, "cpu")
    batch = default_noise(gens, (3, 4, 4, 3))
    alone = default_noise(image_generators(7, [4], STREAM_SAMPLE, "cpu"), (1, 4, 4, 3))
    assert torch.equal(batch[1], alone[0])
    assert not torch.equal(batch[0], batch[1])


def test_multistep_solver_not_ported():
    """The multistep solver is ported (tests/test_torch_solvers.py): through
    sample_simplified it agrees with the JAX solver on the analytic
    Gaussian flow within 1e-5, at 12 steps."""
    from tests._torch_port import linear_gaussian

    betas, j_model, t_model, jop, op, x_init = linear_gaussian()
    ours, _ = sample_simplified(t_model, torch.from_numpy(x_init), torch.zeros(x_init.shape),
                                op, build_schedule(betas=betas.astype(np.float32),
                                                   t_sampling=12),
                                image_generators(0, [0, 1], 0, "cpu"), solver="multistep")
    ref, _ = j_sample(j_model, jnp.asarray(x_init), jnp.zeros(x_init.shape), jop,
                      j_build_schedule(betas=betas, t_sampling=12), jax.random.PRNGKey(0),
                      loop="host", solver="multistep")
    assert float(np.abs(ours.numpy() - np.asarray(ref)).max()) <= 1e-5


@pytest.mark.parametrize("kw,config,exc,match", [
    # ported: --solver multistep and --encoder_cache run, and main_torch
    # agrees with main.py within 0.01 dB (ids kept from when they raised)
    pytest.param(dict(solver="multistep"), "toy32.yml", None, "",
                 id="kw0-toy32.yml-NotImplementedError-not ported"),
    pytest.param(dict(encoder_cache=2), "toy32.yml", None, "",
                 id="kw1-toy32.yml-NotImplementedError-not ported"),
    # the JAX runner's refusal, ahead of the port's own
    (dict(solver="multistep", add_noise=True), "toy32.yml", ValueError, "noise-free"),
    # guidance (ported): without --random_init and without a classifier
    # checkpoint the guided config raises as the JAX runner does; with
    # --random_init it runs (tests/test_torch_runner_adm.py, on a cut of it)
    (dict(random_init=False), "imagenet_256_cc.yml", FileNotFoundError, "classifier"),
    (dict(random_init=False, classifier_ckpt="clf.pt"), "imagenet_256_cc.yml",
     FileNotFoundError, "classifier"),
])
def test_runner_raises_on_paths_not_ported(kw, config, exc, match, tmp_path, monkeypatch):
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.runner import RunArgs, Runner
    from tests._torch_port import main_pair

    if exc is None:
        flags = {"solver": ["--solver", "multistep", "--t_sampling", "8"],
                 "encoder_cache": ["--encoder_cache", "2", "--t_sampling", "10"]}[next(iter(kw))]
        ours, ref = main_pair(tmp_path, monkeypatch, flags)
        assert ours["num_samples"] == 2 and abs(ours["avg_psnr"] - ref["avg_psnr"]) <= 0.01
        return
    args = RunArgs(config=config, **{"random_init": True, "device": "cpu", **kw})
    with pytest.raises(exc, match=match):
        Runner(args, load_config(REPO / "configs" / config)).build_guidance()


def test_runner_ignores_classifier_ckpt_without_guidance(tmp_path):
    """As the JAX runner: a config without class-conditional guidance
    ignores --classifier_ckpt, so the outputs equal a run without it."""
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.runner import RunArgs, Runner

    outs = {}
    for name, kw in (("plain", {}), ("flag", dict(classifier_ckpt="clf.pt"))):
        cfg = load_config(REPO / "configs" / "toy32.yml")
        cfg.time_travel.T_sampling = 5
        args = RunArgs(config="toy32.yml", exp=str(REPO / "exp"), path_y="toy32",
                       ckpt=str(REPO / "tests" / "fixtures" / "toy_ddpm32.pt"),
                       simplified=True, max_images=2, batch_size=2, device="cpu",
                       image_folder=str(tmp_path / name), **kw)
        stats = Runner(args, cfg).run()
        outs[name] = (stats["avg_psnr"], stats["num_samples"],
                      [(tmp_path / name / f"{i}_0.png").read_bytes() for i in range(2)])
    assert outs["plain"][1] == 2
    assert outs["flag"] == outs["plain"]


def test_main_torch_cpu_end_to_end(tmp_path):
    out = tmp_path / "out"
    cmd = [sys.executable, str(REPO / "main_torch.py"), "--config", "configs/toy32.yml",
           "--path_y", "toy32", "--deg", "sr_averagepooling", "--simplified",
           "--ckpt", "tests/fixtures/toy_ddpm32.pt", "--t_sampling", "10",
           "--batch_size", "3", "--max_images", "5", "-i", str(out), "--ni",
           "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Total Average PSNR" in proc.stdout
    from ddnm_tpu_torch.data.io import decode_png

    for i in range(5):
        img = decode_png((out / f"{i}_0.png").read_bytes())
        assert img.shape == (32, 32, 3)
        assert (out / "Apy" / f"Apy_{i}.png").exists()
    rows = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    assert rows[-1]["images"] == 5 and rows[-1]["psnr"] > 14.0
