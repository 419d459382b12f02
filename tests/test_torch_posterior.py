"""Port parity: the hq pipeline's schedules and posterior sampler
(ddnm_tpu_torch/schedules.py, sampling/posterior.py) against ddnm_tpu's.

Tolerances: schedules, respacing subsets and jump pairs exactly equal;
respaced betas and every posterior table within 1e-6 (float64 host math
rounded to float32 on both sides); sample_posterior on the toy32 ADM with
zero noise within 1e-3 after a 19-call trajectory (fp32 convolutions sum
in other orders in the two frameworks, and the trajectory carries that);
the six unguided toy32 hq goldens within 0.01 dB of the JAX package's
PSNR (tests/fixtures/toy_adm32_psnr.json), as chip_smoke.py phase 9 holds
the card to them."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ddnm_tpu import schedules as jsch
from ddnm_tpu.operators import build_functional_operator as j_build_op
from ddnm_tpu.sampling import posterior as jpost
from ddnm_tpu.sampling.accel import n_model_calls as j_n_model_calls
from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.config import load_hq_config
from ddnm_tpu_torch.models import ADMUNet
from ddnm_tpu_torch.operators import build_functional_operator
from ddnm_tpu_torch.runner import load_checkpoint
from ddnm_tpu_torch.sampling import posterior as post
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators
from tests._golden_adm import ADM_TOY32, load_our_model
from tests._torch_port import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOY_KW = json.loads((REPO / "tests/fixtures/toy_adm32.json").read_text())["adm_kw"]
SHORT_JUMP = dict(t_T=10, n_sample=1, jump_length=3, jump_n_sample=2)


@pytest.mark.parametrize("name,n,use_scale", [("linear", 1000, True), ("linear", 100, True),
                                               ("linear", 250, False), ("cosine", 1000, True)])
def test_named_beta_schedule_matches_jax(name, n, use_scale):
    ours = sch.named_beta_schedule(name, n, use_scale=use_scale)
    assert ours.dtype == np.float64
    assert np.array_equal(ours, jsch.named_beta_schedule(name, n, use_scale=use_scale))


@pytest.mark.parametrize("params", [
    dict(t_T=100, n_sample=1, jump_length=10, jump_n_sample=3),
    dict(t_T=250, n_sample=1, jump_length=10, jump_n_sample=10),
    dict(t_T=25, n_sample=2, jump_length=5, jump_n_sample=2),
    dict(t_T=30, jump_length=6, jump_n_sample=2, jump2_length=2, jump2_n_sample=2,
         jump3_length=1, jump3_n_sample=2, start_resampling=20),
    dict(t_T=3, jump_length=1, jump_n_sample=1),
])
def test_schedule_jump_hq_matches_jax(params):
    assert sch.get_schedule_jump_hq(**params) == jsch.get_schedule_jump_hq(**params)


@pytest.mark.parametrize("spec", ["ddim25", "ddim100", "100", "250", "25", "10,20,5", [100],
                                  "2000"])
def test_space_timesteps_matches_jax(spec):
    assert sch.space_timesteps(1000, spec) == jsch.space_timesteps(1000, spec)


def test_space_timesteps_refusals_match_jax():
    for spec in ("ddim999", "600,600"):
        with pytest.raises(ValueError):
            jsch.space_timesteps(1000, spec)
        with pytest.raises(ValueError):
            sch.space_timesteps(1000, spec)


@pytest.mark.parametrize("respacing", ["ddim25", "100", "250"])
def test_respace_betas_matches_jax(respacing):
    betas = sch.named_beta_schedule("linear", 1000)
    use = sch.space_timesteps(1000, respacing)
    ours, tmap = post.respace_betas(betas, use)
    ref, ref_map = jpost.respace_betas(betas, use)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    assert np.array_equal(tmap, ref_map) and tmap.dtype == ref_map.dtype
    # the rebuilt betas give the original alpha_bar at the retained steps
    np.testing.assert_allclose(np.cumprod(1 - ours), np.cumprod(1 - betas)[sorted(use)],
                               rtol=1e-12)


@pytest.mark.parametrize("respacing,sigma_y,jump,shift", [
    ("100", 0.0, dict(t_T=100, n_sample=1, jump_length=10, jump_n_sample=3), 1),
    ("25", 0.25, dict(t_T=25, n_sample=1, jump_length=10, jump_n_sample=2), 1),
    ("ddim50", 0.1, None, 3),
    ("250", 0.05, dict(t_T=250, n_sample=1, jump_length=10, jump_n_sample=10), 2),
])
def test_posterior_tables_match_jax_field_by_field(respacing, sigma_y, jump, shift):
    betas = sch.named_beta_schedule("linear", 1000)
    kw = dict(betas=betas, timestep_respacing=respacing, sigma_y=sigma_y,
              schedule_jump_params=jump, time_shift=shift)
    ours, ref = post.build_posterior_tables(**kw), jpost.build_posterior_tables(**kw)
    for f in ("t_cur", "is_travel", "travel_shift"):
        assert np.array_equal(getattr(ours, f), getattr(ref, f)), f
        assert getattr(ours, f).dtype == getattr(ref, f).dtype, f
    for f in ("betas", "timestep_map", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1", "posterior_mean_coef2",
              "posterior_variance", "posterior_log_variance_clipped", "log_betas", "lambda_t",
              "gamma_t"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=f)
    assert post.n_model_calls(ours) == j_n_model_calls(ref.is_travel)


def test_inet256_schedule_makes_280_model_calls_per_tile():
    conf = load_hq_config(REPO / "configs/hq/inet256.yml")
    tables = post.build_posterior_tables(
        betas=sch.named_beta_schedule(conf.noise_schedule, conf.diffusion_steps),
        timestep_respacing=conf.timestep_respacing,
        schedule_jump_params=dict(conf.schedule_jump_params))
    assert post.n_model_calls(tables) == 280


@pytest.fixture(scope="module")
def toy():
    model = ADMUNet(**TOY_KW).eval()
    load_checkpoint(model, ADM_TOY32.fixture)
    return model


def _case(name, res=32, n=2):
    """(operator kwargs, sigma_y, time_shift, op_ctx, paste) of a sampler case."""
    rng = np.random.default_rng(3)
    masks = np.ones((n, res, res, 1), np.float32)
    masks[0, 8:20, 4:28] = 0.0
    masks[1, 14:30, 10:22] = 0.0
    paste = np.zeros((n, res, res, 1), np.float32)
    paste[:, :8] = 1.0
    paste[1, :, :12] = 1.0
    content = rng.uniform(-1, 1, (n, res, res, 3)).astype(np.float32)
    return {
        "sr": ("sr_averagepooling", dict(deg_scale=4.0), 0.0, 1, None, None),
        "inpainting_ctx_paste": ("inpainting", dict(mask=masks[0, ..., 0]), 0.1, 2, masks,
                                 (paste, content)),
        "colorization_noisy": ("colorization", {}, 0.25, 1, None, None),
    }[name]


@pytest.mark.parametrize("name", ["sr", "inpainting_ctx_paste", "colorization_noisy"])
def test_sample_posterior_matches_jax_at_toy32(toy, name):
    deg, op_kw, sigma_y, shift, ctx, paste = _case(name)
    rng = np.random.default_rng(0)
    gt = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    x_init = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    kw = dict(betas=sch.named_beta_schedule("linear", 1000), timestep_respacing="10",
              sigma_y=sigma_y, schedule_jump_params=SHORT_JUMP, time_shift=shift)
    tables, jtables = post.build_posterior_tables(**kw), jpost.build_posterior_tables(**kw)
    assert post.n_model_calls(tables) == 19 and tables.is_travel.any()

    op = build_functional_operator(deg, image_size=32, **op_kw)
    jop = j_build_op(deg, image_size=32, **op_kw)
    apy = op.Ap(op.A(torch.from_numpy(gt)))
    # a guidance hook on the clean case: mean += gamma * g(x, t)
    guide = name == "sr"
    t_ours, t_ref = torch.from_numpy, jnp.asarray
    pm = pc = None
    if paste is not None:
        pm, pc = paste
    ours, ours0 = post.sample_posterior(
        lambda x, t: toy(x, t), torch.from_numpy(x_init), apy, op, tables, [None, None],
        noise_fn=lambda g, s: torch.zeros(s),
        paste_mask=None if pm is None else t_ours(pm),
        paste_content=None if pc is None else t_ours(pc),
        op_ctx=None if ctx is None else t_ours(ctx),
        guidance_fn=(lambda x, t: -0.05 * x * (t[:, None, None, None] / 1000)) if guide else None)

    fn, params = load_our_model(ADM_TOY32)
    ref, ref0 = jpost.sample_posterior(
        fn, t_ref(x_init), t_ref(apy.numpy()), jop, jtables, jax.random.PRNGKey(0),
        noise_fn=lambda k, s: jnp.zeros(s, jnp.float32), params=params, loop="host",
        paste_mask=None if pm is None else t_ref(pm),
        paste_content=None if pc is None else t_ref(pc),
        op_ctx=None if ctx is None else t_ref(ctx),
        guidance_fn=(lambda p, x, t: -0.05 * x * (t[:, None, None, None] / 1000))
        if guide else None)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3, rtol=0)
    np.testing.assert_allclose(ours0.numpy(), np.asarray(ref0), atol=1e-3, rtol=0)


@pytest.mark.parametrize("task", chip_smoke.TASKS_HQ, ids=lambda t: t[0])
def test_toy32_hq_goldens_on_the_cpu(toy, task):
    """chip_smoke.py phase 9's protocol, run on the CPU through the plain
    versions: each unguided task within 0.01 dB of the JAX package."""
    golden = json.loads((REPO / "tests/fixtures/toy_adm32_psnr.json").read_text())
    psnr, x, _ = chip_smoke.hq_golden_run(toy, "cpu", task)
    assert x.shape == (2, 32, 32, 3) and torch.isfinite(x).all()
    assert abs(psnr - golden[task[0]]["ours_psnr"]) <= chip_smoke.HQ_PSNR_TOL


def test_stochastic_noise_is_batch_invariant(toy):
    """Each image draws from its own generator: image 1 sampled alone equals
    image 1 sampled beside image 0."""
    tables = post.build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000), timestep_respacing="5",
        schedule_jump_params=dict(t_T=5, jump_length=2, jump_n_sample=2))
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0)
    rng = np.random.default_rng(1)
    x_init = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    apy = op.Ap(op.A(torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))))
    both, _ = post.sample_posterior(lambda x, t: toy(x, t), x_init, apy, op, tables,
                                    image_generators(5, [0, 1], STREAM_SAMPLE, "cpu"))
    alone, _ = post.sample_posterior(lambda x, t: toy(x, t), x_init[1:], apy[1:], op, tables,
                                     image_generators(5, [1], STREAM_SAMPLE, "cpu"))
    np.testing.assert_allclose(alone[0].numpy(), both[1].numpy(), atol=1e-5)
    other, _ = post.sample_posterior(lambda x, t: toy(x, t), x_init[1:], apy[1:], op, tables,
                                     image_generators(6, [1], STREAM_SAMPLE, "cpu"))
    assert float((other - alone).abs().max()) > 1e-3  # the noise is live


def test_sample_posterior_refusals():
    tables = post.build_posterior_tables(betas=sch.named_beta_schedule("linear", 100),
                                         timestep_respacing="3",
                                         schedule_jump_params=dict(t_T=3, jump_length=1,
                                                                   jump_n_sample=1))
    op = build_functional_operator("colorization")
    x = torch.zeros(1, 8, 8, 3)
    model = lambda z, t: torch.zeros(z.shape[:-1] + (6,))
    # the multistep solver (ported) runs on these noise-free tables; noisy
    # ones and an unknown solver raise, as in the JAX package
    x_ms, x0_ms = post.sample_posterior(model, x, x, op, tables, [None], solver="multistep")
    assert torch.isfinite(x_ms).all() and x0_ms.shape == x.shape
    noisy = post.build_posterior_tables(betas=sch.named_beta_schedule("linear", 100),
                                        timestep_respacing="3", sigma_y=0.5,
                                        schedule_jump_params=dict(t_T=3, jump_length=1,
                                                                  jump_n_sample=1))
    with pytest.raises(ValueError, match="noise-free"):
        post.sample_posterior(model, x, x, op, noisy, [None], solver="multistep")
    with pytest.raises(ValueError, match="unknown solver"):
        post.sample_posterior(model, x, x, op, tables, [None], solver="rk4")
    with pytest.raises(ValueError, match="go together"):
        post.sample_posterior(model, x, x, op, tables, [None], paste_mask=x[..., :1])
    with pytest.raises(ValueError, match="context-parameterised"):
        post.sample_posterior(model, x, x, op, tables, [None], op_ctx=x[..., :1])
