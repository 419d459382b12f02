"""The quality experiments' ports (tools/experiments/*_torch.py) against
the JAX experiments' own functions on the CPU, each at its smallest size
(one task, one solver, one budget, one image): the same weights, images,
keys and x_T on both sides.

  - solver_quality_torch: a simplified and an SVD task on toy_ddpm32.pt;
  - solver_posterior_quality_torch: one Mask-Shift canvas on toy_adm32.pt
    under the golden schedule (respacing 25, jumps 10 x 2), tile 32,
    stride 16, a shared first-tile init;
  - encoder_cache_policies_torch: the exact and the interval-3 rows of the
    simplified and the posterior pipelines on one eval image;
  - toy_quality_encoder_cache_torch: the evaluation (exact and interval 2)
    of a model with JAX's initial weights;
  - natural_family_torch: the old-photo inputs.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddnm_tpu.tiling as jt
from ddnm_tpu import schedules as jsch
from ddnm_tpu.data.metrics import psnr as j_psnr
from ddnm_tpu.operators import build_functional_operator as j_build_op
from ddnm_tpu.sampling import build_posterior_tables as j_tables
from ddnm_tpu.sampling import build_schedule as j_build_schedule
from ddnm_tpu.sampling import sample_posterior as j_sample_posterior
from ddnm_tpu.sampling import sample_simplified as j_sample_simplified
from ddnm_tpu.sampling import sample_svd as j_sample_svd
from ddnm_tpu.sampling import accel as j_accel
from ddnm_tpu_torch.models import params_from_flax
from ddnm_tpu_torch.sampling.threefry import prng_key
from tests._golden import TOY32, build_our_operator, load_eval_images, load_our_model
from tests._golden_adm import ADM_TOY32
from tests._golden_adm import load_our_model as load_our_adm
from tests._torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
for sub in ("tools", "tools/experiments"):
    if str(REPO / sub) not in sys.path:
        sys.path.insert(0, str(REPO / sub))

import encoder_cache_policies_torch as t_policies  # noqa: E402
import natural_family as j_natural  # noqa: E402
import natural_family_torch as t_natural  # noqa: E402
import solver_posterior_quality_torch as t_posterior  # noqa: E402
import solver_quality_torch as t_solver  # noqa: E402
import toy_quality_encoder_cache as j_toy_quality  # noqa: E402
import toy_quality_encoder_cache_torch as t_toy_quality  # noqa: E402
import train_toy_adm_golden as j_toy_adm  # noqa: E402
import train_toy_golden as j_toy  # noqa: E402

ZERO = lambda key, shape: jnp.zeros(shape, jnp.float32)  # noqa: E731


@pytest.mark.parametrize("mode,deg,scale,solver", [
    ("simplified", "sr_averagepooling", 4, "multistep"), ("svd", "sr_bicubic", 4.0, "ddim")])
def test_solver_quality_row_matches_jax(mode, deg, scale, solver):
    """One image, 6 steps: the port's restoration within 1e-4 of the JAX
    experiment's sampler call and its PSNR within 0.01 dB."""
    model = t_solver.load_ddpm("toy32", "cpu")
    gt = t_solver.load_eval_images("exp/datasets/toy32", 1)
    got = t_solver.run(model, gt, mode, deg, scale, solver, 6)
    model_fn, params = load_our_model(TOY32)
    x_orig = jnp.asarray(load_eval_images(1, TOY32).transpose(0, 2, 3, 1))
    assert np.abs(np.asarray(x_orig) - gt).max() <= 1e-6  # the same images
    x_init = jax.random.normal(jax.random.PRNGKey(5), x_orig.shape)
    sched = j_build_schedule(betas=jsch.get_beta_schedule(
        "linear", beta_start=1e-4, beta_end=2e-2, num_diffusion_timesteps=1000), t_sampling=6)
    kw = dict(eta=0.85, sigma_y=0.0, noise_fn=ZERO, loop="scan", params=params, solver=solver)
    if mode == "simplified":
        op = j_build_op(deg, image_size=32, deg_scale=scale)
        out, _ = j_sample_simplified(model_fn, x_init, op.A(x_orig), op, sched,
                                     jax.random.PRNGKey(1), **kw)
    else:
        op = build_our_operator(deg, scale, res=32)
        y = op.A(jnp.transpose(x_orig, (0, 3, 1, 2)).reshape(1, -1))
        out, _ = j_sample_svd(model_fn, x_init, y, op, sched, jax.random.PRNGKey(1), **kw)
    want = np.clip((np.asarray(out) + 1.0) / 2.0, 0.0, 1.0)
    assert np.abs(got - want).max() <= 1e-4
    gt01 = (gt + 1.0) / 2.0
    assert abs(t_solver.psnr01(got, gt01) - t_solver.psnr01(want, gt01)) <= 0.01


def test_solver_posterior_quality_canvas_matches_jax(monkeypatch):
    """One 48 x 48 natural canvas (2 x 2 tiles of 32, stride 16), ddim,
    the reference protocol's schedule, zero noise, the first tile's init
    shared: the port's final within 1e-3 of jax tiling.mask_shift_sample's
    and its PSNR within 0.01 dB."""
    monkeypatch.setattr(jt, "TILE", 32)
    monkeypatch.setattr(jt, "STRIDE", 16)
    model = t_posterior.load_adm("toy32", "cpu")
    gt = t_posterior.make_naturals(prng_key(42), 1, 48).numpy()
    init = np.random.default_rng(3).standard_normal((1, 32, 32, 3)).astype(np.float32)
    got = t_posterior.restore(model, gt, t_posterior.jump_tables(), "ddim", 0, 32,
                              init_noise=init)
    model_fn, params = load_our_adm(ADM_TOY32)
    tables = j_tables(betas=jsch.named_beta_schedule("linear", 1000, use_scale=True),
                      timestep_respacing="25", schedule_jump_params=dict(
                          t_T=25, n_sample=1, jump_length=10, jump_n_sample=2))
    out = jt.mask_shift_sample(model_fn, gt, "sr_averagepooling", tables,
                               jax.random.fold_in(jax.random.PRNGKey(7), 0), scale=4,
                               params=params, noise_fn=ZERO, solver="ddim", init_noise=init)
    want = np.clip((out["final"][0] + 1.0) / 2.0, 0.0, 1.0)
    assert np.abs(got - want).max() <= 1e-3
    gt01 = (gt[0] + 1.0) / 2.0
    assert abs(t_solver.psnr01(got, gt01) - t_solver.psnr01(want, gt01)) <= 0.01


def _score(x, gt01, clip):
    a = (np.asarray(x) + 1) / 2
    if clip:
        a = np.clip(a, 0, 1)
    return round(float(np.mean([j_psnr(a[i], gt01[i]) for i in range(len(a))])), 2)


def test_encoder_cache_policy_rows_match_jax():
    """The simplified pipeline on one eval blob (30 steps, where the
    experiment takes 100): the exact and the uniform interval-3 rows of the
    port's experiment within 0.02 dB of the JAX experiment's calls on the
    same keys."""
    rows = {r["sampler"]: r for r in t_policies.simplified_rows("cpu", images=1,
                                                                 intervals=(3,),
                                                                 t_sampling=30)}
    assert {"exact", "cache_k3_uniform", "cache_k3_drift_calibrated",
            "cache_k3_end_dense"} == set(rows)
    model_fn, params = load_our_model(TOY32)
    enc_fn, dec_fn = j_accel.ddpm_split_fns(j_toy.build_model())
    sched = j_build_schedule(betas=jsch.get_beta_schedule(
        "linear", beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=1000), t_sampling=30)
    op = j_build_op("sr_averagepooling", image_size=32, deg_scale=4)
    gt = jnp.asarray(load_eval_images(1, TOY32).transpose(0, 2, 3, 1))
    x_init = jax.random.normal(jax.random.PRNGKey(12), gt.shape)
    key = jax.random.PRNGKey(11)
    gt01 = (np.asarray(gt) + 1) / 2
    exact, _ = j_sample_simplified(model_fn, x_init, op.A(gt), op, sched, key, params=params,
                                   loop="host")
    cached, _ = j_accel.sample_simplified_encoder_prop(enc_fn, dec_fn, x_init, op.A(gt), op,
                                                       sched, key, interval=3, params=params)
    assert abs(rows["exact"]["psnr"] - _score(exact, gt01, False)) <= 0.02
    assert abs(rows["cache_k3_uniform"]["psnr"] - _score(cached, gt01, False)) <= 0.02
    assert rows["cache_k3_uniform"]["full_fwds"] == 10 and rows["exact"]["full_fwds"] == 30


def test_encoder_cache_posterior_rows_match_jax():
    """The posterior pipeline (toy_adm32.pt, respacing 25 + jumps 10 x 2)
    on one eval blob: exact and uniform interval 3 within 0.02 dB of JAX."""
    rows = t_policies.posterior_rows("cpu", images=1, intervals=(3,))
    model_fn, params = load_our_adm(ADM_TOY32)
    enc_fn, dec_fn = j_accel.adm_split_fns(j_toy_adm.build_model())
    tables = j_tables(betas=jsch.named_beta_schedule("linear", 1000, use_scale=True),
                      timestep_respacing="25", sigma_y=0.0, schedule_jump_params=dict(
                          t_T=25, n_sample=1, jump_length=10, jump_n_sample=2))
    op = j_build_op("sr_averagepooling", image_size=32, deg_scale=4)
    gt = jnp.asarray(load_eval_images(1, TOY32).transpose(0, 2, 3, 1))
    apy = op.Ap(op.A(gt))
    x_init = jax.random.normal(jax.random.PRNGKey(12), gt.shape)
    key = jax.random.PRNGKey(11)
    gt01 = (np.asarray(gt) + 1) / 2
    _, x0 = j_sample_posterior(model_fn, x_init, apy, op, tables, key, params=params,
                               loop="host")
    _, xu = j_accel.sample_posterior_encoder_prop(enc_fn, dec_fn, x_init, apy, op, tables, key,
                                                  interval=3, params=params)
    assert abs(rows[0]["psnr"] - _score(x0, gt01, True)) <= 0.02
    assert rows[1]["k"] == 3 and abs(rows[1]["uniform"] - _score(xu, gt01, True)) <= 0.02


def test_toy_quality_evaluation_matches_jax():
    """The experiment's evaluation of a model with JAX's initial weights
    (ch 64, mult (1, 2)) on one held-out blob, 10 steps: exact and
    interval 2, and interval 2 against exact, within 0.01 dB of the JAX
    experiment's calls."""
    from ddnm_tpu.models.unet_ddpm import DDPMUNet as JDDPM

    jmodel = JDDPM(ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                   resolution=32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                  jnp.zeros((1,)))
    model = t_toy_quality.build_model(32)
    model.load_state_dict(params_from_flax(params), strict=True)
    got = t_toy_quality.evaluate(model, 1, 32, intervals=(2,), t_sampling=10)

    betas = t_toy_quality.toy_betas()
    gt = j_toy_quality.make_blobs(jax.random.PRNGKey(99), 1, 32)
    op = j_build_op("sr_averagepooling", image_size=32, deg_scale=4)
    sched = j_build_schedule(betas=betas, t_sampling=10)
    x_init = jax.random.normal(jax.random.PRNGKey(7), gt.shape)
    k = jax.random.PRNGKey(3)
    exact = j_sample_simplified(lambda p, x, t: jmodel.apply(p, x, t), x_init, op.A(gt), op,
                                sched, k, params=params, loop="host")[0]
    enc_fn, dec_fn = j_accel.ddpm_split_fns(jmodel)
    acc = j_accel.sample_simplified_encoder_prop(enc_fn, dec_fn, x_init, op.A(gt), op, sched,
                                                 k, interval=2, params=params)[0]
    to01 = lambda a: jnp.clip((a + 1) / 2, 0, 1)  # noqa: E731
    want = {"exact": float(jnp.mean(j_psnr(to01(exact), to01(gt)))),
            "encoder_cache_2": float(jnp.mean(j_psnr(to01(acc), to01(gt)))),
            "drift_vs_exact_2": float(jnp.mean(j_psnr(to01(acc), to01(exact))))}
    for key, value in want.items():
        assert abs(got[key] - value) <= 0.01, key


def test_oldphoto_inputs_match_jax():
    """natural_family_torch.make_oldphoto_inputs: the naturals within 1e-5
    and the scratch mask exactly (a threshold well away from the field's
    FFT rounding on this key)."""
    gt, keep = t_natural.make_oldphoto_inputs(prng_key(77), 2, 64)
    jgt, jkeep = jax.jit(j_natural.make_oldphoto_inputs, static_argnums=(1, 2))(
        jax.random.PRNGKey(77), 2, 64)
    assert np.abs(gt.numpy() - np.asarray(jgt)).max() <= 1e-5
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    assert torch.is_tensor(keep) and keep.dtype == torch.int64
