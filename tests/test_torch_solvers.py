"""Port parity: the second-order multistep solver
(ddnm_tpu_torch/sampling/solvers.py) against ddnm_tpu/sampling/solvers.py.

Three layers, as tests/test_solvers.py pins the JAX solver:

1. The analytic probability-flow ODE (Gaussian data, linear eps): the port
   converges at second order on the DDNM grid and on the respaced
   posterior grid (40 -> 80 -> 160 steps cut the error > 3x each; the JAX
   package measured 10 -> 20 as pre-asymptotic, 1.7x), and its endpoint is
   within 1e-5 of the JAX solver's on the same inputs.
2. The trained toy fixtures: simplified and SVD multistep on toy_ddpm32.pt,
   and the posterior form on toy_adm32.pt, within 1e-4 max abs and 0.01 dB
   of JAX (zero noise, a shared x_T); the regime split of the JAX tests
   repeated on the port alone.
3. Plumbing: time travel, op_ctx, the refusals, and main_torch against
   main.py (within 0.01 dB)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu import schedules as jsch
from ddnm_tpu.operators import build_functional_operator as j_build_op
from ddnm_tpu.sampling import build_posterior_tables as j_tables
from ddnm_tpu.sampling import build_schedule as j_build_schedule
from ddnm_tpu.sampling import sample_posterior as j_sample_posterior
from ddnm_tpu.sampling import sample_simplified as j_sample_simplified
from ddnm_tpu.sampling import sample_svd as j_sample_svd
from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.sampling import (
    build_posterior_tables,
    build_schedule,
    sample_posterior,
    sample_simplified,
    sample_svd,
)
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators
from ddnm_tpu_torch.sampling.solvers import _Coefs
from tests._golden import TOY32, build_our_operator, load_eval_images, psnr01, toy_mask
from tests._torch_port import (  # noqa: F401 (one_torch_thread: autouse)
    jax_model,
    linear_gaussian,
    main_pair,
    one_torch_thread,
    port_model,
    x_T,
    zero_noise_torch,
)

V = 0.25
RES = 32
j_zero = lambda key, shape: jnp.zeros(shape, jnp.float32)
to01 = lambda a: np.clip((a + 1.0) / 2.0, 0.0, 1.0)


def _nt_tables(build, betas, n_steps, sigma_y=0.0):
    """Respaced posterior tables with no time travel (pure descent)."""
    return build(betas=betas, timestep_respacing=str(n_steps), sigma_y=sigma_y,
                 schedule_jump_params=dict(t_T=n_steps, n_sample=1, jump_length=1,
                                           jump_n_sample=1))


def _exact(x_init, ab0):
    """The flow's endpoint from abar0: x * sqrt(v) / sqrt(abar0 v + 1 - abar0)."""
    return x_init * np.sqrt(V) / np.sqrt(ab0 * V + 1.0 - ab0)


def test_multistep_is_second_order_and_matches_jax_on_the_analytic_ode():
    betas, j_model, t_model, jop, op, x_init = linear_gaussian(v=V)
    abar = jsch.alpha_bar_table(betas)
    errs = []
    for n in (40, 80, 160):
        sched = build_schedule(betas=betas.astype(np.float32), t_sampling=n)
        ours, _ = sample_simplified(t_model, torch.from_numpy(x_init),
                                    torch.zeros(x_init.shape), op, sched, [None] * 2,
                                    noise_fn=zero_noise_torch, solver="multistep")
        ref, _ = j_sample_simplified(j_model, jnp.asarray(x_init), jnp.zeros(x_init.shape),
                                     jop, j_build_schedule(betas=betas, t_sampling=n),
                                     jax.random.PRNGKey(0), noise_fn=j_zero, loop="scan",
                                     solver="multistep")
        assert float(np.abs(ours.numpy() - np.asarray(ref)).max()) <= 1e-5
        exact = _exact(x_init, float(abar[int(sched.t_cur[0]) + 1]))
        errs.append(float(np.abs(ours.numpy() - exact).max()))
    assert errs[0] / errs[1] > 3.0 and errs[1] / errs[2] > 3.0, errs
    assert errs[2] < 1e-2, errs


def test_posterior_multistep_is_second_order_and_matches_jax_on_the_analytic_ode():
    betas, j_eps, t_eps, jop, op, x_init = linear_gaussian(v=V)
    j_model = lambda x, t: jnp.concatenate([j_eps(x, t), jnp.zeros_like(x)], axis=-1)
    t_model = lambda x, t: torch.cat([t_eps(x, t), torch.zeros_like(x)], dim=-1)
    zeros = np.zeros_like(x_init)
    errs = []
    for n in (40, 80, 160):
        tables = _nt_tables(build_posterior_tables, betas, n)
        ours, _ = sample_posterior(t_model, torch.from_numpy(x_init), torch.from_numpy(zeros),
                                   op, tables, [None] * 2, clip_denoised=False,
                                   noise_fn=zero_noise_torch, solver="multistep")
        ref, _ = j_sample_posterior(j_model, jnp.asarray(x_init), jnp.asarray(zeros), jop,
                                    _nt_tables(j_tables, betas, n), jax.random.PRNGKey(0),
                                    clip_denoised=False, noise_fn=j_zero, loop="scan",
                                    solver="multistep")
        assert float(np.abs(ours.numpy() - np.asarray(ref)).max()) <= 1e-5
        abar = 1.0 / np.asarray(tables.sqrt_recip_alphas_cumprod, np.float64) ** 2
        exact = _exact(x_init, float(abar[int(tables.t_cur[0])]))
        errs.append(float(np.abs(ours.numpy() - exact).max()))
    assert errs[0] / errs[1] > 3.0 and errs[1] / errs[2] > 3.0, errs
    assert errs[2] < 1e-2, errs
    # undo jumps (zero noise) drop the history at the same steps as JAX
    kw = dict(betas=betas, timestep_respacing="25", schedule_jump_params=dict(
        t_T=25, n_sample=1, jump_length=10, jump_n_sample=2))
    ours, _ = sample_posterior(t_model, torch.from_numpy(x_init), torch.from_numpy(zeros), op,
                               build_posterior_tables(**kw), [None] * 2, clip_denoised=False,
                               noise_fn=zero_noise_torch, solver="multistep")
    ref, _ = j_sample_posterior(j_model, jnp.asarray(x_init), jnp.asarray(zeros), jop,
                                j_tables(**kw), jax.random.PRNGKey(0), clip_denoised=False,
                                noise_fn=j_zero, loop="host", solver="multistep")
    assert float(np.abs(ours.numpy() - np.asarray(ref)).max()) <= 1e-5


def test_time_travel_is_deterministic_and_drops_the_history():
    """Travel steps re-noise the last raw x0 from the images' generators and
    make the next step first order: the stochastic run repeats itself bit
    for bit, and with zero noise it equals the JAX solver's trajectory."""
    betas, j_model, t_model, jop, op, x_init = linear_gaussian(v=V)
    sched = build_schedule(betas=betas.astype(np.float32), t_sampling=10, travel_length=2,
                           travel_repeat=2)
    travel = sched.is_travel
    assert travel.any()
    abar = np.asarray(sched.alpha_bar)
    co = _Coefs(abar[sched.t_cur + 1], abar[sched.t_next + 1], travel, "cpu")
    after_jump = np.concatenate([[False], travel[:-1]]) & ~travel
    assert after_jump.any() and not any(np.asarray(co.second_order)[after_jump])
    assert any(co.second_order)
    runs = [sample_simplified(t_model, torch.from_numpy(x_init), torch.zeros(x_init.shape), op,
                              sched, image_generators(11, [0, 1], STREAM_SAMPLE, "cpu"),
                              solver="multistep")[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and torch.isfinite(runs[0]).all()
    ours, _ = sample_simplified(t_model, torch.from_numpy(x_init), torch.zeros(x_init.shape),
                                op, sched, [None] * 2, noise_fn=zero_noise_torch,
                                solver="multistep")
    ref, _ = j_sample_simplified(
        j_model, jnp.asarray(x_init), jnp.zeros(x_init.shape), jop,
        j_build_schedule(betas=betas, t_sampling=10, travel_length=2, travel_repeat=2),
        jax.random.PRNGKey(0), noise_fn=j_zero, loop="host", solver="multistep")
    assert float(np.abs(ours.numpy() - np.asarray(ref)).max()) <= 1e-5


# ------------------------------------------------------- trained toy fixtures


@pytest.fixture(scope="module")
def toy():
    """(port model, JAX model_fn, JAX params, gt NHWC [-1, 1], x_T, betas)."""
    fn, params = jax_model(TOY32)
    gt = np.ascontiguousarray(np.transpose(load_eval_images(4, TOY32), (0, 2, 3, 1)))
    betas = jsch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                   num_diffusion_timesteps=1000).astype(np.float32)
    return port_model(TOY32), fn, params, gt, x_T(4, RES), betas


@pytest.mark.parametrize("mode,steps", [("simplified", 6), ("simplified", 10), ("svd", 10)])
def test_multistep_matches_jax_on_toy32(toy, mode, steps):
    model, fn, params, gt, xt, betas = toy
    gt, xt = gt[:2], xt[:2]
    sched = build_schedule(betas=betas, t_sampling=steps)
    jsched = j_build_schedule(betas=betas, t_sampling=steps)
    if mode == "simplified":
        jop = j_build_op("sr_averagepooling", image_size=RES, deg_scale=4.0)
        ref, _ = j_sample_simplified(fn, jnp.asarray(xt), jop.A(jnp.asarray(gt)), jop, jsched,
                                     jax.random.PRNGKey(0), noise_fn=j_zero, params=params,
                                     loop="host", solver="multistep")
        op = build_functional_operator("sr_averagepooling", image_size=RES, deg_scale=4.0)
        ours, _ = sample_simplified(model, torch.from_numpy(xt), op.A(torch.from_numpy(gt)), op,
                                    sched, [None] * 2, noise_fn=zero_noise_torch,
                                    solver="multistep")
    else:
        jop = build_our_operator("sr_averagepooling", 4.0, res=RES)
        vec = np.transpose(gt, (0, 3, 1, 2)).reshape(2, -1)
        ref, _ = j_sample_svd(fn, jnp.asarray(xt), jop.A(jnp.asarray(vec)), jop, jsched,
                              jax.random.PRNGKey(0), noise_fn=j_zero, params=params,
                              loop="host", solver="multistep")
        op = build_svd_operator("sr_averagepooling", channels=3, image_size=RES, deg_scale=4.0)
        ours, _ = sample_svd(model, torch.from_numpy(xt), op.A(torch.from_numpy(vec)), op,
                             sched, [None] * 2, noise_fn=zero_noise_torch, solver="multistep")
    ours, ref = ours.numpy(), np.asarray(ref)
    assert float(np.abs(ours - ref).max()) <= 1e-4
    assert abs(psnr01(to01(ours), to01(gt)) - psnr01(to01(ref), to01(gt))) <= 0.01
    assert psnr01(to01(ours), to01(gt)) > 25.0  # a restoration


def _port_run(toy, solver, steps, n=4):
    model, _, _, gt, xt, betas = toy
    op = build_functional_operator("sr_averagepooling", image_size=RES, deg_scale=4.0)
    x, _ = sample_simplified(model, torch.from_numpy(xt[:n]), op.A(torch.from_numpy(gt[:n])), op,
                             build_schedule(betas=betas, t_sampling=steps), [None] * n,
                             noise_fn=zero_noise_torch, solver=solver)
    return psnr01(to01(x.numpy()), to01(gt[:n]))


def test_multistep_wins_the_ultra_low_nfe_regime_on_the_port(toy):
    """The JAX package's measured regime split (tests/test_solvers.py
    test_multistep_wins_the_ultra_low_nfe_regime) holds on the port: at 6
    and 10 steps multistep beats ddim by more than 4 and 3 dB, and ddim at
    25 steps beats multistep at 10 by more than 4 dB."""
    ms6, dd6 = _port_run(toy, "multistep", 6), _port_run(toy, "ddim", 6)
    assert ms6 > dd6 + 4.0, (ms6, dd6)
    ms10, dd10 = _port_run(toy, "multistep", 10), _port_run(toy, "ddim", 10)
    assert ms10 > dd10 + 3.0, (ms10, dd10)
    dd25 = _port_run(toy, "ddim", 25)
    assert dd25 > ms10 + 4.0, (dd25, ms10)


def test_multistep_op_ctx_matches_static_mask(toy):
    model, _, _, gt, xt, betas = toy
    sched = build_schedule(betas=betas, t_sampling=8)
    mask = toy_mask(RES)
    op_static = build_functional_operator("inpainting", image_size=RES, mask=mask)
    y = op_static.A(torch.from_numpy(gt))
    x_stat, _ = sample_simplified(model, torch.from_numpy(xt), y, op_static, sched, [None] * 4,
                                  noise_fn=zero_noise_torch, solver="multistep")
    op_ctx = build_functional_operator("inpainting", image_size=RES,
                                       mask=np.ones((RES, RES), np.int64))
    ctx = torch.from_numpy(mask.astype(np.float32))[None, :, :, None].expand(4, RES, RES, 1)
    x_ctx, _ = sample_simplified(model, torch.from_numpy(xt), y, op_ctx, sched, [None] * 4,
                                 noise_fn=zero_noise_torch, solver="multistep", op_ctx=ctx)
    assert float((x_stat - x_ctx).abs().max()) <= 1e-5


def test_multistep_rejects_noisy_and_unknown_solver():
    betas, _, t_model, _, op, x_init = linear_gaussian(v=V)
    sched = build_schedule(betas=betas.astype(np.float32), t_sampling=5)
    x, y = torch.from_numpy(x_init), torch.zeros(x_init.shape)
    with pytest.raises(ValueError, match="noise-free"):
        sample_simplified(t_model, x, y, op, sched, [None] * 2, sigma_y=0.1, solver="multistep")
    with pytest.raises(ValueError, match="unknown solver"):
        sample_simplified(t_model, x, y, op, sched, [None] * 2, solver="euler")
    svd_op = build_svd_operator("denoising", image_size=8)
    with pytest.raises(ValueError, match="noise-free"):
        sample_svd(t_model, x, torch.zeros(2, 192), svd_op, sched, [None] * 2, sigma_y=0.1,
                   solver="multistep")
    with pytest.raises(ValueError, match="unknown solver"):
        sample_svd(t_model, x, torch.zeros(2, 192), svd_op, sched, [None] * 2, solver="euler")
    with pytest.raises(ValueError, match="context-parameterised"):
        sample_simplified(t_model, x, y, build_functional_operator("colorization", image_size=8),
                          sched, [None] * 2, solver="multistep", op_ctx=x[..., :1])


def test_runner_rejects_multistep_misuse():
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.runner import RunArgs, Runner

    cfg = load_config(TOY32.fixture.parents[2] / "configs" / "toy32.yml")
    with pytest.raises(ValueError, match="noise-free"):
        Runner(RunArgs(solver="multistep", sigma_y=0.1, device="cpu"), cfg)
    with pytest.raises(ValueError, match="noise-free"):
        Runner(RunArgs(solver="multistep", add_noise=True, device="cpu"), cfg)
    with pytest.raises(ValueError, match="encoder_cache"):
        Runner(RunArgs(solver="multistep", encoder_cache=3, device="cpu"), cfg)


def test_main_torch_multistep_matches_main_py(tmp_path, monkeypatch):
    """main_torch --solver multistep --t_sampling 6 against the JAX CLI on
    configs/toy32.yml, both under one x_T (tests/_torch_port.py shared_noise)."""
    ours, ref = main_pair(tmp_path, monkeypatch, ["--solver", "multistep", "--t_sampling", "6"])
    assert ours["num_samples"] == ref["num_samples"] == 2
    assert abs(ours["avg_psnr"] - ref["avg_psnr"]) <= 0.01
    assert ours["range_space_max_abs"] <= 1e-4


# ------------------------------------------------- posterior (hq) multistep


@pytest.fixture(scope="module")
def toy_adm():
    import json

    from ddnm_tpu_torch.models import ADMUNet
    from ddnm_tpu_torch.runner import load_checkpoint
    from tests._golden_adm import ADM_TOY32
    from tests._golden_adm import load_our_model as load_adm

    kw = json.loads((ADM_TOY32.fixture.parent / "toy_adm32.json").read_text())["adm_kw"]
    model = ADMUNet(**kw).eval()
    load_checkpoint(model, ADM_TOY32.fixture)
    return model, *load_adm(ADM_TOY32)


@pytest.mark.parametrize("jumps", [False, True])
def test_posterior_multistep_matches_jax_on_toy_adm32(toy_adm, jumps):
    """6 NFE, and the golden schedule's 45 (respacing 25 with 10 x 2 undo
    jumps, which drop the history), on the toy32 ADM, zero noise, shared
    x_T, 4x average-pooling SR: within 1e-4 without jumps; with them within
    1e-3, the gate of the ddim form on a jump schedule
    (tests/test_torch_posterior.py test_sample_posterior_matches_jax_at_toy32:
    each undo re-enters a high-noise step that multiplies the two UNets'
    ~1e-6 differences by 1 / sqrt(abar)). On the analytic model the jump
    schedule agrees with JAX to 2e-8, so the logic adds nothing; the PSNR
    within 0.01 dB either way."""
    model, fn, params = toy_adm
    gt = np.ascontiguousarray(np.transpose(load_eval_images(2, TOY32), (0, 2, 3, 1)))
    xt = x_T(2, RES)
    betas = sch.named_beta_schedule("linear", 1000, use_scale=True)
    kw = (dict(timestep_respacing="25", schedule_jump_params=dict(
        t_T=25, n_sample=1, jump_length=10, jump_n_sample=2)) if jumps else
          dict(timestep_respacing="6", schedule_jump_params=dict(
              t_T=6, n_sample=1, jump_length=1, jump_n_sample=1)))
    tables = build_posterior_tables(betas=betas, **kw)
    assert bool(tables.is_travel.any()) == jumps
    jop = j_build_op("sr_averagepooling", image_size=RES, deg_scale=4.0)
    ref, ref0 = j_sample_posterior(fn, jnp.asarray(xt), jop.Ap(jop.A(jnp.asarray(gt))), jop,
                                   j_tables(betas=betas, **kw), jax.random.PRNGKey(0),
                                   noise_fn=j_zero, params=params, loop="host",
                                   solver="multistep")
    op = build_functional_operator("sr_averagepooling", image_size=RES, deg_scale=4.0)
    ours, ours0 = sample_posterior(lambda x, t: model(x, t), torch.from_numpy(xt),
                                   op.Ap(op.A(torch.from_numpy(gt))), op, tables, [None] * 2,
                                   noise_fn=zero_noise_torch, solver="multistep")
    for a, b in ((ours, ref), (ours0, ref0)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= (1e-3 if jumps else 1e-4)
    assert abs(psnr01(to01(ours.numpy()), to01(gt))
               - psnr01(to01(np.asarray(ref)), to01(gt))) <= 0.01


def test_posterior_multistep_paste_constraint_holds():
    betas, _, t_eps, _, op, x_init = linear_gaussian(v=V)
    model = lambda x, t: torch.cat([t_eps(x, t), torch.zeros_like(x)], dim=-1)
    mask = torch.zeros(1, 8, 8, 1)
    mask[:, :, :4] = 1.0  # the left half pasted, a solved neighbour strip
    _, x0_hat = sample_posterior(model, torch.from_numpy(x_init), torch.zeros(x_init.shape), op,
                                 _nt_tables(build_posterior_tables, betas, 8), [None] * 2,
                                 paste_mask=mask, paste_content=torch.full(x_init.shape, 0.25),
                                 clip_denoised=False, noise_fn=zero_noise_torch,
                                 solver="multistep")
    np.testing.assert_allclose(x0_hat[:, :, :4].numpy(), 0.25, atol=1e-6)


def test_posterior_multistep_rejects_noisy_tables():
    betas, _, t_eps, _, op, x_init = linear_gaussian(v=V)
    model = lambda x, t: torch.cat([t_eps(x, t), torch.zeros_like(x)], dim=-1)
    x = torch.from_numpy(x_init)
    with pytest.raises(ValueError, match="noise-free"):
        sample_posterior(model, x, x, op, _nt_tables(build_posterior_tables, betas, 8, 0.5),
                         [None] * 2, solver="multistep")
    with pytest.raises(ValueError, match="unknown solver"):
        sample_posterior(model, x, x, op, _nt_tables(build_posterior_tables, betas, 8),
                         [None] * 2, solver="rk4")


def test_posterior_multistep_wins_low_nfe_regime_on_the_port(toy_adm):
    """The split of tests/test_solvers.py
    test_posterior_multistep_wins_low_nfe_regime on the port: a 64 x 64
    Mask-Shift canvas of 9 toy32 tiles, zero noise, the tiles' own inits
    (fresh for multistep, carried for ddim: the library defaults): at 6
    NFE a tile multistep beats ddim by more than 3.5 dB, and ddim at 25
    beats multistep at 6 by more than 2 dB."""
    import sys
    from pathlib import Path

    from ddnm_tpu_torch import tiling

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools" / "experiments"))
    from natural_family import make_naturals

    model = toy_adm[0]
    gt = np.asarray(make_naturals(jax.random.PRNGKey(42), 1, 64))
    betas = sch.named_beta_schedule("linear", 1000, use_scale=True)

    def run(solver, nfe):
        out = tiling.mask_shift_sample(
            lambda x, t: model(x, t), gt, "sr_averagepooling",
            _nt_tables(build_posterior_tables, betas, nfe), 7, scale=4, tile=32, stride=16,
            noise_fn=zero_noise_torch, device="cpu", solver=solver)
        return psnr01(to01(out["final"][0]), to01(gt[0]))

    ms6, dd6 = run("multistep", 6), run("ddim", 6)
    assert ms6 > dd6 + 3.5, (ms6, dd6)
    dd25 = run("ddim", 25)
    assert dd25 > ms6 + 2.0, (dd25, ms6)
