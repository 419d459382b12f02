"""Port parity: the encoder propagation (ddnm_tpu_torch/sampling/accel.py)
against ddnm_tpu/sampling/accel.py, and the ADM UNet's split forward.

Gates: `interval=1` is the exact sampler bit for bit (torch.equal) in the
simplified and the posterior form, with the generators' noise and time
travel; interval 3 (uniform and end_dense) within 1e-4 max abs of JAX on
toy_ddpm32.pt and toy_adm32.pt (zero noise, a shared x_T);
`measure_feature_drift` within 1e-4 of JAX relative to its largest drift;
the key-step policies equal to JAX's lists; the ADM's encode then decode
equal to its forward bit for bit on the CPU; main_torch against main.py
within 0.01 dB."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddnm_tpu.sampling.accel as ja
from ddnm_tpu import schedules as jsch
from ddnm_tpu.operators import build_functional_operator as j_build_op
from ddnm_tpu.sampling import build_posterior_tables as j_tables
from ddnm_tpu.sampling import build_schedule as j_build_schedule
from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.models import ADMUNet, cast_torso
from ddnm_tpu_torch.models.unet_adm import ADMSuperResModel, init_like_flax
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.runner import load_checkpoint
from ddnm_tpu_torch.sampling import accel
from ddnm_tpu_torch.sampling import build_posterior_tables, build_schedule, sample_posterior
from ddnm_tpu_torch.sampling import sample_simplified
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators
from tests._golden import TOY32, _trainer, load_eval_images, psnr01
from tests._golden_adm import ADM_TOY32, _mod
from tests._golden_adm import load_our_model as load_adm
from tests._torch_port import (  # noqa: F401 (one_torch_thread: autouse)
    jax_model,
    main_pair,
    one_torch_thread,
    port_model,
    x_T,
    zero_noise_torch,
)

RES = 32
BETAS = jsch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                               num_diffusion_timesteps=1000).astype(np.float32)
ADM_KW = json.loads((ADM_TOY32.fixture.parent / "toy_adm32.json").read_text())["adm_kw"]
HQ_BETAS = sch.named_beta_schedule("linear", 1000, use_scale=True)
# the golden protocol's hq schedule: respacing 25, 10 x 2 undo jumps (45 calls)
GOLDEN_HQ = dict(timestep_respacing="25", schedule_jump_params=dict(
    t_T=25, n_sample=1, jump_length=10, jump_n_sample=2))
j_zero = lambda key, shape: jnp.zeros(shape, jnp.float32)
to01 = lambda a: np.clip((a + 1.0) / 2.0, 0.0, 1.0)


@pytest.fixture(scope="module")
def ddpm():
    """(port model, JAX split fns, JAX params, gt NHWC, x_T) on toy32."""
    _, params = jax_model(TOY32)
    jmodel = _trainer(TOY32).build_model(dtype=jnp.float32)
    gt = np.ascontiguousarray(np.transpose(load_eval_images(2, TOY32), (0, 2, 3, 1)))
    return port_model(TOY32), ja.ddpm_split_fns(jmodel), params, gt, x_T(2, RES)


@pytest.fixture(scope="module")
def adm():
    """(port toy32 ADM, JAX split fns, JAX params)."""
    model = ADMUNet(**ADM_KW).eval()
    load_checkpoint(model, ADM_TOY32.fixture)
    _, params = load_adm(ADM_TOY32)
    jmodel = getattr(_mod(ADM_TOY32.trainer_mod), ADM_TOY32.build_fn)(dtype=jnp.float32)
    return model, ja.adm_split_fns(jmodel), params


def _sr(gt):
    op = build_functional_operator("sr_averagepooling", image_size=RES, deg_scale=4.0)
    jop = j_build_op("sr_averagepooling", image_size=RES, deg_scale=4.0)
    return op, jop


# ------------------------------------------------------------ exactness


def test_interval_1_is_the_exact_simplified_sampler(ddpm):
    """Stochastic noise from the images' generators and time travel: every
    step, travel included, draws as the exact sampler does."""
    model, _, _, gt, xt = ddpm
    op, _ = _sr(gt)
    y = op.A(torch.from_numpy(gt))
    sched = build_schedule(betas=BETAS, t_sampling=10, travel_length=2, travel_repeat=2)
    assert sched.is_travel.any()
    gens = lambda: image_generators(5, [0, 1], STREAM_SAMPLE, "cpu")
    exact = sample_simplified(model, torch.from_numpy(xt), y, op, sched, gens())
    ours = accel.sample_simplified_encoder_prop(*accel.ddpm_split_fns(model),
                                                torch.from_numpy(xt), y, op, sched, gens(),
                                                interval=1)
    assert torch.equal(ours[0], exact[0]) and torch.equal(ours[1], exact[1])
    cached = accel.sample_simplified_encoder_prop(*accel.ddpm_split_fns(model),
                                                  torch.from_numpy(xt), y, op, sched, gens(),
                                                  interval=3)
    assert float((cached[0] - exact[0]).abs().max()) > 1e-4  # the cache is live


def test_interval_1_is_the_exact_posterior_sampler(adm):
    model = adm[0]
    gt = np.random.default_rng(1).uniform(-1, 1, (2, RES, RES, 3)).astype(np.float32)
    op, _ = _sr(gt)
    apy = op.Ap(op.A(torch.from_numpy(gt)))
    tables = build_posterior_tables(betas=HQ_BETAS, timestep_respacing="12",
                                    schedule_jump_params=dict(t_T=12, n_sample=1,
                                                              jump_length=3, jump_n_sample=2))
    assert tables.is_travel.any()
    gens = lambda: image_generators(9, [0, 1], STREAM_SAMPLE, "cpu")
    xt = torch.from_numpy(x_T(2, RES))
    paste = torch.zeros(2, RES, RES, 1)
    paste[:, :8] = 1.0
    content = torch.full((2, RES, RES, 3), 0.1)
    kw = dict(paste_mask=paste, paste_content=content)
    exact = sample_posterior(lambda x, t: model(x, t), xt, apy, op, tables, gens(), **kw)
    ours = accel.sample_posterior_encoder_prop(*accel.adm_split_fns(model), xt, apy, op,
                                               tables, gens(), interval=1, **kw)
    assert torch.equal(ours[0], exact[0]) and torch.equal(ours[1], exact[1])


# ---------------------------------------------------------- against JAX


@pytest.mark.parametrize("policy", ["uniform", "end_dense"])
def test_simplified_encoder_cache_matches_jax(ddpm, policy):
    model, (j_enc, j_dec), params, gt, xt = ddpm
    op, jop = _sr(gt)
    sched = build_schedule(betas=BETAS, t_sampling=25)
    key_steps = accel.key_steps_for_policy(accel.n_model_calls(sched), 3, policy)
    assert key_steps == ja.key_steps_for_policy(ja.n_model_calls(sched.is_travel), 3, policy)
    ours, ours0 = accel.sample_simplified_encoder_prop(
        *accel.ddpm_split_fns(model), torch.from_numpy(xt), op.A(torch.from_numpy(gt)), op,
        sched, [None] * 2, interval=3, key_steps=key_steps, noise_fn=zero_noise_torch)
    ref, ref0 = ja.sample_simplified_encoder_prop(
        j_enc, j_dec, jnp.asarray(xt), jop.A(jnp.asarray(gt)), jop,
        j_build_schedule(betas=BETAS, t_sampling=25), jax.random.PRNGKey(0), interval=3,
        key_steps=key_steps, noise_fn=j_zero, params=params)
    for a, b in ((ours, ref), (ours0, ref0)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-4
    assert abs(psnr01(to01(ours.numpy()), to01(gt))
               - psnr01(to01(np.asarray(ref)), to01(gt))) <= 0.01


@pytest.mark.parametrize("policy", ["uniform", "end_dense"])
def test_posterior_encoder_cache_matches_jax(adm, policy):
    model, (j_enc, j_dec), params = adm
    gt = np.ascontiguousarray(np.transpose(load_eval_images(2, TOY32), (0, 2, 3, 1)))
    op, jop = _sr(gt)
    xt = x_T(2, RES)
    tables = build_posterior_tables(betas=HQ_BETAS, **GOLDEN_HQ)
    key_steps = accel.key_steps_for_policy(accel.n_model_calls(tables), 3, policy)
    ours, ours0 = accel.sample_posterior_encoder_prop(
        *accel.adm_split_fns(model), torch.from_numpy(xt), op.Ap(op.A(torch.from_numpy(gt))),
        op, tables, [None] * 2, interval=3, key_steps=key_steps, noise_fn=zero_noise_torch)
    ref, ref0 = ja.sample_posterior_encoder_prop(
        j_enc, j_dec, jnp.asarray(xt), jop.Ap(jop.A(jnp.asarray(gt))), jop,
        j_tables(betas=HQ_BETAS, **GOLDEN_HQ), jax.random.PRNGKey(0), interval=3,
        key_steps=key_steps, noise_fn=j_zero, params=params)
    for a, b in ((ours, ref), (ours0, ref0)):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-4


def test_measure_feature_drift_matches_jax(ddpm):
    model, (j_enc, j_dec), params, gt, xt = ddpm
    op, jop = _sr(gt)
    sched = build_schedule(betas=BETAS, t_sampling=15)
    ours = accel.measure_feature_drift(*accel.ddpm_split_fns(model), torch.from_numpy(xt),
                                       op.A(torch.from_numpy(gt)), op, sched, [None] * 2,
                                       noise_fn=zero_noise_torch)
    ref = ja.measure_feature_drift(j_enc, j_dec, jnp.asarray(xt), jop.A(jnp.asarray(gt)), jop,
                                   j_build_schedule(betas=BETAS, t_sampling=15),
                                   jax.random.PRNGKey(0), noise_fn=j_zero, params=params)
    assert ours.shape == ref.shape == (15,) and ours[0] == 0.0
    assert float(np.abs(ours - ref).max()) <= 1e-4 * float(np.abs(ref).max())
    assert accel.select_key_steps(ours, 5) == ja.select_key_steps(ref, 5)


@pytest.mark.parametrize("n_calls", [10, 25, 100, 280])
def test_key_step_policies_match_jax(n_calls):
    for n_keys in sorted({1, 2, 3, n_calls // 4 or 1, n_calls // 3, n_calls}):
        if n_keys < 1:
            continue
        for tail in (None, 0, 2):
            assert (accel.key_steps_end_dense(n_calls, n_keys, tail)
                    == ja.key_steps_end_dense(n_calls, n_keys, tail))
        drift = np.random.default_rng(n_calls + n_keys).exponential(size=n_calls)
        drift[0] = 0.0
        assert accel.select_key_steps(drift, n_keys) == ja.select_key_steps(drift, n_keys)
    for interval in (1, 2, 3, 5):
        for policy in ("uniform", "end_dense", None):
            assert (accel.key_steps_for_policy(n_calls, interval, policy)
                    == ja.key_steps_for_policy(n_calls, interval, policy))
        ours, ref = accel._make_key_pred(interval, None), ja._make_key_pred(interval, None)
        assert [ours(i % 7, i) for i in range(n_calls)] == [ref(i % 7, i) for i in range(n_calls)]
    assert accel.n_model_calls(np.array([0, 1, 0, 0], bool)) == 3


def test_encoder_prop_refusals(ddpm):
    model = ddpm[0]
    enc, dec = accel.ddpm_split_fns(model)
    x = torch.zeros(1, RES, RES, 3)
    op = build_functional_operator("colorization", image_size=RES)
    sched = build_schedule(betas=BETAS, t_sampling=4)
    with pytest.raises(ValueError, match="interval must be"):
        accel.sample_simplified_encoder_prop(enc, dec, x, x, op, sched, [None], interval=0)
    with pytest.raises(ValueError, match="contradictory"):
        accel.sample_simplified_encoder_prop(enc, dec, x, x, op, sched, [None], interval=1,
                                             key_steps=[0, 2])
    svd = build_svd_operator("denoising", image_size=RES)  # no ctx forms
    with pytest.raises(ValueError, match="context-parameterised"):
        accel.sample_simplified_encoder_prop(enc, dec, x, x, svd, sched, [None],
                                             op_ctx=x[..., :1])
    tables = build_posterior_tables(betas=HQ_BETAS, **GOLDEN_HQ)
    with pytest.raises(ValueError, match="interval must be"):
        accel.sample_posterior_encoder_prop(enc, dec, x, x, op, tables, [None], interval=0)
    with pytest.raises(ValueError, match="context-parameterised"):
        accel.sample_posterior_encoder_prop(enc, dec, x, x, op, tables, [None],
                                            op_ctx=x[..., :1])
    with pytest.raises(ValueError, match="'uniform' or 'end_dense'"):
        accel.key_steps_for_policy(100, 3, "drift")
    with pytest.raises(ValueError, match="n_keys"):
        accel.key_steps_end_dense(10, 11)
    with pytest.raises(ValueError, match="n_keys"):
        accel.select_key_steps(np.zeros(4), 0)


# ----------------------------------------------------- the split forwards


def _adm_variants():
    cc = dict(ADM_KW, num_classes=4)
    sr = dict(ADM_KW, in_channels=6)
    return {"unet": (ADMUNet, ADM_KW, {}), "class_cond": (ADMUNet, cc, {"y": True}),
            "super_res": (ADMSuperResModel, sr, {"low_res": True})}


@pytest.mark.parametrize("name,dtype", [("unet", torch.float32), ("unet", torch.bfloat16),
                                        ("class_cond", torch.float32),
                                        ("super_res", torch.float32)])
def test_adm_encode_then_decode_equals_forward(name, dtype):
    """Bit for bit on the CPU; the decoder half takes x for its dtype only
    (and ignores low_res), and consumes a copy of the cached skips, so two
    decoder-only calls on one cache agree and leave it whole."""
    cls, kw, extra = _adm_variants()[name]
    model = init_like_flax(cls(**kw), 3)
    model.zero_init = ()
    model = init_like_flax(model, 3).eval()  # every layer drawn: the halves all live
    if dtype != torch.float32:
        cast_torso(model, dtype)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, RES, RES, 3, generator=g)
    t = torch.tensor([10.0, 700.0])
    args = {}
    if extra.get("y"):
        args["y"] = torch.tensor([1, 3])
    if extra.get("low_res"):
        args["low_res"] = torch.randn(2, 8, 8, 3, generator=g)
    with torch.no_grad():
        full = model(x, t, **args)
        cache = model(x, t, **args, mode="encode")
        n_skips = len(cache[1])
        dec_args = {k: v for k, v in args.items() if k != "low_res"}
        once = model(x, t, **dec_args, mode="decode", cache=cache)
        twice = model(torch.zeros_like(x), t, **dec_args, mode="decode", cache=cache)
    assert isinstance(cache, tuple) and isinstance(cache[1], tuple)
    assert len(cache[1]) == n_skips == len(model.output_blocks)
    assert torch.equal(once, full) and torch.equal(twice, full)
    with pytest.raises(ValueError, match="requires cache"):
        model(x, t, **dec_args, mode="decode")


def test_ddpm_split_fns_equal_forward(ddpm):
    model, _, _, _, xt = ddpm
    enc, dec = accel.ddpm_split_fns(model)
    x = torch.from_numpy(xt)
    t = torch.tensor([5.0, 600.0])
    with torch.no_grad():
        cache = enc(x, t)
        out = dec(cache, x, t)
        again = dec(cache, x, t)
        full = model(x, t)
    assert torch.equal(out, full) and torch.equal(again, full)


def test_main_torch_encoder_cache_matches_main_py(tmp_path, monkeypatch):
    """main_torch --encoder_cache 3 --encoder_cache_policy end_dense (25
    steps) against the JAX CLI on configs/toy32.yml under one noise pattern
    (tests/_torch_port.py shared_noise)."""
    ours, ref = main_pair(tmp_path, monkeypatch, ["--encoder_cache", "3",
                                                  "--encoder_cache_policy", "end_dense",
                                                  "--t_sampling", "25"])
    assert ours["num_samples"] == ref["num_samples"] == 2
    assert abs(ours["avg_psnr"] - ref["avg_psnr"]) <= 0.01
    assert ours["range_space_max_abs"] <= 1e-4


# ------------------------------------------- the card's golden, on the CPU


@pytest.fixture(scope="module")
def golden_models():
    import chip_smoke

    golden = json.loads(chip_smoke.SOLVER_GOLDEN.read_text())
    return golden, {"ddpm": chip_smoke.toy_ddpm("cpu", golden["protocol"]["ddpm"]),
                    "adm": chip_smoke.toy_adm("cpu")}


def test_solver_golden_protocol_names_the_fixtures_architecture():
    import chip_smoke
    from tests._torch_port import port_arch

    proto = json.loads(chip_smoke.SOLVER_GOLDEN.read_text())["protocol"]
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in proto["ddpm"]["ddpm_kw"].items()}
    assert kw == port_arch(TOY32)


@pytest.mark.parametrize("name", ["ms_simplified_6", "ms_simplified_10", "ms_svd_10",
                                  "ec3_uniform", "ec3_end_dense", "ms_maskshift_6",
                                  "ec3_maskshift"])
def test_solver_golden_on_the_cpu(golden_models, name, monkeypatch):
    """chip_smoke.py phase 15's protocol through the plain versions on the
    CPU: each image within SOLVER_PSNR_TOL of the JAX golden
    (tools/emit_torch_solver_golden.py) and the pooled output within
    SOLVER_POOL8_TOL; the key and decoder-only calls that phase 15 turns
    into launch counts equal the split halves' calls."""
    import chip_smoke

    golden, models = golden_models
    ref = golden["runs"][name]
    calls = {"encode": 0, "decode": 0}
    real = {k: getattr(accel, f"{k}_split_fns") for k in ("ddpm", "adm")}

    def counting(kind):
        def split_fns(model, *a, **kw):
            enc, dec = real[kind](model, *a, **kw)

            def encode_fn(x, t):
                calls["encode"] += 1
                return enc(x, t)

            def decode_fn(cache, x, t):
                calls["decode"] += 1
                return dec(cache, x, t)
            return encode_fn, decode_fn
        return split_fns

    for kind in real:
        monkeypatch.setattr(accel, f"{kind}_split_fns", counting(kind))
    r = chip_smoke.solver_golden_run(name, models, "cpu")
    for got, exp in zip(r["psnr"], ref["per_image_psnr"]):
        assert abs(got - exp) <= chip_smoke.SOLVER_PSNR_TOL
    assert np.abs(r["pool8"] - np.asarray(ref["pool8"], np.float32)).max() <= \
        chip_smoke.SOLVER_POOL8_TOL
    if golden["protocol"]["runs"][name].get("encoder_cache", 1) > 1:
        assert (calls["encode"], calls["decode"] - calls["encode"]) == (r["keys"], r["cached"])
        assert r["cached"] > r["keys"] > 0
    else:
        assert r["cached"] == 0 and r["keys"] > 0
