"""Classifier guidance in the port (ddnm_tpu_torch/models/unet_adm.py) on the
CPU, held against the JAX package on the same weights:

  - the trained toy32 classifier (tests/fixtures/toy_clf32.pt): logits and
    the guidance gradient grad_x log p(y | x) * scale against JAX
    `classifier_guidance_fn` / `classifier_guidance_from_params` (jax.grad),
    within 1e-4 relative in fp32;
  - the other three pools and ADMSuperResModel against JAX at toy size, on
    JAX's init perturbed (so that its zero-initialised layers carry
    signal) and carried across with params_from_flax;
  - the guided hq golden (tests/fixtures/toy_adm32_guided_golden.json,
    tools/emit_toy_adm32_guided_golden.py) through the port's
    sample_posterior: within 0.01 dB of JAX, per image within 1e-3 of the
    JAX output;
  - hq_main_torch guided on a toy32 hq config, and the Runner on a 64 px
    cut of configs/imagenet_256_cc.yml against the JAX Runner."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import hq_main_torch
from ddnm_tpu.models.unet_adm import ADMClassifier as JADMClassifier
from ddnm_tpu.models.unet_adm import ADMSuperResModel as JADMSuperResModel
from ddnm_tpu.models.unet_adm import classifier_guidance_fn as j_guidance_fn
from ddnm_tpu.models.unet_adm import classifier_guidance_from_params as j_guidance_from_params
from ddnm_tpu_torch.models import (
    ADMClassifier,
    ADMSuperResModel,
    cast_torso,
    classifier_guidance_fn,
    classifier_guidance_from_params,
    params_from_flax,
)
from tests._golden_adm import ADM_TOY32, GUIDED_CLASS, load_our_classifier
from tests._torch_port import one_torch_thread, write_toy_cc_config  # noqa: F401
from tests.test_torch_hq_cli import TOY_CLASSIFIER, TOY_CONF

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
GOLDEN = json.loads(chip_smoke.GUIDED_GOLDEN.read_text())
TOY_ARCH = dict(image_size=32, in_channels=3, model_channels=32, num_res_blocks=1,
                attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
                num_head_channels=32, use_scale_shift_norm=True, resblock_updown=True)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(b: int, res: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, res, res, 3).astype(np.float32),
            rs.uniform(0, 999, b).astype(np.float32))


def _perturbed_init(module, seed, *args):
    """JAX's init of `module` on `args`, every leaf plus 0.05 N(0, 1)
    (numpy, from `seed`)."""
    params = module.init(jax.random.PRNGKey(seed), *args)
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.05 * rs.randn(*a.shape).astype(np.float32), params)


def _port_classifier(params, **kw):
    model = ADMClassifier(**kw).eval()
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


def test_toy32_classifier_logits_and_guidance_match_jax():
    cmodel, cparams = load_our_classifier(ADM_TOY32)
    kw = json.loads(chip_smoke.TOY_CLF_JSON.read_text())["clf_kw"]
    port = _port_classifier(cparams, **kw)
    x, t = _inputs(2, 32)
    with torch.no_grad():
        logits = port(torch.from_numpy(x), torch.from_numpy(t))
    assert _rel(logits.numpy(), cmodel.apply(cparams, jnp.asarray(x), jnp.asarray(t))) <= 1e-4
    want = j_guidance_fn(cmodel.apply, jnp.full((2,), GUIDED_CLASS, jnp.int32), 2.0,
                         params=cparams)(jnp.asarray(x), jnp.asarray(t))
    got = classifier_guidance_fn(port, GUIDED_CLASS, 2.0)(torch.from_numpy(x),
                                                          torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got.numpy(), want) <= 1e-4
    assert not any(p.requires_grad for p in port.parameters())  # frozen by the hook
    # per-example labels from run_params (the server's convention)
    classes = np.array([0, 3], np.int32)
    want = j_guidance_from_params(cmodel.apply, 1.5)(
        {"classifier": cparams, "classes": jnp.asarray(classes)}, jnp.asarray(x),
        jnp.asarray(t))
    got = classifier_guidance_from_params(lambda m, z, s: m(z, s), 1.5)(
        {"classifier": port, "classes": torch.from_numpy(classes)}, torch.from_numpy(x),
        torch.from_numpy(t))
    assert _rel(got.numpy(), want) <= 1e-4


def test_dense_random_classifier_reaches_every_backward():
    """chip_smoke's full-width gradient check draws the zero-initialised
    layers too: with them zero (init_like_flax, as --random_init builds
    the classifier) only some GroupNorm and attention backwards get a
    non-zero incoming gradient; drawn, every one does. The census
    (chip_smoke.backward_dy_census) puts the Functions' backward back."""
    from ddnm_tpu_torch.models.unet_adm import init_like_flax
    from ddnm_tpu_torch.ops.attention import AttentionFunction
    from ddnm_tpu_torch.ops.groupnorm import GroupNormFunction

    real = (GroupNormFunction.backward, AttentionFunction.backward)
    kw = json.loads(chip_smoke.TOY_CLF_JSON.read_text())["clf_kw"]
    x, t = (torch.from_numpy(a) for a in _inputs(2, 32))
    census = {}
    for dense in (False, True):
        clf = ADMClassifier(**kw)
        if dense:
            clf.zero_init = ()
        guide = classifier_guidance_fn(init_like_flax(clf, 1234).eval(), 2, 1.0)
        census[dense] = chip_smoke.backward_dy_census(lambda: guide(x, t))
    n_gn, n_attn = chip_smoke.module_counts(clf)
    assert census[True] == {"groupnorm": [n_gn, n_gn], "attention": [n_attn, n_attn]}
    assert census[False]["groupnorm"][0] < n_gn and census[False]["attention"][0] < n_attn
    assert (GroupNormFunction.backward, AttentionFunction.backward) == real


@pytest.mark.parametrize("pool", ["adaptive", "spatial", "spatial_v2"])
def test_classifier_pools_match_jax(pool):
    x, t = _inputs(2, 32, seed=1)
    jm = JADMClassifier(**TOY_ARCH, out_channels=5, pool=pool)
    params = _perturbed_init(jm, 3, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)))
    port = _port_classifier(params, **TOY_ARCH, out_channels=5, pool=pool)
    with torch.no_grad():
        logits = port(torch.from_numpy(x), torch.from_numpy(t))
    assert _rel(logits.numpy(), jm.apply(params, jnp.asarray(x), jnp.asarray(t))) <= 1e-4
    want = j_guidance_fn(jm.apply, jnp.array([1, 4], jnp.int32), 1.0,
                         params=params)(jnp.asarray(x), jnp.asarray(t))
    got = classifier_guidance_fn(port, torch.tensor([1, 4]), 1.0)(torch.from_numpy(x),
                                                                   torch.from_numpy(t))
    assert _rel(got.numpy(), want) <= 1e-4


def test_bf16_classifier_keeps_jax_fp32_layers():
    """Under cast_torso the torso goes to bf16 and the layers JAX computes in
    fp32 keep fp32 weights: the attention pool's positional embedding, the
    spatial pools' Linears and norm, the adaptive pool's 1x1 conv."""
    nets = {pool: cast_torso(ADMClassifier(**TOY_ARCH, out_channels=5, pool=pool),
                             torch.bfloat16) for pool in ("attention", "adaptive", "spatial_v2")}
    assert nets["attention"].input_blocks[0][0].weight.dtype == torch.bfloat16
    assert nets["attention"].out[2].positional_embedding.dtype == torch.float32
    assert nets["attention"].out[2].qkv_proj.weight.dtype == torch.bfloat16
    assert nets["adaptive"].out[3].weight.dtype == torch.float32
    assert {m.weight.dtype for m in nets["spatial_v2"].out if hasattr(m, "weight")} == {
        torch.float32}
    x, t = (torch.from_numpy(a) for a in _inputs(1, 32))
    with torch.no_grad():
        assert nets["attention"](x, t).dtype == torch.bfloat16  # logits in the torso dtype
        assert nets["spatial_v2"](x, t).dtype == torch.float32


def test_superres_model_matches_jax():
    """ADMSuperResModel: the low-resolution image upsampled bilinearly
    (jax.image.resize) and concatenated to x, through the UNet."""
    arch = dict(TOY_ARCH, in_channels=6, out_channels=6)
    rs = np.random.RandomState(5)
    x, t = _inputs(2, 32, seed=5)
    low = rs.randn(2, 12, 12, 3).astype(np.float32)
    jm = JADMSuperResModel(**arch)
    params = _perturbed_init(jm, 4, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)),
                             jnp.zeros((1, 12, 12, 3)))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(low))
    port = ADMSuperResModel(**arch).eval()
    port.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(low))
    assert got.shape == (2, 32, 32, 6)
    assert _rel(got.numpy(), want) <= 1e-4


def _tier_models(tier: str):
    """The trained ADM and classifier of a guided golden tier, port side."""
    from ddnm_tpu_torch.models import ADMUNet
    from ddnm_tpu_torch.runner import load_checkpoint

    if tier == "toy32":
        return chip_smoke.toy_adm("cpu"), chip_smoke.toy_classifier("cpu")
    arch = lambda name: json.loads((FIXTURES / name).read_text())["arch"]
    model, clf = ADMUNet(**arch("mid_adm64.json")), ADMClassifier(**arch("mid_clf64.json"))
    load_checkpoint(model, FIXTURES / "mid_adm64.pt")
    load_checkpoint(clf, FIXTURES / "mid_clf64.pt")
    return model.eval(), clf.eval()


@pytest.mark.parametrize("tier", ["toy32", pytest.param("mid64", marks=pytest.mark.slow)])
def test_guided_golden(tier):
    """The guided hq golden through the port (fp32): the batch PSNR within
    0.01 dB of the JAX package's recorded one (toy32 43.1492, mid64
    49.0197) and each image within 1e-3 of the JAX output."""
    psnr, x, per_image, _ = chip_smoke.guided_golden_run(*_tier_models(tier), "cpu", tier)
    want = GOLDEN["tiers"][tier]["recorded_psnr"]
    assert torch.isfinite(x).all()
    assert abs(psnr - want) <= chip_smoke.HQ_PSNR_TOL, (psnr, want)
    assert max(per_image) <= 1e-3, per_image


def test_golden_spells_out_the_protocol():
    p = GOLDEN["protocol"]
    assert (p["deg"], p["scale"], p["n_images"], p["x_T_seed"]) == ("sr_averagepooling", 4, 2, 11)
    assert (p["guided_class"], p["classifier_scale"]) == (GUIDED_CLASS, 2.0)
    for tier, res, rec in (("toy32", 32, 43.1492), ("mid64", 64, 49.0197)):
        t = GOLDEN["tiers"][tier]
        assert t["recorded_psnr"] == rec and abs(t["psnr"] - rec) <= 1e-3
        assert chip_smoke.decode_f32(t["gt"]).shape == (2, res, res, 3)
        assert chip_smoke.decode_f32(t["jax_output"]).shape == (2, res, res, 3)


def test_hq_main_torch_cpu_guided(tmp_path):
    """hq_main_torch on a toy32 hq config with class_cond and
    classifier_scale 1.0, the model and the classifier random from the
    seed: it runs, and its output differs from the same run unguided."""
    from ddnm_tpu_torch.data.io import load_image, save_image

    img = load_image(sorted((REPO / "exp/datasets/toy32").glob("*.png"))[0])
    save_image(img, tmp_path / "gt.png")
    finals = {}
    for scale in ("1.0", "0.0"):
        conf = tmp_path / f"guided_{scale}.yml"
        conf.write_text(TOY_CONF.format(class_cond="true", classifier_scale=scale)
                        + TOY_CLASSIFIER)
        out = hq_main_torch.main(["--config", str(conf), "--deg", "colorization",
                                  "--path_y", str(tmp_path / "gt.png"), "--class", "2",
                                  "--random_init", "--device", "cpu",
                                  "-i", str(tmp_path / f"o{scale}")])
        assert out["stats"]["tiles"] == 1 and np.isfinite(out["final"]).all()
        finals[scale] = out["final"]
    assert np.abs(finals["1.0"] - finals["0.0"]).max() > 1e-3


def test_runner_guided_matches_jax_runner(tmp_path):
    """The Runner on tests/_torch_port.py's 64 px cut of
    configs/imagenet_256_cc.yml (a class-conditional ADM guided toward
    class 951 by its classifier) against the JAX Runner: JAX's random
    model and classifier (perturbed) carried across as checkpoints, SVD
    4x average-pooling SR of one image, zero noise, a shared x_T."""
    from ddnm_tpu.config import load_config as j_load_config
    from ddnm_tpu.runner import RunArgs as JRunArgs
    from ddnm_tpu.runner import Runner as JRunner
    from ddnm_tpu.sampling import sample_svd as j_sample_svd
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.runner import RunArgs, Runner
    from ddnm_tpu_torch.sampling import sample_svd

    cfg_path = write_toy_cc_config(tmp_path / "cc.yml")
    common = dict(deg="sr_averagepooling", deg_scale=4.0, exp=str(REPO / "exp"),
                  path_y="imagenet")
    jrun = JRunner(JRunArgs(random_init=True, **common), j_load_config(cfg_path))
    model_fn, guidance_fn, run_params = jrun.build_model(jax.random.PRNGKey(0))
    assert guidance_fn is not None
    rs = np.random.RandomState(9)
    run_params = jax.tree.map(lambda a: np.asarray(a, np.float32)
                              + 0.02 * rs.randn(*a.shape).astype(np.float32), run_params)
    for name in ("model", "classifier"):
        torch.save(params_from_flax(run_params[name]), tmp_path / f"{name}.pt")
    runner = Runner(RunArgs(ckpt=str(tmp_path / "model.pt"),
                            classifier_ckpt=str(tmp_path / "classifier.pt"), device="cpu",
                            **common), load_config(cfg_path))
    model, guidance = runner.build_model(), runner.build_guidance()
    operator, jop = runner.build_operator(), jrun.build_operator()
    gt = runner.build_dataset()[0][0][None] * 2.0 - 1.0  # (1, 64, 64, 3)
    x_t = np.random.RandomState(42).randn(1, 64, 64, 3).astype(np.float32)
    y = jop.A(jnp.asarray(np.transpose(gt, (0, 3, 1, 2)).reshape(1, -1)))
    want, _ = j_sample_svd(model_fn, jnp.asarray(x_t), y, jop, jrun.sched, jax.random.PRNGKey(0),
                           eta=0.85, sigma_y=0.0, guidance_fn=guidance_fn, params=run_params,
                           noise_fn=lambda key, shape: jnp.zeros(shape, jnp.float32),
                           loop="host")
    got, _ = sample_svd(runner.model_fn(model), torch.from_numpy(x_t),
                        torch.from_numpy(np.array(y)), operator, runner.sched, [None],
                        eta=0.85, sigma_y=0.0, guidance_fn=guidance,
                        noise_fn=lambda gens, shape: torch.zeros(shape))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3
    # the guidance moved the result: the same run unguided lands elsewhere
    plain, _ = sample_svd(runner.model_fn(model), torch.from_numpy(x_t),
                          torch.from_numpy(np.array(y)), operator, runner.sched, [None],
                          eta=0.85, sigma_y=0.0,
                          noise_fn=lambda gens, shape: torch.zeros(shape))
    assert np.abs(plain.numpy() - np.asarray(want)).max() > 1e-2
