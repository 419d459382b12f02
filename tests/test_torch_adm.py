"""Port parity: the ADM UNet of ddnm_tpu_torch against ddnm_tpu's.

The toy32 tier's trained weights (tests/fixtures/toy_adm32.pt) load into
both, directly from the reference state dict and carried across from the
JAX parameter tree (params_from_flax); a small class-conditional config
runs from JAX's init with its weights redrawn from a seed (JAX zero-inits
the output convolutions), in both attention orders and both up/down
variants.

Tolerances, relative to max |JAX output|: fp32 within 1e-4 (two
frameworks' fp32 convolutions sum in different orders through ~20 layers);
bf16 within 2e-2 (the port's GroupNorm path applies FiLM and SiLU in fp32
and rounds once, where JAX rounds the norm, the FiLM and the SiLU to bf16
in turn: a few bf16 ulps per layer). With the redrawn weights of the small
configs JAX's own bf16 output lies 1.2-2.3e-2 from its fp32 one, so there
the port's bf16 is held within 2e-2 of JAX's fp32 and within 4e-2 (two
independent bf16 roundings) of JAX's bf16. The time embedding within 1e-4
(fp32 cos / sin of arguments up to 999, where one ulp of the argument is
6e-5)."""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.config import load_hq_config as j_load_hq_config
from ddnm_tpu.models import cast_torso as j_cast_torso
from ddnm_tpu.models.nn import timestep_embedding_adm as j_temb
from ddnm_tpu.models.unet_adm import ADMUNet as JADMUNet
from ddnm_tpu_torch.config import load_hq_config
from ddnm_tpu_torch.models import ADMUNet, cast_torso, params_from_flax
from ddnm_tpu_torch.models import unet_adm
from ddnm_tpu_torch.models.convert import _torch_path
from ddnm_tpu_torch.models.nn import timestep_embedding_adm
from ddnm_tpu_torch.models.unet_adm import init_like_flax
from ddnm_tpu_torch.runner import load_checkpoint
from tests._golden_adm import ADM_TOY32, _mod, load_our_model
from tests._torch_port import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOY_KW = json.loads((REPO / "tests/fixtures/toy_adm32.json").read_text())["adm_kw"]
BF16_TOL = 2e-2


def _inputs(res, n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, res, res, 3)).astype(np.float32)
    t = np.array([3.0, 999.0][:n] + list(rng.uniform(0, 999, max(0, n - 2))), np.float32)
    return x, t


def _toy(dtype=torch.float32):
    model = ADMUNet(**TOY_KW).eval()
    load_checkpoint(model, ADM_TOY32.fixture)
    return cast_torso(model, dtype) if dtype != torch.float32 else model


def _run(model, x, t, y=None):
    with torch.no_grad():
        args = (torch.from_numpy(y),) if y is not None else ()
        return model(torch.from_numpy(x), torch.from_numpy(t), *args).numpy()


def test_toy32_matches_jax_direct_and_carried():
    fn, params = load_our_model(ADM_TOY32)
    x, t = _inputs(32)
    ref = np.asarray(jax.jit(fn)(params, jnp.asarray(x), jnp.asarray(t)))
    direct = _toy()
    carried = ADMUNet(**TOY_KW).eval()
    carried.load_state_dict(params_from_flax(params), strict=True)
    for model in (direct, carried):
        ours = _run(model, x, t)
        assert ours.dtype == np.float32 and ours.shape == (2, 32, 32, 6)
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    sd_d, sd_c = direct.state_dict(), carried.state_dict()
    assert sd_d.keys() == sd_c.keys()
    for k in sd_d:
        assert torch.equal(sd_d[k], sd_c[k]), k


def test_toy32_bf16_matches_jax():
    # load_our_model(ADM_TOY32, "bfloat16") without a second load: the bf16
    # module and the fp32 weights cast as its torso
    _, params = load_our_model(ADM_TOY32)
    jmodel = _mod(ADM_TOY32.trainer_mod).build_model(dtype=jnp.bfloat16)
    x, t = _inputs(32)
    ref = np.asarray(jax.jit(jmodel.apply)(j_cast_torso(params, jnp.bfloat16),
                                           jnp.asarray(x), jnp.asarray(t)), np.float32)
    model = _toy(torch.bfloat16)
    for m in model.modules():
        if isinstance(m, unet_adm.GroupNormF32):
            assert m.weight.dtype == torch.float32
    assert model.dtype == torch.bfloat16
    ours = _run(model, x, t)
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    assert np.abs(ours - ref).max() <= BF16_TOL * np.abs(ref).max()


# small class-conditional configs: (legacy order, scale-shift norm, resblock
# up/down, num_head_channels, num_heads_upsample)
SMALL = {
    "legacy_ssn_updown": (True, True, True, 32, -1),
    "new_order_plain_resample": (False, False, False, -1, 1),
}


@functools.lru_cache(maxsize=None)
def _small_jax(variant):
    """(kwargs, redrawn params, inputs, {"fp32", "bf16": JAX outputs})."""
    legacy, ssn, updown, nhc, nhu = SMALL[variant]
    kw = dict(image_size=16, in_channels=3, model_channels=32, out_channels=6,
              num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
              num_heads=2, num_head_channels=nhc, num_heads_upsample=nhu,
              use_scale_shift_norm=ssn, resblock_updown=updown,
              use_new_attention_order=not legacy, num_classes=10)
    x, t = _inputs(16)
    y = np.array([3, 7], np.int32)
    tree = jax.eval_shape(JADMUNet(**kw).init, jax.random.PRNGKey(0),
                          *map(jnp.asarray, (x, t, y)))
    # draw every weight from a seed (JAX's init zero-inits the output
    # convolutions, which would hide them)
    rng = np.random.default_rng(1)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if len(a.shape) == 1:
            return (1.0 if "scale" in name else 0.0) + 0.1 * rng.standard_normal(a.shape)
        fan_in = a.shape[-2] * (a.shape[0] * a.shape[1] if len(a.shape) == 4 else 1)
        scale = 1.0 if "embedding" in name else 1.0 / np.sqrt(fan_in)
        return rng.standard_normal(a.shape) * scale

    params = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(draw(p, a), np.float32), tree)
    args = tuple(map(jnp.asarray, (x, t, y)))
    refs = {"fp32": np.asarray(jax.jit(JADMUNet(**kw).apply)(params, *args)),
            "bf16": np.asarray(jax.jit(JADMUNet(**kw, dtype=jnp.bfloat16).apply)(
                j_cast_torso(params, jnp.bfloat16), *args), np.float32)}
    return kw, params, (x, t, y.astype(np.int64)), refs


def _small_pair(variant, dtype):
    kw, params, inputs, refs = _small_jax(variant)
    port = ADMUNet(**kw).eval()
    port.load_state_dict(params_from_flax(params), strict=True)
    if dtype == torch.bfloat16:
        cast_torso(port, torch.bfloat16)
    return port, refs, inputs


@pytest.mark.parametrize("variant", sorted(SMALL))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_class_cond_matches_jax(variant, dtype):
    port, refs, (x, t, y) = _small_pair(variant, dtype)
    ours = _run(port, x, t, y)
    scale = np.abs(refs["fp32"]).max()
    assert scale > 0.1  # the redrawn output convolutions are live
    if dtype == torch.float32:
        np.testing.assert_allclose(ours, refs["fp32"], atol=1e-4, rtol=0)
    else:
        assert np.abs(ours - refs["fp32"]).max() <= BF16_TOL * scale
        assert np.abs(ours - refs["bf16"]).max() <= 2 * BF16_TOL * scale
    # batch-agnostic labels: image 1 alone equals image 1 in the batch
    alone = _run(port, x[1:], t[1:], y[1:])
    np.testing.assert_allclose(alone[0], ours[1], atol=1e-5 if dtype == torch.float32
                               else BF16_TOL * scale)


def test_head_guard_raises_the_same_error():
    kw = dict(image_size=8, model_channels=96, channel_mult=(1,), num_res_blocks=1,
              attention_resolutions=(1,), num_head_channels=64, out_channels=6)
    with pytest.raises(ValueError) as jerr:
        jax.eval_shape(JADMUNet(**kw).init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                       jnp.zeros((1,)))
    with pytest.raises(ValueError) as terr:
        ADMUNet(**kw)
    assert str(terr.value) == str(jerr.value)
    assert "not divisible by num_head_channels" in str(terr.value)


def test_time_embedding_matches_jax():
    t = np.array([0.0, 1.0, 17.0, 500.5, 999.0], np.float32)
    for dim in (32, 128, 256, 33):
        ours = timestep_embedding_adm(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(ours, np.asarray(j_temb(jnp.asarray(t), dim)),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [1, 3])
def test_attention_gets_contiguous_tokens(monkeypatch, n):
    """The kernel takes contiguous (B * heads, T, ch) q, k and v; at batch 1
    a transpose-and-reshape is a strided view, so the fold copies."""
    seen = []
    real = unet_adm.attention

    def spy(q, k, v, scale, force=None):
        seen.append((tuple(q.shape), q.is_contiguous(), k.is_contiguous(), v.is_contiguous(),
                     scale))
        return real(q, k, v, scale, force)

    monkeypatch.setattr(unet_adm, "attention", spy)
    x, t = _inputs(32, n=n)
    _run(_toy(), x, t)
    assert seen and all(c == [True, True, True] for _, *c, _ in seen)
    assert {s for s, *_ in seen} == {(n * 2, 256, 32)} and {s[-1] for s in seen} == {1.0}


def test_split_forward_and_missing_labels_raise():
    """The split forward (the encoder cache's, tests/test_torch_accel.py)
    runs; a decoder-only call without a cache, an unknown mode and a
    class-conditional call without labels raise ValueError, as in JAX."""
    model = _toy()
    x = torch.zeros(1, 32, 32, 3)
    t = torch.zeros(1)
    with torch.no_grad():
        h, skips = model(x, t, mode="encode")
        assert torch.equal(model(x, t, mode="decode", cache=(h, skips)), model(x, t))
    with pytest.raises(ValueError, match="requires cache"):
        model(x, t, mode="decode")
    with pytest.raises(ValueError, match="mode must be"):
        model(x, t, mode="half")
    cc = ADMUNet(**dict(TOY_KW, num_classes=4))
    with pytest.raises(ValueError, match="labels"):
        cc(x, t)


def test_init_like_flax_draws_from_the_seed():
    kw = dict(image_size=16, model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(2,), num_head_channels=32, num_classes=5)
    a = init_like_flax(ADMUNet(**kw), 7)
    b = init_like_flax(ADMUNet(**kw), 7)
    sd_a, sd_b = a.state_dict(), b.state_dict()
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
        if k.endswith(("out_layers.3.weight", "proj_out.weight", "out.2.weight", ".bias")):
            assert not sd_a[k].any(), k  # zero-initialised layers, every bias
    w = sd_a["input_blocks.1.0.in_layers.2.weight"]
    assert abs(float(w.std()) * np.sqrt(32 * 9) - 1.0) < 0.1  # variance 1 / fan_in
    assert float(w.abs().max()) <= 2.0 / 0.8796 / np.sqrt(32 * 9) + 1e-6  # truncated at 2 std
    assert not torch.equal(sd_a["label_emb.weight"],
                           init_like_flax(ADMUNet(**kw), 8).state_dict()["label_emb.weight"])


@pytest.mark.parametrize("name", ["inet256", "adm128", "face256", "smoke"])
def test_hq_config_models_have_the_jax_parameters(name):
    """Every hq config's ADM UNet: the port's keys and shapes (built on the
    meta device) are the JAX package's parameter tree carried by the
    converter's rules; inet256 has 553,838,086 parameters."""
    import hq_main
    import hq_main_torch

    path = REPO / "configs" / "hq" / f"{name}.yml"
    jmodel = hq_main.build_adm_from_hq(j_load_hq_config(path), jnp.float32)
    size = jmodel.image_size
    args = [jnp.zeros((1, size, size, 3)), jnp.zeros((1,))]
    if jmodel.num_classes:
        args.append(jnp.zeros((1,), jnp.int32))
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)["params"]
    want = {}
    for path_k, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(p.key for p in path_k)
        *mods, last = keys
        shape = tuple(leaf.shape)
        if mods[-1] == "gn":
            mods, last = mods[:-1], {"scale": "weight", "bias": "bias"}[last]
        elif last == "kernel":
            last = "weight"
            shape = ((shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4
                     else (shape[1], shape[0]) + ((1,) if mods[-1] in ("qkv", "proj_out")
                                                   else ()))
        elif last == "embedding":
            last = "weight"
        want[f"{_torch_path(tuple(mods))}.{last}"] = shape
    port = hq_main_torch.build_adm_from_hq(load_hq_config(path), "meta")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    if name == "inet256":
        assert sum(int(np.prod(s)) for s in got.values()) == 553_838_086
