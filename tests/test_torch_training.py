"""Port parity of the training path (ddnm_tpu_torch/training.py, the
tools/train_*_golden_torch.py trainers) against the JAX package and optax
on the CPU, at toy size:

  - sampling/threefry.py `uniform` / `randint` bit-equal to jax.random's;
  - data/synthetic.py's image families against the JAX tools' functions;
  - GroupNormFunction's five gradients and the plain attention backward at
    the DDPM heads' C = 256 / 512 against jax.grad of the JAX functions;
  - one train step of the toy32 DDPM, ADM and classifier from the same
    parameters (params_from_flax of JAX's init) and key against
    jax.value_and_grad of the JAX trainers' step, and the 3-step protocol
    of chip_smoke.py phase 24 against tests/fixtures/toy_train_golden.json;
  - the cosine schedule and the Adam update against optax, the fresh
    initialisation against flax's by distribution, the snapshot resume,
    and the export round trip through data/checkpoints.py;
  - the trainers write under --out only.
"""

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddnm_tpu.ops import group_norm as j_group_norm
from ddnm_tpu.ops.attention import _xla_attention
from ddnm_tpu_torch import training
from ddnm_tpu_torch.data import synthetic
from ddnm_tpu_torch.data.checkpoints import load_checkpoint
from ddnm_tpu_torch.models import params_from_flax
from ddnm_tpu_torch.ops.attention import _torch_attention, _torch_attention_backward
from ddnm_tpu_torch.ops.groupnorm import GroupNormFunction
from ddnm_tpu_torch.sampling import threefry
from tests._torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
for sub in ("tools", "tools/experiments"):
    if str(REPO / sub) not in sys.path:
        sys.path.insert(0, str(REPO / sub))

import emit_torch_train_golden as emit  # noqa: E402
import natural_family as j_natural  # noqa: E402
import toy_quality_encoder_cache as j_toy_quality  # noqa: E402
import train_mid_golden as j_mid  # noqa: E402
import train_toy_classifier_golden as j_clf  # noqa: E402

# the port's trainer of each toy model (tools/*_torch.py)
PORT_TRAINERS = {"ddpm": "train_toy_golden_torch", "adm": "train_toy_adm_golden_torch",
                 "clf": "train_toy_classifier_golden_torch"}


def _port_trainer(name):
    import importlib

    return importlib.import_module(PORT_TRAINERS[name])


def _raw(seed: int) -> np.ndarray:
    return np.array(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**32 - 1])
def test_prng_key_is_jax_key_data(seed):
    assert np.array_equal(threefry.prng_key(seed).numpy(), _raw(seed).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("shape,lo,hi", [((5, 3, 2), 0.15, 0.85), ((128,), -1.0, 1.0),
                                         ((4, 1, 1, 1), 2.0, 2.8), ((2, 3), 0.0, 2 * np.pi),
                                         ((64, 64, 3), 0.0, 1.0)])
def test_uniform_is_jax_bit_for_bit(seed, shape, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo,
                                         maxval=hi))
    got = threefry.uniform(_raw(seed), shape, lo, hi).numpy()
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("shape,lo,hi", [((128,), 0, 1000), ((16,), 0, 4), ((9, 2), -5, 7),
                                         ((3,), 0, 2**31 - 1), ((5,), 3, 3),
                                         ((6,), -2**31, 2**31 - 1), ((4,), 0, 65537)])
def test_randint_is_jax_bit_for_bit(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
    assert np.array_equal(threefry.randint(_raw(seed), shape, lo, hi).numpy(), want)


@pytest.mark.parametrize("seed", [0, 7])
def test_image_families_match_jax(seed):
    """Blobs and class blobs within 1e-6 (linspace's last bit), naturals
    and the mix within 1e-5 (the inverse FFT's rounding); labels exact."""
    k = jax.random.PRNGKey(seed)
    jit = lambda f: jax.jit(f, static_argnums=(1, 2))  # noqa: E731  (one compile each)
    got = synthetic.make_blobs(_raw(seed), 5, 32).numpy()
    assert np.abs(got - np.asarray(jit(j_toy_quality.make_blobs)(k, 5, 32))).max() <= 1e-6
    for classes in (None, 2):
        x, cls = synthetic.make_class_blobs(_raw(seed), 7, 32, classes=classes)
        jx, jcls = jax.jit(j_clf.make_class_blobs, static_argnums=(1, 2, 3, 4))(k, 7, 32, 4,
                                                                              classes)
        assert np.abs(x.numpy() - np.asarray(jx)).max() <= 1e-6
        assert np.array_equal(cls.numpy(), np.asarray(jcls))
    got = synthetic.make_naturals(_raw(seed), 3, 64).numpy()
    assert np.abs(got - np.asarray(jit(j_natural.make_naturals)(k, 3, 64))).max() <= 1e-5
    got = synthetic.make_mix(_raw(seed), 4, 32).numpy()
    assert np.abs(got - np.asarray(jit(j_mid.make_mix)(k, 4, 32))).max() <= 1e-5


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 64), 32), ((3, 4, 4, 96), 32),
                                          ((2, 4, 4, 64), 8)])
@pytest.mark.parametrize("swish,film", [(False, False), (True, False), (True, True)])
def test_group_norm_parameter_gradients_match_jax_grad(shape, groups, swish, film):
    """GroupNormFunction's gradients of x, scale, bias, film_scale and
    film_shift (plain mode) against jax.grad of the JAX XLA group_norm,
    fp32, within 1e-5 of each gradient's largest value."""
    B, H, W, C = shape
    rs = np.random.RandomState(sum(shape) + 2 * swish + film)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    g, b = rs.randn(C).astype(np.float32), rs.randn(C).astype(np.float32)
    leaves = [x, g, b]
    if film:
        leaves += [rs.randn(B, C).astype(np.float32) * 0.3 for _ in range(2)]

    def f(*a):
        kw = dict(film_scale=a[3], film_shift=a[4]) if film else {}
        y = j_group_norm(a[0], a[1], a[2], num_groups=groups, eps=1e-5, swish=swish,
                         force="xla", **kw)
        return jnp.sum(y * dy)

    want = jax.grad(f, argnums=tuple(range(len(leaves))))(*map(jnp.asarray, leaves))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in leaves]
    pad = [] if film else [None, None]
    GroupNormFunction.apply(*ts, *pad, groups, 1e-5, swish, "torch").backward(
        torch.from_numpy(dy))
    for t, w in zip(ts, want):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("B,T,C", [(2, 17, 256), (2, 16, 512), (1, 9, 512)])
def test_attention_backward_at_the_ddpm_heads_matches_jax_grad(B, T, C):
    """The plain attention backward at the head dimensions the training
    path adds (C = 256, 512) against jax.grad of _xla_attention, fp32."""
    rs = np.random.RandomState(B * T + C)
    q, k, v, do = (rs.randn(B, T, C).astype(np.float32) for _ in range(4))
    scale = C ** -0.5
    want = jax.grad(lambda a, b_, c: jnp.sum(_xla_attention(a, b_, c, scale) * do),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _torch_attention_backward(tq, tk, tv, _torch_attention(tq, tk, tv, scale),
                                    torch.from_numpy(do), scale)
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """flax's init of the JAX toy model (compiled once a module run)."""
    model = emit.jax_model(name)
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                               jnp.zeros((1,)))


@pytest.mark.parametrize("name", ["ddpm", "adm", "clf"])
def test_one_train_step_matches_jax(name):
    """From params_from_flax of JAX's init and PRNGKey(1), one step of the
    port's trainer against the JAX trainers' jax.value_and_grad step
    (tools/emit_torch_train_golden.py `jax_steps`), batch 4, fp32: the loss
    within 1e-5 relative, every leaf's gradient within 1e-4 of its norm (a
    leaf whose gradient is 0 in exact arithmetic, such as a key bias under
    the softmax, within 1e-7 of the largest leaf's norm), and the updated
    parameters: Adam's first update is g / (|g| + eps) lr, +-lr wherever
    the gradient is well above eps, so a gradient of rounding noise may
    flip it (at most 2 lr apart); where |g| > 1e-6, within 1e-6 of
    optax's."""
    params = _jax_init(name)
    losses, grads, new_params, _ = emit.jax_steps(name, params, 1, 4)
    mod = _port_trainer(name)
    model = mod.build_model("cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    spec = mod.make_spec(1, 4, emit.MODELS[name][3])
    abar = torch.as_tensor(spec.abar)
    opt = training.make_optimizer(model, spec.lr)
    key = threefry.split(threefry.as_key(_raw(1)))[1]
    loss, _ = training.train_step(model.train(), opt, key, spec, 0, abar)
    assert abs(float(loss) - losses[0]) <= 1e-5 * abs(losses[0])
    want = {k: v.numpy() for k, v in params_from_flax(grads).items()}
    norms = {k: float(np.linalg.norm(v)) for k, v in want.items()}
    floor = 1e-7 * max(norms.values())
    for n, p in model.named_parameters():
        err = float(np.abs(p.grad.numpy() - want[n]).max())
        assert err <= 1e-4 * norms[n] + floor, n
    after = {k: v.numpy() for k, v in params_from_flax(new_params).items()}
    for n, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - after[n])
        assert diff.max() <= 2 * spec.lr * (1 + 1e-3), n  # at most a flipped +-lr
        assert diff[np.abs(want[n]) > 1e-6].max(initial=0.0) <= 1e-6, n


@pytest.mark.parametrize("name", ["ddpm", "adm", "clf"])
def test_train_golden_protocol_on_the_cpu(name):
    """chip_smoke.py phase 24 (b) on the CPU: 3 Adam steps from the
    committed weights against tests/fixtures/toy_train_golden.json within
    the card's gates (chip_smoke.check_train_golden)."""
    import chip_smoke

    golden = json.loads(chip_smoke.TRAIN_GOLDEN.read_text())
    got = chip_smoke.train_golden_run(name, "cpu", golden)
    out = chip_smoke.check_train_golden(name, got, golden)
    assert out["loss_rel"] <= 1e-4 and out["t_sum"] == golden[name]["first_batch"]["t_sum"]


@pytest.mark.parametrize("steps", [1, 7, 100])
def test_cosine_schedule_is_optax(steps):
    ours = training.cosine_decay(2e-4, steps, 0.1)
    theirs = optax.cosine_decay_schedule(2e-4, steps, alpha=0.1)
    for count in sorted({0, 1, steps - 1, steps, steps + 3}):
        assert ours(count) == float(np.float32(theirs(count))), count


@pytest.mark.parametrize("cosine", [False, True])
def test_adam_steps_follow_optax(cosine):
    """torch.optim.Adam at the learning rate set before each step from the
    step count (the first update at schedule(0)) against optax.adam over
    the schedule, 5 steps of fixed gradients, fp32: within 1e-6 (a few
    float32 ulps of the weights), where a schedule read one count late
    would move them 1e-4 apart."""
    rs = np.random.RandomState(3)
    w0 = rs.randn(64).astype(np.float32)
    grads = [rs.randn(64).astype(np.float32) * 10.0 ** -i for i in range(5)]
    spec = training.TrainSpec(kind="eps", res=8, batch=1, lr=1e-2, steps=5, data=None,
                              abar=np.ones(1, np.float32), cosine=cosine)
    lr = optax.cosine_decay_schedule(1e-2, 5, alpha=0.1) if cosine else 1e-2
    opt = optax.adam(lr)
    w, state = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = training.make_optimizer(torch.nn.ParameterList([p]), spec.lr)
    for i, g in enumerate(grads):
        upd, state = opt.update(jnp.asarray(g), state)
        w = optax.apply_updates(w, upd)
        for group in topt.param_groups:
            group["lr"] = spec.lr_at(i)
        p.grad = torch.from_numpy(g)
        topt.step()
        assert np.abs(p.detach().numpy() - np.asarray(w)).max() <= 1e-6, i  # float32 ulps


@pytest.mark.parametrize("name", ["ddpm", "adm", "clf"])
def test_fresh_initialisation_follows_flax_by_distribution(name):
    """Per leaf, the port's fresh weights (unet_adm.init_like_flax) against
    flax's init of the JAX model: the same leaves, zeros where flax has
    zeros, ones where it has ones, and elsewhere the mean within 4
    standard errors and the standard deviation within 10% (leaves of 1024
    values or more) or 40%."""
    want = {k: v.numpy() for k, v in params_from_flax(_jax_init(name)).items()}
    got = {k: v.detach().numpy() for k, v in _port_trainer(name).build_model("cpu")
           .state_dict().items()}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if not w.std():
            assert np.array_equal(g, w), k
            continue
        sd = w.std()
        assert abs(g.mean() - w.mean()) <= 4 * sd * (2.0 / w.size) ** 0.5, k
        assert abs(g.std() / sd - 1) <= (0.1 if w.size >= 1024 else 0.4), k


def test_snapshot_resume_is_bit_equal(tmp_path):
    """A run killed after its first snapshot and run again resumes from it
    (model, Adam state, step, key) and ends with the uninterrupted run's
    weights bit for bit; the snapshot is gone once the run completes."""
    mod = _port_trainer("ddpm")

    def run(out, log):
        torch.manual_seed(0)
        model = mod.build_model("cpu")
        training.train(model, mod.make_spec(3, 2, 2e-4), name="resume", out=out,
                       log_every=1, snapshot_every=1, log=log)
        return model

    whole = run(tmp_path / "a", lambda s: None)

    def die_at_step_2(msg):
        if "step 2" in msg:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        run(tmp_path / "b", die_at_step_2)
    assert len(list((tmp_path / "b").glob("snapshot_resume_*.pt"))) == 1
    seen = []
    resumed = run(tmp_path / "b", seen.append)
    assert any("resumed" in m and "at step 2" in m for m in seen)
    for (n, a), b in zip(whole.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), n
    assert not list((tmp_path / "b").glob("snapshot_*"))


def test_export_round_trips_through_the_checkpoint_loader(tmp_path):
    """training.export writes the reference keys in fp16 and
    data/checkpoints.load_checkpoint reads them into a fresh model (upcast,
    strict): the trained weights rounded to fp16."""
    mod = _port_trainer("adm")
    model = mod.build_model("cpu")
    training.train(model, mod.make_spec(1, 2, 2e-4), name="export", out=tmp_path,
                   log=lambda s: None)
    path = training.export(model, tmp_path, "toy_adm32", {"steps": 1})
    assert all(v.dtype == torch.float16 for v in torch.load(path, weights_only=True).values())
    fresh = mod.build_model("cpu", seed=5)
    load_checkpoint(fresh, path)
    for (n, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a.half().float(), b), n
    assert json.loads((tmp_path / "toy_adm32.json").read_text()) == {"steps": 1}


@pytest.mark.parametrize("tool,name,extra", [
    ("train_toy_golden_torch", "toy_ddpm32", ["toy32.yml"]),
    ("train_toy_classifier_golden_torch", "toy_clf32", [])])
def test_trainers_write_under_out_only(tmp_path, tool, name, extra):
    """A trainer's run writes its weights, metadata and config text under
    --out and touches no committed fixture or config."""
    import importlib

    watched = [REPO / "tests/fixtures" / f"{name}.pt", REPO / "tests/fixtures" / f"{name}.json",
               REPO / "configs/toy32.yml"]
    before = {p: p.stat().st_mtime_ns for p in watched if p.exists()}
    importlib.import_module(tool).main(["--steps", "1", "--batch", "2", "--device", "cpu",
                                        "--out", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([f"{name}.pt", f"{name}.json"]
                                                                + extra)
    assert {p: p.stat().st_mtime_ns for p in before} == before
