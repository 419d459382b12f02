"""The port's serving export (ddnm_tpu_torch/serving.py) on the CPU.

The six round trips of the JAX suite (tests/test_aux_subsystems.py
`test_serving_export_*`) on the port: the same toy models, the same
inputs and the same raw keys, each port artifact held to the JAX
package's own artifact (steps within STEP_TOL, trajectories within
TRAJ_TOL) and to the port's eager sampler with the same threefry noise
bit for bit (the eager model routed through the ddnm:: ops, whose CPU
implementations the artifact runs; the default eager route, whose plain
GroupNorm is one formula where the ops' are two, within
EAGER_DEFAULT_TOL). The toy DDPM UNet carries the JAX initialisation
across (`params_from_flax`); the posterior trajectory runs the trained
toy32 ADM (tests/fixtures/toy_adm32.pt) on both sides, whose JAX artifact
output is the committed golden (tests/fixtures/toy_export_golden.json,
tools/emit_torch_export_golden.py), as chip_smoke.py phase 23 holds the
card to it. Then: the three kernel ops are the artifact's nodes, one per
eager kernel launch, with no decomposition in their place; an artifact
saved to a file runs in a fresh process that imports ddnm_tpu_torch and
not jax; `load_state_dict` swaps the trained toy DDPM weights into the
artifact exported on the JAX initialisation, which then reproduces the
golden; the refusals.

The trajectories run the golden's short schedules (a travel step, an undo
step): a trajectory's export traces every step, a few seconds each here,
and each artifact is exported and loaded once for the module.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ddnm_tpu_torch import serving
from ddnm_tpu_torch.models import DDPMUNet, params_from_flax
from ddnm_tpu_torch.models.unet_ddpm import set_op_force
from ddnm_tpu_torch.operators import build_functional_operator
from ddnm_tpu_torch.operators.functional import FunctionalOperator
from ddnm_tpu_torch.sampling import sample_posterior, sample_simplified
from ddnm_tpu_torch.sampling.ddnm import _simplified_update
from ddnm_tpu_torch.sampling.posterior import _posterior_update
from ddnm_tpu_torch.sampling.threefry import KeyNoise, normal
from tests._torch_port import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
STEP_TOL = 1e-4
TRAJ_TOL = 1e-3
# the default eager route against the ops' route: one step, and a
# trajectory, where the steps carry the rounding on
EAGER_DEFAULT_TOL = {"step": 1e-5, "trajectory": TRAJ_TOL}
DDPM_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,), resolution=32)
SCALARS = (412.0, 1.8, 1.5, 1.0, 0.02, 0.97, 1e-4, 1.0)  # the JAX posterior step test's


def key_data(*seeds) -> np.ndarray:
    keys = [np.array(jax.random.key_data(jax.random.PRNGKey(s)), np.uint32) for s in seeds]
    return keys[0] if len(keys) == 1 else np.stack(keys)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def tkey(key: np.ndarray) -> torch.Tensor:
    """JAX key data (uint32 words) as the artifacts take it: int64."""
    return torch.from_numpy(key.astype(np.int64))


def f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


class WithZeroVariance(torch.nn.Module):
    """A DDPM UNet's eps with zero variance channels appended: the JAX
    posterior tests' model_fn."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, tt):
        eps = self.model(x, tt)
        return torch.cat([eps, torch.zeros_like(eps)], dim=-1)


@pytest.fixture(scope="module")
def ddpm():
    """The JAX test's toy DDPM UNet (JAX init from PRNGKey(0)) on both
    sides, and its input x."""
    from ddnm_tpu.models.unet_ddpm import DDPMUNet as JaxDDPM

    jmodel = JaxDDPM(**DDPM_KW)
    rng = jax.random.PRNGKey(0)
    x = jax.random.normal(rng, (2, 32, 32, 3))
    params = jax.jit(jmodel.init)(rng, x, jnp.zeros((2,)))
    port = DDPMUNet(**DDPM_KW).eval()
    port.load_state_dict(params_from_flax(params), strict=True)
    return dict(fn=lambda p, xx, tt: jmodel.apply(p, xx, tt), params=params, port=port,
                x=np.asarray(x))


def eager_via_ops(model):
    """Route `model`'s GroupNorms and attentions through the ddnm:: ops (the
    artifact's nodes; their CPU implementations are the kernels' plain
    versions); returns a callable that restores the default route."""
    set_op_force(model, "op")
    return lambda: set_op_force(model, None)


# ------------------------------------------------------------------ steps


@pytest.fixture(scope="module")
def simplified_step(ddpm, tmp_path_factory):
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4)
    x = t(ddpm["x"])
    y = op.A(x)
    path = tmp_path_factory.mktemp("step") / "step.pt2"
    blob = serving.export_simplified_step(ddpm["port"], op, batch=2, image_size=32,
                                          y_shape=tuple(y.shape), path=path, device="cpu")
    return dict(blob=blob, path=path, op=op, x=x, y=y, call=serving.load_exported(path))


def test_simplified_step_roundtrip(ddpm, simplified_step):
    """tests/test_aux_subsystems.py:199 on the port."""
    from ddnm_tpu.operators import build_functional_operator as jax_op
    from ddnm_tpu.serving import export_simplified_step, load_exported

    s = simplified_step
    assert s["path"].stat().st_size == len(s["blob"]) > 0
    call = s["call"]
    key = key_data(7)
    args = (s["x"], s["y"], tkey(key), f32(50.0), f32(0.9), f32(0.95))
    with torch.no_grad():
        out, x0 = call(*args)
    assert out.shape == s["x"].shape and torch.isfinite(out).all()

    jop = jax_op("sr_averagepooling", image_size=32, deg_scale=4)
    jcall = load_exported(export_simplified_step(
        ddpm["fn"], ddpm["params"], jop, batch=2, image_size=32, y_shape=tuple(s["y"].shape)))
    jout, jx0 = jcall(ddpm["params"], ddpm["x"], s["y"].numpy(), key, 50.0, 0.9, 0.95)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=0, atol=STEP_TOL)

    restore = eager_via_ops(ddpm["port"])
    try:
        with torch.no_grad():
            et = ddpm["port"](s["x"], f32(50.0).expand(2))
            ref, ref0 = _simplified_update(s["op"], 0.85, 0.0, s["x"], s["y"], et, f32(0.9),
                                           f32(0.95), normal(tkey(key), s["x"].shape))
    finally:
        restore()
    assert torch.equal(out, ref) and torch.equal(x0, ref0)
    with torch.no_grad():
        default = serving._SimplifiedStep(ddpm["port"], s["op"], 0.85, 0.0)(*args)[0]
    torch.testing.assert_close(out, default, rtol=0, atol=EAGER_DEFAULT_TOL["step"])


def test_posterior_step_roundtrip(ddpm):
    """tests/test_aux_subsystems.py:316 on the port."""
    from ddnm_tpu.operators import build_functional_operator as jax_op
    from ddnm_tpu.serving import export_posterior_step, load_exported

    model = WithZeroVariance(ddpm["port"])
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4)
    x = t(ddpm["x"])
    apy = op.Ap(op.A(x))
    call = serving.load_exported(serving.export_posterior_step(model, op, batch=2,
                                                               image_size=32))
    key = key_data(7)
    with torch.no_grad():
        out, x0 = call(x, apy, tkey(key), *map(f32, SCALARS))
    assert out.shape == x.shape and torch.isfinite(out).all()

    def jfn(p, xx, tt):
        eps = ddpm["fn"](p, xx, tt)
        return jnp.concatenate([eps, jnp.zeros_like(eps)], axis=-1)

    jcall = load_exported(export_posterior_step(
        jfn, ddpm["params"], jax_op("sr_averagepooling", image_size=32, deg_scale=4), batch=2,
        image_size=32))
    jout, jx0 = jcall(ddpm["params"], ddpm["x"], apy.numpy(), key, *SCALARS)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=0, atol=STEP_TOL)

    restore = eager_via_ops(ddpm["port"])
    try:
        with torch.no_grad():
            tt = f32(SCALARS[0]).expand(2)
            s = dict(zip(("sqrt_recip", "sqrt_recipm1", "lam", "coef1", "coef2", "gamma"),
                         map(f32, SCALARS[1:7])))
            s.update(noise_scale=f32(SCALARS[7]) * torch.sqrt(torch.clamp(s["gamma"], min=0.0)),
                     op_ctx=None)
            ref, ref0 = _posterior_update(op, None, True, x, apy, None, None,
                                          normal(tkey(key), x.shape), model(x, tt), tt, s)
    finally:
        restore()
    assert torch.equal(out, ref) and torch.equal(x0, ref0)


def test_posterior_step_with_ctx():
    """tests/test_aux_subsystems.py:526 on the port: a context-parameterised
    (masked) operator, its (B, H, W, 1) context between apy and the key;
    held to the JAX artifact on the same inputs; and the refusal of
    with_ctx on an operator without A_ctx."""
    from ddnm_tpu.operators.functional import FunctionalOperator as JaxOperator
    from ddnm_tpu.serving import export_posterior_step, load_exported

    class Scaled(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.s = torch.nn.Parameter(torch.tensor(0.1))

        def forward(self, x, tt):
            return torch.cat([self.s * x, torch.zeros_like(x)], dim=-1)

    mask_ctx = lambda z, c: z * c
    op = FunctionalOperator("inpainting", lambda z: z, lambda z: z, mask_ctx, mask_ctx)
    call = serving.load_exported(serving.export_posterior_step(
        Scaled(), op, batch=1, image_size=16, with_ctx=True))
    rng = jax.random.PRNGKey(0)
    x = np.asarray(jax.random.normal(rng, (1, 16, 16, 3)))
    apy = 0.5 * x
    ctx = np.asarray((jax.random.uniform(rng, (1, 16, 16, 1)) > 0.5).astype(jnp.float32))
    key = key_data(7)
    scalars = (3.0, 1.2, 0.8, 1.0, 0.1, 0.9, 1e-4, 1.0)
    with torch.no_grad():
        out, x0 = call(t(x), t(apy), t(ctx), tkey(key), *map(f32, scalars))
    assert out.shape == (1, 16, 16, 3) and torch.isfinite(out).all()

    jop = JaxOperator("inpainting", lambda z: z, lambda z: z, mask_ctx, mask_ctx)
    params = {"s": jnp.float32(0.1)}
    jcall = load_exported(export_posterior_step(
        lambda p, xx, tt: jnp.concatenate([p["s"] * xx, jnp.zeros_like(xx)], axis=-1),
        params, jop, batch=1, image_size=16, with_ctx=True))
    jout, jx0 = jcall(params, x, apy, ctx, key, *scalars)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=0, atol=STEP_TOL)

    plain = FunctionalOperator("id", lambda z: z, lambda z: z)
    with pytest.raises(ValueError, match="with_ctx"):
        serving.export_posterior_step(Scaled(), plain, batch=1, image_size=16, with_ctx=True)


def test_cpu_built_artifact_moves_to_another_device(simplified_step):
    """tests/test_aux_subsystems.py:392 on the port: JAX builds a ("cpu",
    "tpu") artifact on a CPU host; the port's artifact built with CPU
    tensors is device-neutral. Every ddnm:: op has a CUDA kernel
    registered beside its CPU one (and no other implementation), and
    `load_exported(..., device=)` moves the whole program: on the meta
    device it runs end to end (every node has a meta form and no constant
    stays behind on the CPU), and moved to the CPU it gives the same bits."""
    from ddnm_tpu_torch.ops.library import OPS

    for name in OPS:
        for key, has in (("CPU", True), ("CUDA", True), ("Meta", True),
                         ("CompositeExplicitAutograd", False)):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key) == has, (name, key)
    s = simplified_step
    args = (s["x"], s["y"], tkey(key_data(7)), f32(50.0), f32(0.9), f32(0.95))
    meta = serving.load_exported(s["blob"], device="meta")
    out, x0 = meta(*(a.to("meta") for a in args))
    assert out.device.type == "meta" and out.shape == s["x"].shape == x0.shape
    with torch.no_grad():
        a = serving.load_exported(s["blob"], device="cpu")(*args)[0]
        b = s["call"](*args)[0]
    assert torch.equal(a, b)


# ------------------------------------------------------------ trajectories


@pytest.fixture(scope="module")
def simplified_traj(ddpm):
    """The serving golden's simplified case (a travel step, per-image keys)
    exported on the JAX-initialised toy DDPM, loaded once."""
    case = chip_smoke.export_golden_case("simplified", "cpu")
    case["fixture_state"] = case["model"].state_dict()
    case["model"] = ddpm["port"]
    case["blob"] = chip_smoke.export_case(case)
    case["call"] = serving.load_exported(case["blob"])
    return case


@pytest.fixture(scope="module")
def posterior_traj():
    """The serving golden's posterior case (paste + ctx, an undo step,
    per-image keys) exported on the trained toy32 ADM, loaded once."""
    case = chip_smoke.export_golden_case("posterior", "cpu")
    case["blob"] = chip_smoke.export_case(case)
    case["call"] = serving.load_exported(case["blob"])
    return case


def jax_simplified_trajectory(case: dict, ddpm: dict) -> np.ndarray:
    """The JAX package's own simplified trajectory artifact, on the case's
    schedule, inputs and keys with the JAX-initialised parameters."""
    from ddnm_tpu import schedules as jsch
    from ddnm_tpu import serving as jserving
    from ddnm_tpu.operators import build_functional_operator as jax_op
    from ddnm_tpu.sampling import build_schedule

    p = case["protocol"]
    sched = build_schedule(
        betas=jsch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                     num_diffusion_timesteps=1000),
        t_sampling=p["t_sampling"], travel_length=p["travel_length"],
        travel_repeat=p["travel_repeat"])
    np.testing.assert_array_equal(sched.is_travel, case["schedule"].is_travel)
    inputs = [a.numpy() for a in case["inputs"]]
    inputs[-1] = inputs[-1].astype(np.uint32)  # the key data as JAX takes it
    blob = jserving.export_simplified_trajectory(
        ddpm["fn"], ddpm["params"], jax_op(p["deg"], image_size=32, deg_scale=p["deg_scale"]),
        sched, batch=2, image_size=32, y_shape=inputs[1].shape, eta=p["eta"],
        sigma_y=p["sigma_y"], per_image_keys=True)
    x, _ = jserving.load_exported(blob)(ddpm["params"], *inputs)
    return np.asarray(x)


def eager_trajectory(kind: str, case: dict) -> tuple:
    """The port's eager sampler on the case's inputs with the same keys."""
    inputs, key = case["inputs"][:-1], KeyNoise(case["inputs"][-1])
    with torch.no_grad():
        if kind == "simplified":
            return sample_simplified(case["model"], *inputs, case["operator"],
                                     case["schedule"], key, eta=0.85)
        x, apy, paste_mask, paste_content, ctx = inputs
        return sample_posterior(case["model"], x, apy, case["operator"], case["schedule"], key,
                                paste_mask=paste_mask, paste_content=paste_content, op_ctx=ctx)


@pytest.mark.parametrize("kind", ["simplified", "posterior"])
def test_trajectory_roundtrip(kind, request, ddpm):
    """tests/test_aux_subsystems.py:247 (simplified, a travel step, per-image
    keys) and :427 (posterior, paste + ctx + an undo step, per-image keys)
    on the port: the artifact against the JAX artifact within TRAJ_TOL
    (the simplified one exported here by the JAX package, the posterior
    one's output the committed golden), and bit for bit against the port's
    eager sampler with the same keys."""
    case = request.getfixturevalue(f"{kind}_traj")
    with torch.no_grad():
        x, x0 = case["call"](*case["inputs"])
    assert x.shape == case["inputs"][0].shape and torch.isfinite(x).all()
    want = (jax_simplified_trajectory(case, ddpm) if kind == "simplified"
            else case["golden"])
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=TRAJ_TOL)

    restore = eager_via_ops(case["model"])
    try:
        ref, ref0 = eager_trajectory(kind, case)
    finally:
        restore()
    assert torch.equal(x, ref) and torch.equal(x0, ref0)
    default, _ = eager_trajectory(kind, case)
    torch.testing.assert_close(x, default, rtol=0, atol=EAGER_DEFAULT_TOL["trajectory"])


def test_posterior_trajectory_refuses_ctx_without_a_ctx_operator(posterior_traj):
    plain = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4)
    with pytest.raises(ValueError, match="A_ctx"):
        serving.export_posterior_trajectory(posterior_traj["model"], plain,
                                            posterior_traj["schedule"], batch=2,
                                            image_size=32, with_ctx=True)


def test_swapped_weights_reproduce_the_jax_golden(simplified_traj):
    """load_state_dict swaps the trained toy weights (toy_ddpm32.pt, under
    the step module's "model." prefix) into the artifact exported on the
    JAX initialisation: its final x is then the JAX artifact's of
    tests/fixtures/toy_export_golden.json within TRAJ_TOL (what phase
    23(b) holds the card to); the JAX initialisation swapped back gives
    the first bits again."""
    case = simplified_traj
    call = case["call"]
    mine = {k: v.clone() for k, v in call.state_dict().items()}
    with torch.no_grad():
        before, _ = call(*case["inputs"])
        call.load_state_dict({f"model.{k}": v for k, v in case["fixture_state"].items()})
        try:
            x, _ = call(*case["inputs"])
        finally:
            call.load_state_dict(mine)
        again, _ = call(*case["inputs"])
    np.testing.assert_allclose(x.numpy(), case["golden"], rtol=0, atol=TRAJ_TOL)
    assert not torch.equal(x, before) and torch.equal(again, before)


@pytest.mark.parametrize("kind", ["simplified_step", "simplified_traj", "posterior_traj"])
def test_kernels_are_nodes_of_the_artifact(kind, request):
    """The exported graph holds one ddnm::gn_stats_affine and one
    ddnm::gn_apply node for each GroupNorm and one ddnm::attention node for
    each attention of every model call (the eager call's kernel launches),
    and no aten GroupNorm, softmax or attention in their place."""
    art = request.getfixturevalue(kind)
    if kind == "simplified_step":
        model, calls, graph = request.getfixturevalue("ddpm")["port"], 1, art["call"].graph
    else:
        model, calls, graph = art["model"], art["calls"], art["call"].graph
    n_gn, n_attn = chip_smoke.module_counts(model)
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets.count("ddnm.gn_stats_affine.default") == n_gn * calls
    assert targets.count("ddnm.gn_apply.default") == n_gn * calls
    assert targets.count("ddnm.attention.default") == n_attn * calls
    assert n_gn and n_attn
    plain = [x for x in targets if any(w in x for w in ("group_norm", "softmax",
                                                         "scaled_dot_product", "batch_norm",
                                                         "layer_norm", "logsumexp"))]
    assert not plain, plain


def test_artifact_outlives_its_maker(simplified_step, tmp_path):
    """The saved step loads and runs in a fresh process that imports
    ddnm_tpu_torch (its ddnm:: ops) and not jax, with the same bits as in
    this process."""
    s = simplified_step
    args = (s["x"], s["y"], tkey(key_data(7)), f32(50.0), f32(0.9), f32(0.95))
    torch.save(args, tmp_path / "args.pt")
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from ddnm_tpu_torch.serving import load_exported
        torch.set_num_threads(1)
        call = load_exported({str(s["path"])!r})
        with torch.no_grad():
            out = call(*torch.load({str(tmp_path / "args.pt")!r}))
        torch.save(out, {str(tmp_path / "out.pt")!r})
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "ddnm_tpu")]
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = torch.load(tmp_path / "out.pt")
    with torch.no_grad():
        here = s["call"](*args)
    assert all(torch.equal(a, b) for a, b in zip(out, here))
