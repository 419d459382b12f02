"""The scan loop driver of the port (ddnm_tpu_torch/sampling/graphs.py and
the samplers' `loop`) on the CPU, at toy32.

  - the resolution table: auto / host / scan on one device, under a data
    mesh, under --sp (a CPU gloo grid, a gloo grid on a card) and with the
    encoder cache; unknown values raise (tests/test_torch_loop_drivers_parallel.py
    holds the scan driver over meshes and grids);
  - the port's loop="scan" against the JAX package's loop="scan" for the
    simplified sampler (time travel), SVD cs_walshhadamard and a noisy
    DDNM+ task, the multistep solver (simplified and posterior), the
    posterior sampler (paste mask and op_ctx) and the guided posterior
    (JAX's scan output in tests/fixtures/toy_adm32_guided_golden.json),
    under zero noise and under JAX's own key (threefry.KeyNoise): every
    trajectory within 1e-3 of JAX's, the gate of tests/test_torch_sampling.py
    and tests/test_torch_posterior.py (fp32 convolutions sum in other orders
    in the two frameworks, and a trajectory carries that);
  - "scan" through a stand-in graph (`StandInGraph`: the CPU has no CUDA
    graphs, so its capture runs the body once and each replay runs it
    again on the static buffers and noise slots) bit-equal to "host", with
    per-image generators and with a KeyNoise, a second call replaying with
    other inputs; the caller's generators and key afterwards as "host"
    leaves them;
  - no fallback: a capture that fails raises to the caller;
  - the launch table's arithmetic on a stand-in graph;
  - end to end: main_torch --loop scan and --loop host write byte-equal
    PNGs, one hq tile through hq_main_torch on auto, and a service with
    loop="scan" that answers with the new weights after swap_params;
  - on the card (marked cuda, skips here): a graphed toy32 trajectory
    bit-equal to the eager one, launches and noise state equal
    (chip_smoke.py phase 25 runs the same on every sampler).
"""

from __future__ import annotations

import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ddnm_tpu import schedules as jsch
from ddnm_tpu.operators import build_functional_operator as j_build_fop
from ddnm_tpu.operators import build_svd_operator as j_build_sop
from ddnm_tpu.sampling import build_schedule as j_build_schedule
from ddnm_tpu.sampling import posterior as jpost
from ddnm_tpu.sampling import sample_simplified as j_sample_simplified
from ddnm_tpu.sampling import sample_svd as j_sample_svd
from ddnm_tpu_torch import ops
from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch.models import classifier_guidance_fn
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.ops import _build
from ddnm_tpu_torch.parallel import make_mesh, sharded_sampler
from ddnm_tpu_torch.parallel.spatial import grid_sampler
from ddnm_tpu_torch.sampling import build_schedule, graphs, posterior
from ddnm_tpu_torch.sampling import sample_posterior, sample_simplified, sample_svd
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, draw_noise, image_generators
from ddnm_tpu_torch.sampling.threefry import KeyNoise, prng_key
from tests._golden import load_eval_images, toy_perm
from tests._golden_adm import ADM_TOY32
from tests._golden_adm import load_our_model as load_jax_adm
from tests._torch_port import (  # noqa: F401
    TIERS,
    StandInGraph,
    jax_model,
    one_torch_thread,
    port_model,
    x_T,
)

REPO = Path(__file__).resolve().parents[1]
TOY = TIERS["toy32"]
BETAS = jsch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                               num_diffusion_timesteps=1000).astype(np.float32)
JAX_TOL = 1e-3  # max |port - JAX| of a trajectory, as tests/test_torch_sampling.py
# a DDNM schedule with time travel: 6 steps, jumps of 2 repeated twice
SCHED = dict(betas=BETAS, t_sampling=6, travel_length=2, travel_repeat=2)
# a posterior jump schedule with undo steps
JUMP = dict(t_T=5, n_sample=1, jump_length=2, jump_n_sample=2)
N = 2


@pytest.fixture
def stand_in(monkeypatch):
    """CPU tensors go through graphs.run's graph path on StandInGraph."""
    graphs.clear_graphs()
    monkeypatch.setitem(graphs._BACKENDS, "cpu", StandInGraph)
    yield
    graphs.clear_graphs()


@pytest.fixture(scope="module")
def ddpm():
    return jax_model(TOY), port_model(TOY)


@pytest.fixture(scope="module")
def adm():
    return load_jax_adm(ADM_TOY32), chip_smoke.toy_adm("cpu")


def zero_noise(gens, shape):
    return torch.zeros(shape, dtype=torch.float32)


def j_zero(key, shape):
    return jnp.zeros(shape, jnp.float32)


def _gt(n=N, res=32):
    return np.ascontiguousarray(np.transpose(load_eval_images(n, TOY), (0, 2, 3, 1)))


def _post_tables(sigma_y=0.0):
    kw = dict(betas=sch.named_beta_schedule("linear", 1000), timestep_respacing="5",
              sigma_y=sigma_y, schedule_jump_params=JUMP)
    return posterior.build_posterior_tables(**kw), jpost.build_posterior_tables(**kw)


def _post_inputs():
    """x_T, A+y, paste mask and content, op_ctx (inpainting masks) of the
    posterior cases."""
    rng = np.random.default_rng(3)
    x_init = rng.standard_normal((N, 32, 32, 3)).astype(np.float32)
    masks = np.ones((N, 32, 32, 1), np.float32)
    masks[0, 8:20, 4:28] = 0.0
    masks[1, 14:30, 10:22] = 0.0
    paste = np.zeros((N, 32, 32, 1), np.float32)
    paste[:, :8] = 1.0
    content = rng.uniform(-1, 1, (N, 32, 32, 3)).astype(np.float32)
    return x_init, masks, paste, content


# ------------------------------------------------------------------ cases
# Each case runs the port's sampler with `loop` and a noise source `src`
# (`noise` "zero": per-image generators and the zero noise_fn; "gens":
# per-image generators drawing their own noise; "key": a KeyNoise), x_T
# moved by `shift` (a second call's other inputs), or (`jax_side`) the JAX
# package's sampler with loop="scan" under zero noise or PRNGKey(0).


def _simplified(models, loop, noise, src=None, shift=0.0, jax_side=False, solver="ddim"):
    (fn, params), model = models
    gt, xt = _gt(), x_T(N, 32) + np.float32(shift)
    if jax_side:
        jop = j_build_fop("sr_averagepooling", image_size=32, deg_scale=4.0)
        return j_sample_simplified(fn, jnp.asarray(xt), jop.A(jnp.asarray(gt)), jop,
                                   j_build_schedule(**SCHED), jax.random.PRNGKey(0),
                                   params=params, loop="scan", solver=solver, **_j_noise(noise))
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0)
    return sample_simplified(model, torch.from_numpy(xt), op.A(torch.from_numpy(gt)), op,
                             build_schedule(**SCHED), _src(noise, src), loop=loop,
                             solver=solver, **_noise_fn(noise))


def _multistep(models, loop, noise, src=None, shift=0.0, jax_side=False):
    return _simplified(models, loop, noise, src, shift, jax_side, solver="multistep")


def _svd(models, loop, noise, src=None, shift=0.0, jax_side=False, sigma_y=0.0,
         deg="cs_walshhadamard"):
    (fn, params), model = models
    gt, xt = _gt(), x_T(N, 32) + np.float32(shift)
    kw = dict(channels=3, image_size=32, deg_scale=0.25 if deg.startswith("cs") else 4.0,
              perm=toy_perm(32) if deg == "cs_walshhadamard" else None)
    y = np.ascontiguousarray(np.transpose(gt, (0, 3, 1, 2))).reshape(N, -1)
    if jax_side:
        jop = j_build_sop(deg, **kw)
        return j_sample_svd(fn, jnp.asarray(xt), jop.A(jnp.asarray(y)), jop,
                            j_build_schedule(**SCHED), jax.random.PRNGKey(0), sigma_y=sigma_y,
                            params=params, loop="scan", **_j_noise(noise))
    op = _memo(("svd", deg), lambda: build_svd_operator(deg, **kw))
    return sample_svd(model, torch.from_numpy(xt), op.A(torch.from_numpy(y)), op,
                      build_schedule(**SCHED), _src(noise, src), sigma_y=sigma_y, loop=loop,
                      **_noise_fn(noise))


def _svd_noisy(models, loop, noise, src=None, shift=0.0, jax_side=False):
    """DDNM+ (sigma_y > 0) on SVD 4x average-pooling SR."""
    return _svd(models, loop, noise, src, shift, jax_side, sigma_y=0.2,
                deg="sr_averagepooling")


def _posterior(models, loop, noise, src=None, shift=0.0, jax_side=False, solver="ddim",
               sigma_y=0.1):
    """Inpainting through op_ctx (a mask per image), a paste mask, sigma_y."""
    (fn, params), model = models
    x_init, masks, paste, content = _post_inputs()
    x_init = x_init + np.float32(shift)
    gt = _gt()
    tables, jtables = _post_tables(sigma_y)
    op = _memo("inpainting", lambda: build_functional_operator("inpainting", image_size=32,
                                                                mask=masks[0, ..., 0]))
    ctx = torch.from_numpy(masks)
    apy = op.Ap_ctx(op.A_ctx(torch.from_numpy(gt), ctx), ctx)
    if jax_side:
        jop = j_build_fop("inpainting", image_size=32, mask=masks[0, ..., 0])
        return jpost.sample_posterior(
            fn, jnp.asarray(x_init), jnp.asarray(apy.numpy()), jop, jtables,
            jax.random.PRNGKey(0), params=params, loop="scan", solver=solver,
            paste_mask=jnp.asarray(paste), paste_content=jnp.asarray(content),
            op_ctx=jnp.asarray(masks), **_j_noise(noise))
    return sample_posterior(
        lambda x, t: model(x, t), torch.from_numpy(x_init), apy, op, tables, _src(noise, src),
        paste_mask=torch.from_numpy(paste), paste_content=torch.from_numpy(content),
        op_ctx=ctx, loop=loop, solver=solver, **_noise_fn(noise))


def _posterior_multistep(models, loop, noise, src=None, shift=0.0, jax_side=False):
    return _posterior(models, loop, noise, src, shift, jax_side, solver="multistep",
                      sigma_y=0.0)


def _guided(models, loop, noise, src=None, shift=0.0, jax_side=False):
    """Guided posterior 4x SR with the toy32 classifier (class 2, scale 2).
    Under zero noise the guided golden's protocol (chip_smoke.
    guided_golden_run), whose JAX output the golden holds; returns (PSNR,
    x, per-image max |x - JAX|, s) then, else (x, x0_hat)."""
    _, model = models
    clf = _classifier()
    if noise == "zero" and shift == 0.0:
        return chip_smoke.guided_golden_run(
            model, clf, "cpu", sample=lambda *a, **k: sample_posterior(*a, loop=loop, **k))
    tables, _ = _post_tables(0.0)
    x_init = _post_inputs()[0] + np.float32(shift)
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0)
    apy = op.Ap(op.A(torch.from_numpy(_gt())))
    return sample_posterior(lambda x, t: model(x, t), torch.from_numpy(x_init), apy, op,
                            tables, _src(noise, src),
                            guidance_fn=classifier_guidance_fn(clf, 2, 2.0), loop=loop,
                            **_noise_fn(noise))


_MEMO = {}


def _memo(key, make):
    """One object per key for the module: an operator that closes over a
    tensor (a mask) or an SVD operator is part of a graph's key by
    identity, so a second call reuses the first's."""
    if key not in _MEMO:
        _MEMO[key] = make()
    return _MEMO[key]


def _classifier():
    return _memo("classifier", lambda: chip_smoke.toy_classifier("cpu"))


def _new_src(noise):
    if noise == "key":
        return KeyNoise(prng_key(0))
    return image_generators(7, range(N), STREAM_SAMPLE, "cpu")


def _src(noise, src):
    return _new_src(noise) if src is None else src


def _noise_fn(noise):
    return {"noise_fn": zero_noise} if noise == "zero" else {}


def _j_noise(noise):
    return {"noise_fn": j_zero} if noise == "zero" else {}


CASES = {"simplified": (_simplified, "ddpm"), "svd": (_svd, "ddpm"),
         "svd_noisy": (_svd_noisy, "ddpm"), "multistep": (_multistep, "ddpm"),
         "posterior": (_posterior, "adm"), "posterior_multistep": (_posterior_multistep, "adm"),
         "guided": (_guided, "adm")}


# ----------------------------------------------------------- resolution


@pytest.mark.parametrize("loop,where,want", [
    ("auto", "one device", "scan"), ("host", "one device", "host"),
    ("scan", "one device", "scan"),
    ("auto", "mesh", "scan"), ("host", "mesh", "host"), ("scan", "mesh", "scan"),
    ("auto", "sp", "scan"), ("host", "sp", "host"), ("scan", "sp", "scan"),
    ("auto", "sp gloo on a card", "host"), ("host", "sp gloo on a card", "host"),
    ("scan", "sp gloo on a card", ValueError),
    ("auto", "encoder_cache", "host"), ("host", "encoder_cache", "host"),
    ("scan", "encoder_cache", ValueError),
    ("vectorized", "one device", ValueError), ("vectorized", "mesh", ValueError),
])
def test_resolution_table(loop, where, want):
    """resolve_loop as JAX's `_resolve_loop` / `_resolve_posterior_loop` on a
    local backend: auto is scan on one device (CPU or card alike), under a
    data mesh and under --sp (grid_sampler's ranks; a CPU gloo grid); host
    on a gloo spatial group on a card, where scan raises naming gloo; host
    with the encoder cache, whose service refuses scan."""
    def resolve():
        if where == "mesh":
            return graphs.resolve_loop(loop, mesh=make_mesh(2, device="cpu"))
        if where.startswith("sp"):
            spatial = types.SimpleNamespace(size=2, rank=0, backend="gloo")
            grid = types.SimpleNamespace(dp=1, data=None, spatial=spatial, device=torch.device(
                "cuda", 0) if where.endswith("card") else torch.device("cpu"))
            return grid_sampler(lambda x, loop: graphs.resolve_loop(loop), grid)(
                torch.zeros(2), loop=loop)
        if where == "encoder_cache":
            return graphs.resolve_loop(loop, encoder_cache=3)
        return graphs.resolve_loop(loop)

    if isinstance(want, type):
        with pytest.raises(want, **({"match": "over gloo"} if where.endswith("card") else {})):
            resolve()
    else:
        assert resolve() == want


@pytest.mark.parametrize("device_kind", ["cpu", "cuda stand-in"])
@pytest.mark.parametrize("loop", ["auto", "host", "scan"])
def test_samplers_take_the_resolved_driver(ddpm, monkeypatch, device_kind, loop):
    """On the CPU the scan driver runs its body eagerly (no graph); where the
    device has graphs (a stand-in for the card) auto and scan capture one,
    host never does. An unknown loop raises."""
    graphs.clear_graphs()
    if device_kind != "cpu":
        monkeypatch.setitem(graphs._BACKENDS, "cpu", StandInGraph)
    try:
        _simplified(ddpm, loop, "zero")
        assert len(graphs.graph_stats()) == (loop != "host" and device_kind != "cpu")
        with pytest.raises(ValueError, match="loop must be"):
            _simplified(ddpm, "vectorized", "zero")
    finally:
        graphs.clear_graphs()


def test_scan_under_a_mesh_raises_and_auto_runs_host(ddpm):
    """A data mesh's shards run the driver asked for (scan and auto, as
    JAX's scan on sharded arrays; on the CPU the scan's body runs eagerly):
    every driver gives each image's unsharded host run, bit for bit. (The
    name is kept from when scan raised here.)"""
    (_, _), model = ddpm
    gt, xt = _gt(), x_T(N, 32)
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0)
    args = (model, torch.from_numpy(xt), op.A(torch.from_numpy(gt)), op,
            build_schedule(betas=BETAS, t_sampling=2))
    mesh = make_mesh(2, device="cpu")
    ref = torch.cat([sample_simplified(model, args[1][i:i + 1], args[2][i:i + 1], op, args[4],
                                       [None], noise_fn=zero_noise, loop="host")[0]
                     for i in range(N)])
    for loop in ("scan", "auto", "host"):
        x, _ = sharded_sampler(sample_simplified, mesh)(*args, _new_src("gens"),
                                                        noise_fn=zero_noise, loop=loop)
        assert torch.equal(x, ref), loop


# --------------------------------------------------------- port against JAX


@pytest.mark.parametrize("case,noise", [
    ("simplified", "zero"), ("simplified", "key"), ("svd", "key"), ("svd_noisy", "zero"),
    ("multistep", "key"), ("multistep", "zero"), ("posterior_multistep", "key"),
    ("posterior", "key"), ("posterior", "zero"), ("guided", "zero"),
])
def test_scan_matches_jax_scan(request, case, noise):
    fn, which = CASES[case]
    models = request.getfixturevalue(which)
    if case == "guided":
        # JAX's loop="scan" output is the golden's (tools/emit_toy_adm32_guided_golden.py)
        psnr, x, per_image, _ = fn(models, "scan", noise)
        assert torch.isfinite(x).all() and max(per_image) <= JAX_TOL, per_image
        return
    ours, _ = fn(models, "scan", noise)
    ref, _ = fn(models, "scan", noise, jax_side=True)
    assert ours.shape == tuple(ref.shape) and torch.isfinite(ours).all()
    assert float(np.abs(ours.numpy() - np.asarray(ref)).max()) <= JAX_TOL


# ----------------------------------------------------------- scan vs host


def _state(src):
    """The next draws of a noise source (a copy of its key, or four normals
    from each generator, which advances them)."""
    if isinstance(src, KeyNoise):
        return src.key.clone()
    return torch.stack([torch.randn(4, generator=g) for g in src])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("noise", ["gens", "key"])
def test_scan_bit_equal_to_host(request, stand_in, case, noise):
    """The graph path (static buffers, noise slots, replays) gives the host
    loop's bits and leaves the caller's generators or key where the host
    loop leaves them, at the capturing call and (with generators) at a
    replay with other inputs and fresh generators."""
    fn, which = CASES[case]
    models = request.getfixturevalue(which)
    shifts = (0.0, 0.25) if noise == "gens" else (0.0,)
    for shift in shifts:
        out, after = {}, {}
        for loop in ("host", "scan"):
            src = _new_src(noise)
            out[loop] = fn(models, loop, noise, src=src, shift=shift)
            after[loop] = _state(src)
        assert all(torch.equal(a, b) for a, b in zip(out["host"], out["scan"])), case
        assert torch.equal(after["host"], after["scan"])
        assert torch.isfinite(out["scan"][0]).all()
    (stats,) = graphs.graph_stats()
    assert stats["replays"] == len(shifts) and stats["sampler"].startswith(
        {"guided": "posterior", "multistep": "simplified_multistep",
         "svd_noisy": "svd"}.get(case, case))


def test_noise_state_matches_host_with_the_zero_noise_fn(ddpm, stand_in):
    """A noise_fn that ignores its generators leaves them untouched under
    both drivers."""
    after = {}
    for loop in ("host", "scan"):
        src = _new_src("gens")
        _simplified(ddpm, loop, "zero", src=src)
        after[loop] = _state(src)
    assert torch.equal(after["host"], after["scan"])
    assert torch.equal(after["scan"], _state(_new_src("gens")))


def test_a_module_setting_or_a_moved_parameter_makes_another_graph(ddpm, stand_in):
    """The key holds a module's settings and where its tensors live: after
    set_op_force (phase 4's plain run) or a parameter rebound, the sampler
    captures anew instead of replaying the other graph."""
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force

    model = port_model(TOY)
    models = (ddpm[0], model)
    _simplified(models, "scan", "zero")
    _simplified(models, "scan", "zero")
    assert [s["replays"] for s in graphs.graph_stats()] == [2]
    set_op_force(model, "torch")
    _simplified(models, "scan", "zero")
    assert len(graphs.graph_stats()) == 2
    with torch.no_grad():
        model.conv_in.weight.data = model.conv_in.weight.data.clone()
    _simplified(models, "scan", "zero")
    assert len(graphs.graph_stats()) == 3


# ------------------------------------------------------------- no fallback


def test_a_failed_capture_raises_and_nothing_runs_eagerly(ddpm, stand_in, monkeypatch):
    monkeypatch.setattr(StandInGraph, "fail_capture", True)
    calls = []
    (_, _), model = ddpm

    def counted(x, t):
        calls.append(1)
        return model(x, t)

    gt, xt = _gt(), x_T(N, 32)
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0)
    sched = build_schedule(**SCHED)
    with pytest.raises(RuntimeError, match="stand-in capture failed"):
        sample_simplified(counted, torch.from_numpy(xt), op.A(torch.from_numpy(gt)), op, sched,
                          [None] * N, noise_fn=zero_noise, loop="scan")
    # the warm-up ran (its model calls), nothing after it
    warm = graphs._warm_steps(sched.is_travel.tolist())
    assert len(calls) == sum(not sched.is_travel[i] for i in warm) > 0
    assert graphs.graph_stats() == [] and _build._capture is None and not graphs.capturing()


def test_noise_copied_onto_the_device_cannot_be_captured():
    """draw_noise copies noise drawn elsewhere onto the images' device,
    except inside a warm-up or capture, where it raises."""
    dev = torch.device("meta")
    assert draw_noise(zero_noise, [None], (1, 3), dev).device == dev
    graphs._LOCAL.capturing = True
    try:
        with pytest.raises(RuntimeError, match="loop='host'"):
            draw_noise(zero_noise, [None], (1, 3), dev)
        assert draw_noise(zero_noise, [None], (1, 3), torch.device("cpu")).shape == (1, 3)
    finally:
        graphs._LOCAL.capturing = False


# ------------------------------------------------------------ launch table


def test_launch_table_arithmetic(stand_in):
    """The warm-up's launches are not counted, the capture's make the
    table, each replay adds it to the wrappers' counters and under the
    current launch tag; an eager launch meanwhile counts as before."""
    table = ops._groupnorm.LAUNCHES

    def make_body():
        def body(x, *, noise, steps=None):
            for i in range(3) if steps is None else steps:
                _build.count_launch(table, "groupnorm_stats")
                if i == 2:
                    _build.count_launch(table, "groupnorm_apply")
                x = x + 1
            return (x,)

        return body

    ops.reset_launch_counts()
    x = torch.zeros(2)
    (y,) = graphs.run(("launches",), make_body, (x,), [None, None], [0])
    assert torch.equal(y, x + 3)
    counts = ops.launch_counts()
    assert (counts["groupnorm_stats"], counts["groupnorm_apply"]) == (3, 1)
    (stats,) = graphs.graph_stats()
    assert stats["launches_per_replay"] == {"groupnorm_stats": 3, "groupnorm_apply": 1}
    with _build.launch_tag(1):
        (y,) = graphs.run(("launches",), make_body, (x + 10,), [None, None], [0])
    assert torch.equal(y, x + 13)
    _build.count_launch(table, "groupnorm_stats")  # eager, outside any graph
    counts = ops.launch_counts()
    assert (counts["groupnorm_stats"], counts["groupnorm_apply"]) == (7, 2)
    assert ops.tagged_launch_counts()[1]["groupnorm_stats"] == 3
    assert graphs.graph_stats()[0]["replays"] == 2
    ops.reset_launch_counts()


def test_cache_is_bounded_and_cleared(stand_in, monkeypatch):
    """At most MAX_GRAPHS graphs, least recently used dropped first; a
    scope drops what it captured; clear_graphs drops the rest."""
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    make = lambda: (lambda x, *, noise, steps=None: (x * 2,))
    for n in (1, 2, 3):
        graphs.run(("bound",), make, (torch.zeros(n),), [None], [0])
    assert [s["shape"] for s in graphs.graph_stats()] == [(2,), (3,)]
    with graphs.scope():
        graphs.run(("bound",), make, (torch.zeros(4),), [None], [0])
        graphs.run(("bound",), make, (torch.zeros(3),), [None], [0])
    assert [s["shape"] for s in graphs.graph_stats()] == [(3,)]
    graphs.clear_graphs()
    assert graphs.graph_stats() == []


class PooledGraph(StandInGraph):
    """A stand-in whose capture reserves 40 bytes of a 100-byte budget,
    and runs out of memory while `tight` and any graph is kept."""

    budget = 100
    tight = False

    def capture(self, fn):
        if self.tight and graphs.graph_stats():
            raise torch.OutOfMemoryError("CUDA out of memory (stand-in)")
        out = super().capture(fn)
        self.pool_estimate = 40
        return out


def test_pool_budget_and_a_capture_out_of_memory(stand_in, monkeypatch):
    """The kept pools stay within the budget (least recently used dropped);
    a capture that runs out of memory drops the kept graphs and captures
    once more, and one that runs out with none kept raises."""
    monkeypatch.setitem(graphs._BACKENDS, "cpu", PooledGraph)
    make = lambda: (lambda x, *, noise, steps=None: (x * 2,))  # noqa: E731
    for n in (1, 2, 3):
        graphs.run(("pooled",), make, (torch.zeros(n),), [None], [0])
    assert [s["shape"] for s in graphs.graph_stats()] == [(2,), (3,)]
    monkeypatch.setattr(PooledGraph, "tight", True)
    (y,) = graphs.run(("pooled",), make, (torch.ones(4),), [None], [0])
    assert torch.equal(y, torch.full((4,), 2.0))
    assert [s["shape"] for s in graphs.graph_stats()] == [(4,)]
    monkeypatch.setattr(PooledGraph, "capture", lambda self, fn: (_ for _ in ()).throw(
        torch.OutOfMemoryError("CUDA out of memory (stand-in)")))
    graphs.clear_graphs()
    with pytest.raises(torch.OutOfMemoryError):
        graphs.run(("pooled",), make, (torch.zeros(5),), [None], [0])


# ------------------------------------------------------------- end to end


def _main_argv(out, loop):
    return ["--config", str(REPO / "configs/toy32.yml"), "--path_y", "toy32",
            "--exp", str(REPO / "exp"), "--deg", "sr_averagepooling", "--simplified",
            "--ckpt", str(TOY.fixture), "--t_sampling", "4", "--device", "cpu", "--ni",
            "--max_images", "2", "--loop", loop, "-i", str(out)]


def test_main_torch_scan_and_host_write_equal_pngs(tmp_path, stand_in):
    import main_torch

    for loop in ("host", "scan"):
        main_torch.main(_main_argv(tmp_path / loop, loop))
    pngs = sorted(p.name for p in (tmp_path / "host").glob("*_0.png"))
    assert pngs == ["0_0.png", "1_0.png"]
    for name in pngs:
        assert (tmp_path / "host" / name).read_bytes() == (tmp_path / "scan" / name).read_bytes()
    assert graphs.graph_stats() == []  # the run's scope dropped its graph


HQ_CONF = """name: toy32
image_size: 32
class_cond: false
learn_sigma: true
diffusion_steps: 1000
noise_schedule: linear
timestep_respacing: "5"
num_channels: 32
num_res_blocks: 1
num_heads: 4
num_head_channels: 32
attention_resolutions: "16"
channel_mult: "1,2"
use_scale_shift_norm: true
resblock_updown: true
use_fp16: false
clip_denoised: true
classifier_scale: 0.0
schedule_jump_params: {t_T: 5, n_sample: 1, jump_length: 2, jump_n_sample: 2}
model_path: null
"""


def test_hq_tile_runs_on_auto(tmp_path, monkeypatch):
    """One 32 px tile through hq_main_torch: the default loop captures the
    tile's trajectory (a stand-in graph here), equal to the host loop's."""
    import hq_main_torch
    from ddnm_tpu_torch.data.io import load_image, save_image

    (tmp_path / "toy.yml").write_text(HQ_CONF)
    img = load_image(sorted((REPO / "exp/datasets/toy32").glob("*.png"))[0])
    save_image(img.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3)), tmp_path / "y.png")
    argv = ["--config", str(tmp_path / "toy.yml"), "--path_y", str(tmp_path / "y.png"),
            "--resize_y", "--deg", "sr_averagepooling", "--scale", "4", "--ckpt",
            str(ADM_TOY32.fixture), "--device", "cpu"]
    eager = hq_main_torch.main(argv + ["-i", str(tmp_path / "eager")])
    captured = []
    monkeypatch.setitem(graphs._BACKENDS, "cpu", StandInGraph)
    real_run = graphs.run
    monkeypatch.setattr(graphs, "run", lambda *a, **k: captured.append(a[0][0]) or real_run(*a, **k))
    auto = hq_main_torch.main(argv + ["-i", str(tmp_path / "auto")])
    assert captured == ["posterior"] and auto["stats"]["tiles"] == 1
    assert np.array_equal(auto["final"], eager["final"])
    assert graphs.graph_stats() == []


def test_service_answers_after_swap_params_with_the_new_weights(ddpm, stand_in):
    """A service on loop="scan" replays one graph for both groups, and the
    second reads the weights swap_params copied in."""
    from ddnm_tpu_torch.server import RestorationService

    (_, _), model = ddpm
    sched = build_schedule(betas=BETAS, t_sampling=3)
    ops_ = {"sr_averagepooling": build_functional_operator("sr_averagepooling",
                                                           image_size=32, deg_scale=4.0)}
    served = port_model(TOY)
    svc = RestorationService(lambda p, x, t: p(x, t), served, sched, ops_, image_size=32,
                             max_batch=2, loop="scan")
    host = RestorationService(lambda p, x, t: p(x, t), port_model(TOY), sched, ops_,
                              image_size=32, max_batch=2, loop="host")
    img = (_gt(1) + 1.0) / 2.0
    before = svc.restore(img, "sr_averagepooling", [0], input_kind="gt")
    assert np.array_equal(before, host.restore(img, "sr_averagepooling", [0], input_kind="gt"))
    new = port_model(TOY)
    with torch.no_grad():
        for p in new.parameters():
            p.mul_(0.9)
    svc.swap_params(new)
    host.swap_params(new)
    after = svc.restore(img, "sr_averagepooling", [0], input_kind="gt")
    assert not np.array_equal(after, before)
    assert np.array_equal(after, host.restore(img, "sr_averagepooling", [0], input_kind="gt"))
    (stats,) = graphs.graph_stats()
    assert stats["replays"] == 2


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_graphed_toy32_trajectory_bit_equal_to_eager_on_the_card():
    """On a card: the toy32 simplified trajectory (time travel, per-image
    generators) captured as a CUDA graph gives the eager loop's bits, its
    launches and its generators' state, at the capture and at a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    model = port_model(TOY).cuda()
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0)
    gt = torch.from_numpy(_gt()).cuda()
    sched = build_schedule(**SCHED)
    graphs.clear_graphs()
    try:
        for shift in (0.0, 0.5):
            xt = torch.from_numpy(x_T(N, 32)).cuda() + shift
            runs = {}
            for loop in ("host", "scan"):
                gens = image_generators(7, range(N), STREAM_SAMPLE, "cuda")
                ops.reset_launch_counts()
                x, _ = sample_simplified(model, xt, op.A(gt), op, sched, gens, loop=loop)
                runs[loop] = (x, ops.launch_counts(),
                              torch.stack([torch.randn(4, generator=g, device="cuda")
                                           for g in gens]))
            assert torch.equal(runs["host"][0], runs["scan"][0])
            assert runs["host"][1] == runs["scan"][1]
            assert torch.equal(runs["host"][2], runs["scan"][2])
    finally:
        graphs.clear_graphs()
