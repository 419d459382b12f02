"""Classifier guidance under spatial partitioning in the port (the
gradients of parallel/halo.py, parallel/spatial.py, ops.ShardedGroupNormFunction
and attention(spatial=) in models/nn.py; the sharded ADMClassifier) on the
CPU, against the JAX package, whose partitioner differentiates through the
same exchanges (ddnm_tpu/parallel/spatial.py).

In one process, no process group, each arithmetic part on simulated
shards: the halo backward (each shard's gradient of its padded map split
into its own rows' and its halo rows', the halo rows' added to their
senders' edge rows) against the unsharded 3x3 convolution's input
gradient for the three halo kinds; the GroupNorm backward's partial sums
added in rank order and folded against jax.vjp of the JAX GroupNorm on the
whole map; the attention backward of a shard's queries against every key
(its dq rows, and the shards' dK / dV partials added in rank order)
against jax.vjp of the JAX attention. All at sp 2 and 4.

One group of 2 gloo processes on 127.0.0.1
(tests/_torch_spatial_guidance_worker.py), spawned once for the file while
this process computes JAX's references with x sharded over
make_mesh_2d(1, 2) on the virtual CPU mesh: the trained toy32
classifier's guidance gradient (through Grid.wrap, and through
classifier_guidance_from_params(spatial=) with per-example labels), a
tiny random classifier of each of the four pools, and the guided toy32
golden's trajectory (against the JAX output the golden records); the
ranks bit-equal.

Then hq_main_torch.py --sp 2 on a guided copy of configs/hq/smoke.yml as
two ranks against its own --sp 1 run.

Gates: the halo 1e-6 relative and the GroupNorm and attention gradients 1e-5
relative (fp32; tests/test_torch_backward.py's gate against jax.vjp); the
guidance gradients 1e-4 relative (tests/test_torch_guidance.py's gate:
the shards' sums add in another order than one device's, and the gradient
passes back through every norm and attention); the trajectory per image
1e-3 and its PSNR within 0.01 dB of the JAX package's
(tests/test_torch_guidance.py::test_guided_golden's); the CLI within 1
uint8 level (the port's CPU gate between two runs).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

import chip_smoke
from ddnm_tpu.models.unet_adm import ADMClassifier as JADMClassifier
from ddnm_tpu.models.unet_adm import classifier_guidance_fn as j_guidance_fn
from ddnm_tpu.models.unet_adm import classifier_guidance_from_params as j_guidance_from_params
from ddnm_tpu.ops import group_norm as j_group_norm
from ddnm_tpu.ops.attention import _xla_attention
from ddnm_tpu.parallel import make_mesh_2d as j_make_mesh_2d
from ddnm_tpu.parallel import replicate as j_replicate
from ddnm_tpu.parallel import shard_tiles as j_shard_tiles
from ddnm_tpu_torch.models import ADMClassifier, classifier_guidance_fn, params_from_flax
from ddnm_tpu_torch.ops.attention import _torch_attention, _torch_attn_bwd_dkdv, _torch_attn_bwd_dq
from ddnm_tpu_torch.ops.groupnorm import (
    _torch_affine_from_sums,
    _torch_bwd_dx,
    _torch_bwd_finalize,
    _torch_bwd_partial,
    _torch_stats_partial,
)
from ddnm_tpu_torch.parallel import halo
from ddnm_tpu_torch.parallel.spatial import Grid, SpatialGroup
from ddnm_tpu_torch.parallel.spatial import _rank_order_sum as _rank_sum
from tests._golden_adm import ADM_TOY32, GUIDED_CLASS, load_our_classifier
from tests._torch_port import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_spatial_guidance_worker import POOLS, TOY_ARCH
from tests.test_torch_spatial import CONV_KINDS, _env, _free_port

REPO = Path(__file__).resolve().parents[1]
WORLD = 2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ in one process


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kind", sorted(CONV_KINDS))
def test_halo_backward_gives_the_unsharded_input_gradient(kind, sp):
    """Each row block's gradient of its padded map (halo rows from its
    neighbours, zeros at the image's edges), with every block's halo-row
    gradients returned to the blocks that sent those rows, gives its rows
    of the unsharded convolution's input gradient: no halo gradient
    dropped, none counted twice."""
    stride, padding, own_pad = CONV_KINDS[kind]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 8, 3, 3)).astype(np.float32))
    x_full = x.clone().requires_grad_(True)
    out = F.conv2d(F.pad(x_full, own_pad) if own_pad else x_full, w, stride=stride,
                   padding=padding)
    gout = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32))
    (want,) = torch.autograd.grad(out, x_full, gout)
    above, below = halo.rows_needed(stride, padding)
    blocks = list(x.chunk(sp, dim=2))
    gouts = list(gout.chunk(sp, dim=2))
    parts = [halo.edge_rows(blk, above, below) for blk in blocks]
    owns, sents = [], []
    for r, blk in enumerate(blocks):
        up, down = halo.neighbour_rows(parts, r, above, below)
        cols = own_pad[:2] if own_pad else (0, 0)  # the DDPM's pad: its columns
        padded = halo.apply(F.pad(blk, cols), F.pad(up, cols), F.pad(down, cols))
        padded.requires_grad_(True)
        o = F.conv2d(padded, w, stride=stride, padding=(0, padding))
        (g,) = torch.autograd.grad(o, padded, gouts[r])
        own, sent = halo.halo_grads(g[..., :blk.shape[3]], above, below)
        owns.append(own)
        sents.append(sent)
    got = torch.cat([halo.add_sent_grads(own, sents, r, above, below)
                     for r, own in enumerate(owns)], dim=2)
    assert _rel(got.numpy(), want.numpy()) <= 1e-6  # sums of 3 x 3 x 8 terms in another order


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("swish,film", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_partial_groupnorm_backward_gives_jax_whole_map_gradient(swish, film, sp):
    """The row blocks' partial sums of x, x^2, dy' and dy' x (dy' through
    the SiLU' at the whole map's affine) added in rank order and folded over
    the whole map's pixels, then each block's dx: the rows of jax.vjp of
    ddnm_tpu.ops.group_norm on the whole map, fp32."""
    B, H, W, C, G = 2, 16, 8, 64, 32
    rs = np.random.RandomState(11 + 2 * swish + film)
    x = (rs.randn(B, H, W, C) * 2 + 0.5).astype(np.float32)
    dy = rs.randn(B, H, W, C).astype(np.float32)
    g, b = rs.randn(C).astype(np.float32), rs.randn(C).astype(np.float32)
    fs = ft = None
    if film:
        fs, ft = (rs.randn(B, C).astype(np.float32) * 0.3 for _ in range(2))
    kw = {} if fs is None else dict(film_scale=jnp.asarray(fs), film_shift=jnp.asarray(ft))
    _, vjp = jax.vjp(lambda z: j_group_norm(z, jnp.asarray(g), jnp.asarray(b), num_groups=G,
                                            eps=1e-5, swish=swish, force="xla", **kw),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    tt = lambda a: None if a is None else torch.from_numpy(a)
    xs, dys = tt(x).chunk(sp, dim=1), tt(dy).chunk(sp, dim=1)
    a, b_ = _torch_affine_from_sums(_rank_sum([_torch_stats_partial(xr) for xr in xs]), H * W,
                                    tt(g), tt(b), G, 1e-5, tt(fs), tt(ft))
    sums = _rank_sum([_torch_bwd_partial(xr, dr, swish, a, b_) for xr, dr in zip(xs, dys)])
    assert sums.shape == (4, B, C) and sums.dtype == torch.float32
    coef = _torch_bwd_finalize(sums, H * W, tt(g), G, 1e-5, tt(fs))
    got = torch.cat([_torch_bwd_dx(xr, dr, coef, swish, a, b_) for xr, dr in zip(xs, dys)],
                    dim=1)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("sp", [2, 4])
def test_attention_backward_of_shard_queries_gives_jax_gradient(sp):
    """A shard's queries against every key: its dq rows are those rows of
    jax.vjp of the JAX attention on the whole sequence, and the shards' dK
    and dV partials added in rank order are the whole dK and dV (no factor
    of sp), fp32."""
    rs = np.random.RandomState(sp)
    q, k, v, do = (rs.randn(3, 64, 32).astype(np.float32) for _ in range(4))
    scale = 32 ** -0.5
    _, vjp = jax.vjp(lambda a, b_, c: _xla_attention(a, b_, c, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    dqs, dks, dvs = [], [], []
    for qr, dor in zip(torch.from_numpy(q).chunk(sp, dim=1), torch.from_numpy(do).chunk(sp, dim=1)):
        o = _torch_attention(qr, tk, tv, scale)
        dq, lse, dsum = _torch_attn_bwd_dq(qr, tk, tv, o, dor, scale)
        assert lse.shape == dsum.shape == (3, 64 // sp)
        dk, dv = _torch_attn_bwd_dkdv(qr, tk, tv, dor, lse, dsum, scale)
        assert dk.shape == dv.shape == (3, 64, 32)
        dqs.append(dq)
        dks.append(dk)
        dvs.append(dv)
    top = max(float(np.abs(w).max()) for w in want)
    for got, w in zip((torch.cat(dqs, dim=1), _rank_sum(dks), _rank_sum(dvs)), want):
        assert float(np.abs(got.numpy() - w).max()) <= 1e-5 * top


def test_grid_refuses_guidance_of_a_classifier_it_did_not_shard():
    """Grid.wrap(guidance_fn=) checks the classifier's spatial group (an
    unsharded classifier on a shard's rows would give a wrong gradient)
    and, on a call, its lowest grid."""
    grid = Grid(dp=1, sp=2, data_index=0, spatial_rank=0, device=torch.device("cpu"),
                spatial=SpatialGroup(None, 0, 2))
    clf = ADMClassifier(**TOY_ARCH, out_channels=5)
    with pytest.raises(ValueError, match="not sharded over this grid"):
        grid.wrap(guidance_fn=classifier_guidance_fn(clf, 1, 1.0), classifier=clf)
    clf.spatial = grid.spatial
    _, _, _, guide = grid.wrap(guidance_fn=classifier_guidance_fn(clf, 1, 1.0), classifier=clf)
    with pytest.raises(ValueError, match="lowest grid"):
        guide(torch.zeros(1, 34, 32, 3), torch.zeros(1))


# ------------------------------------------------------ 2 gloo processes


def _perturbed_init(module, seed, *args):
    """JAX's init of `module` on `args`, every leaf plus 0.05 N(0, 1)
    (tests/test_torch_guidance.py's)."""
    params = module.init(jax.random.PRNGKey(seed), *args)
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.05 * rs.randn(*a.shape).astype(np.float32), params)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 2 ranks' outputs (one dict per rank) and JAX's references."""
    out = tmp_path_factory.mktemp("spatial_guidance")
    rs = np.random.RandomState(0)
    inp = {"x": rs.randn(2, 32, 32, 3).astype(np.float32),
           "t": rs.uniform(0, 999, 2).astype(np.float32),
           "classes": np.array([0, 3], np.int32)}
    np.savez(out / "inputs.npz", **inp)
    pool_params = {}
    for i, pool in enumerate(POOLS):
        jm = JADMClassifier(**TOY_ARCH, out_channels=5, pool=pool)
        pool_params[pool] = (jm, _perturbed_init(jm, 3 + i, jnp.zeros((1, 32, 32, 3)),
                                                 jnp.zeros((1,))))
        torch.save(params_from_flax(pool_params[pool][1]), out / f"pool_{pool}.pt")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_spatial_guidance_worker.py"), str(r),
         str(WORLD), str(port), str(out)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        ref = _jax_references(inp, pool_params)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}: {log[-3000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)], ref


def _jax_references(inp, pool_params) -> dict:
    """JAX's guidance gradients with x's rows sharded over a (1, 2) mesh."""
    mesh = j_make_mesh_2d(1, WORLD)
    x, t = j_shard_tiles(mesh, jnp.asarray(inp["x"])), jnp.asarray(inp["t"])
    ref = {}
    cmodel, cparams = load_our_classifier(ADM_TOY32)
    cparams = j_replicate(mesh, cparams)
    ref["toy_clf"] = np.asarray(jax.jit(j_guidance_fn(
        cmodel.apply, jnp.full((2,), GUIDED_CLASS, jnp.int32), 2.0, params=cparams))(x, t))
    ref["toy_clf_params"] = np.asarray(jax.jit(j_guidance_from_params(cmodel.apply, 1.5))(
        {"classifier": cparams, "classes": jnp.asarray(inp["classes"])}, x, t))
    for pool, (jm, params) in pool_params.items():
        ref[f"pool_{pool}"] = np.asarray(jax.jit(j_guidance_fn(
            jm.apply, jnp.array([1, 4], jnp.int32), 1.0,
            params=j_replicate(mesh, params)))(x, t))
    return ref


def test_every_rank_holds_the_same_bits(group):
    """Every gathered gradient and the trajectory are bit-equal on both
    ranks; each backward exchange ran (the halo rows', the GroupNorm sums',
    the attention's dK / dV), as often as its forward's."""
    ranks, _ = group
    for key in ranks[0]:
        assert np.array_equal(ranks[1][key], ranks[0][key]), key
    fwd, bwd = ranks[0]["toy_collectives"], ranks[0]["toy_backward_collectives"]
    # sorted kinds: attention, batch, groupnorm, halo, rows; attention_grad,
    # groupnorm_grad, halo_grad (two guidance calls)
    assert (bwd > 0).all()
    assert bwd.tolist() == [fwd[0], fwd[2], fwd[3]]


def test_toy32_classifier_guidance_at_sp2_matches_jax(group):
    ranks, ref = group
    assert ranks[0]["toy_clf"].shape == (2, 32, 32, 3)
    assert _rel(ranks[0]["toy_clf"], ref["toy_clf"]) <= 1e-4
    assert _rel(ranks[0]["toy_clf_params"], ref["toy_clf_params"]) <= 1e-4


@pytest.mark.parametrize("pool", POOLS)
def test_each_pool_at_sp2_matches_jax(group, pool):
    ranks, ref = group
    assert _rel(ranks[0][f"pool_{pool}"], ref[f"pool_{pool}"]) <= 1e-4


def test_guided_toy32_trajectory_at_sp2_matches_jax(group):
    """The guided golden's trajectory with the ADM and the classifier
    sharded: each image within 1e-3 of the JAX output, the PSNR within
    0.01 dB of the JAX package's."""
    ranks, _ = group
    golden = json.loads(chip_smoke.GUIDED_GOLDEN.read_text())["tiers"]["toy32"]
    jax_x = chip_smoke.decode_f32(golden["jax_output"])
    final = ranks[0]["golden_final"]
    assert np.isfinite(final).all() and final.shape == jax_x.shape
    assert np.abs(final - jax_x).max() <= 1e-3
    assert abs(float(ranks[0]["golden_psnr"]) - golden["psnr"]) <= chip_smoke.HQ_PSNR_TOL


# ------------------------------------------------------------ the CLI

# configs/hq/smoke.yml class-conditional and guided by a tiny classifier:
# its lowest grid (3 downsamplings of 256 rows) is 32 rows, as the UNet's
GUIDED_SMOKE = {"class_cond: false": "class_cond: true",
                "classifier_scale: 0.0": """classifier_scale: 1.0
classifier_width: 32
classifier_depth: 1
classifier_attention_resolutions: "32"
classifier_channel_mult: "1,2,2,4"
classifier_pool: attention
classifier_use_scale_shift_norm: true
classifier_resblock_updown: true"""}


def test_guided_hq_cli_at_sp2_matches_sp1(tmp_path):
    """hq_main_torch.py --device cpu --sp 2 as two ranks (gloo on 127.0.0.1)
    on a guided copy of configs/hq/smoke.yml (class 3, classifier_scale 1.0,
    the model and the classifier random from the seed), one 256 px tile,
    against the same command at --sp 1: within 1 uint8 level."""
    from ddnm_tpu_torch.data.io import load_image, save_image

    conf = (REPO / "configs" / "hq" / "smoke.yml").read_text()
    for old, new in GUIDED_SMOKE.items():
        assert conf.count(old) == 1, old
        conf = conf.replace(old, new)
    (tmp_path / "guided.yml").write_text(conf)
    lr = tmp_path / "lr.png"
    save_image(np.random.default_rng(8).uniform(0, 1, (64, 64, 3)).astype(np.float32), lr)
    common = ["--config", str(tmp_path / "guided.yml"), "--path_y", str(lr), "--deg",
              "sr_averagepooling", "--scale", "4", "--resize_y", "--class", "3",
              "--random_init", "--device", "cpu"]
    port = _free_port()
    cmd = [sys.executable, str(REPO / "hq_main_torch.py")]
    procs = [subprocess.Popen(
        cmd + common + ["--sp", "2", "-i", str(tmp_path / "sp2")], cwd=REPO,
        env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    single = subprocess.run(cmd + common + ["-i", str(tmp_path / "sp1")], cwd=REPO, env=_env(),
                            capture_output=True, text=True, timeout=300)
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert single.returncode == 0, single.stderr[-3000:]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    a = np.round(load_image(tmp_path / "sp2" / "final.png") * 255)
    b = np.round(load_image(tmp_path / "sp1" / "final.png") * 255)
    assert np.abs(a - b).max() <= 1 and a.std() > 1
