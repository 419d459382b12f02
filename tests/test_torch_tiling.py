"""Port parity: Mask-Shift tiling (ddnm_tpu_torch/tiling.py) against
ddnm_tpu/tiling.py.

The JAX module sizes its tiles through module globals (TILE, STRIDE),
which these tests patch to 32 / 16 for the toy32 ADM; the port takes them
as arguments.

Tolerances: tile grids and wavefront groups exactly equal; the hq
operators within 1e-6 (the same fp32 pools and broadcasts); Mask-Shift on
a 48 x 48 canvas (2 x 2 tiles of the toy32 ADM, 45 model calls each) with
zero noise within 1e-3 of JAX, in the carry and the fresh order; the
range-space error of a canvas within 1e-5; the wavefront order bit-equal to
the sequential fresh order where its groups are single tiles, and within
1e-3 where it batches, with deterministic and with stochastic noise;
batched_tile_sample within 1e-3 of per-image runs. Batched runs: a batch
of 3-4 convolves in another order than batch 1 on the CPU, and the
3-step schedule's first step multiplies x and eps by 1/sqrt(alpha_bar) =
~221, so ~1e-7 differences reach 2e-4."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddnm_tpu.tiling as jt
from ddnm_tpu.sampling.posterior import build_posterior_tables as j_tables
from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch import tiling
from ddnm_tpu_torch.models import ADMUNet
from ddnm_tpu_torch.runner import load_checkpoint
from ddnm_tpu_torch.sampling.posterior import build_posterior_tables
from ddnm_tpu_torch.sampling.rng import STREAM_INIT, STREAM_SAMPLE, tile_generators
from tests._golden_adm import ADM_TOY32, load_our_model
from tests._torch_port import one_torch_thread, shared_noise  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOY_KW = json.loads((REPO / "tests/fixtures/toy_adm32.json").read_text())["adm_kw"]
GOLDEN = dict(betas=sch.named_beta_schedule("linear", 1000), timestep_respacing="25",
              schedule_jump_params=dict(t_T=25, n_sample=1, jump_length=10, jump_n_sample=2))
TINY = dict(betas=sch.named_beta_schedule("linear", 100), timestep_respacing="3",
            schedule_jump_params=dict(t_T=3, n_sample=1, jump_length=1, jump_n_sample=1))


def _key(t):
    return (t.index, t.h0, t.w0, t.row_overlap, t.col_overlap)


@pytest.mark.parametrize("tile,stride", [(256, 128), (32, 16), (128, 64)])
def test_tile_grid_matches_jax(monkeypatch, tile, stride):
    monkeypatch.setattr(jt, "TILE", tile)
    monkeypatch.setattr(jt, "STRIDE", stride)
    f = tile // 32
    for h, w in [(32, 32), (48, 48), (50, 70), (64, 96), (100, 45), (96, 200), (516, 900)]:
        h, w = max(h * f, tile), max(w * f, tile)
        ours = tiling.tile_grid(h, w, tile, stride)
        ref = jt.tile_grid(h, w)
        assert [_key(t) for t in ours] == [_key(t) for t in ref], (h, w)
        for a, b in zip(ours, ref):
            assert np.array_equal(a.paste_mask(), b.paste_mask())
    with pytest.raises(ValueError, match="at least"):
        tiling.tile_grid(tile - 1, tile, tile, stride)


@pytest.mark.parametrize("shape", [(4, 7), (3, 3), (2, 9), (6, 2)])
def test_plan_groups_matches_jax(shape):
    tiles = tiling.tile_grid(16 * (shape[0] + 1), 16 * (shape[1] + 1), 32, 16)
    ours = [[t.index for t in g] for g in tiling._plan_groups(tiles)]
    ref = [[t.index for t in g] for g in jt._plan_groups(tiles)]
    assert ours == ref
    assert sorted(i for g in ours for i in g) == sorted(t.index for t in tiles)


def _mask(h, w, seed=0):
    m = np.ones((h, w), np.float32)
    r = np.random.default_rng(seed)
    y, x = r.integers(0, h // 2), r.integers(0, w // 2)
    m[y:y + h // 3, x:x + w // 3] = 0.0
    return m


@pytest.mark.parametrize("deg,scale", [("sr_averagepooling", 4), ("colorization", 4),
                                       ("sr_color", 2), ("inpainting", 4),
                                       ("mask_color_sr", 2)])
def test_hq_operators_match_jax(monkeypatch, deg, scale):
    monkeypatch.setattr(jt, "TILE", 32)
    rng = np.random.default_rng(1)
    gt = rng.uniform(-1, 1, (1, 48, 64, 3)).astype(np.float32)
    tile = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    mask = _mask(48, 64) if deg in ("inpainting", "mask_color_sr") else None
    op, a_temp = tiling.build_hq_operators(deg, scale=scale, gt_shape=(48, 64), mask=mask,
                                           tile=32, device="cpu")
    jop, ja_temp = jt.build_hq_operators(deg, scale=scale, gt_shape=(48, 64), mask=mask)
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    y = a_temp(torch.from_numpy(gt))
    close(y, ja_temp(jnp.asarray(gt)))
    close(op.Ap(y), jop.Ap(ja_temp(jnp.asarray(gt))))
    assert op.has_ctx == jop.has_ctx
    if op.has_ctx:
        ctx = np.stack([_mask(32, 32, 2), _mask(32, 32, 3)])[..., None]
        t_ctx = torch.from_numpy(ctx)
        close(op.A_ctx(torch.from_numpy(tile), t_ctx), jop.A_ctx(jnp.asarray(tile), ctx))
        close(op.range_ctx(torch.from_numpy(tile), t_ctx),
              jop.range_ctx(jnp.asarray(tile), ctx))
    else:
        close(op.Ap(op.A(torch.from_numpy(tile))), jop.Ap(jop.A(jnp.asarray(tile))))


def test_mask_shape_mismatch_and_unknown_task_raise():
    with pytest.raises(ValueError, match="mask shape"):
        tiling.build_hq_operators("inpainting", gt_shape=(384, 384),
                                  mask=np.ones((256, 256), np.float32), device="cpu")
    with pytest.raises(ValueError, match="requires a mask"):
        tiling.build_hq_operators("mask_color_sr", gt_shape=(256, 256), device="cpu")
    with pytest.raises(NotImplementedError):
        tiling.build_hq_operators("deblur_gauss", gt_shape=(256, 256), device="cpu")


@pytest.fixture(scope="module")
def toy():
    model = ADMUNet(**TOY_KW).eval()
    load_checkpoint(model, ADM_TOY32.fixture)
    return model


@pytest.mark.parametrize("deg,order", [("sr_averagepooling", "carry"),
                                       ("sr_averagepooling", "fresh"),
                                       ("inpainting", "carry")])
def test_mask_shift_48_matches_jax(monkeypatch, toy, deg, order):
    """2 x 2 tiles of the toy32 ADM with zero noise under the golden
    protocol's schedule (respacing 25, jumps 10 x 2: 45 model calls a tile):
    the first tile starts from a shared init_noise; in the fresh order
    every later tile starts from a constant 0.25 on both sides (the JAX
    tile init patched to it).

    The schedule matters: with respacing 10 and jumps of 3 the two sides
    drift apart even on the same forward (1e-4 on the first tile, 0.2 by the
    last carried one; respaced betas up to 0.99 make the early steps
    amplify fp32 rounding), where the golden schedule keeps them within
    1e-6 (carry) and 3e-5 (fresh)."""
    monkeypatch.setattr(jt, "TILE", 32)
    monkeypatch.setattr(jt, "STRIDE", 16)
    rng = np.random.default_rng(2)
    gt = rng.uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    init = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    mask = _mask(48, 48, 4) if deg == "inpainting" else None
    if order == "fresh":
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=jnp.float32: jnp.full(shape, 0.25, dtype))
        monkeypatch.setattr(tiling, "default_noise",
                            lambda gens, shape: torch.full(shape, 0.25))

    ours = tiling.mask_shift_sample(
        lambda x, t: toy(x, t), gt, deg, build_posterior_tables(**GOLDEN), 0, scale=4,
        mask=mask, noise_fn=lambda g, s: torch.zeros(s), tile_init=order, init_noise=init,
        tile=32, stride=16, device="cpu")
    fn, params = load_our_model(ADM_TOY32)
    ref = jt.mask_shift_sample(
        fn, gt, deg, j_tables(**GOLDEN), jax.random.PRNGKey(0), scale=4, mask=mask,
        noise_fn=lambda k, s: jnp.zeros(s, jnp.float32), tile_init=order, init_noise=init,
        params=params)
    for k in ("final", "apy", "y"):
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-3 if k == "final" else 1e-6,
                                   err_msg=k)
    assert np.abs(ours["final"]).max() > 0.1


@pytest.mark.parametrize("deg,order", [("sr_averagepooling", "carry"),
                                       ("inpainting", "fresh")])
def test_mask_shift_48_keeps_the_measurement_and_the_seams(toy, deg, order):
    """The final canvas gives back y through A (range-space consistency
    survives the paste: the strips are whole pooling blocks, and inpainting
    is pixelwise), and each tile's top and left strips equal what the tiles
    before it wrote there."""
    rng = np.random.default_rng(2)
    gt = rng.uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    mask = _mask(48, 48, 4) if deg == "inpainting" else None
    scale = 4
    written = []
    out = tiling.mask_shift_sample(
        lambda x, t: toy(x, t), gt, deg, build_posterior_tables(**GOLDEN), 0, scale=scale,
        mask=mask, noise_fn=lambda g, s: torch.zeros(s), tile_init=order, tile=32,
        stride=16, device="cpu", progress_fn=lambda t, x0: written.append((t, x0)))
    op, a_temp = tiling.build_hq_operators(deg, scale=scale, gt_shape=(48, 48), mask=mask,
                                           tile=32, device="cpu")
    err = np.abs(a_temp(torch.from_numpy(out["final"])).numpy() - out["y"]).max()
    assert err <= 1e-5
    canvas = np.zeros_like(out["final"])
    for t, x0 in written:
        strip = t.paste_mask()[None] > 0
        old = canvas[:, t.h0:t.h0 + 32, t.w0:t.w0 + 32]
        np.testing.assert_array_equal(np.where(strip, x0, 0), np.where(strip, old, 0))
        canvas[:, t.h0:t.h0 + 32, t.w0:t.w0 + 32] = x0
    assert np.array_equal(canvas, out["final"])


@pytest.fixture(scope="module")
def tiny():
    """A small random ADM UNet (torch's default init: every layer live)."""
    torch.manual_seed(0)
    return ADMUNet(image_size=32, model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                   attention_resolutions=(2,), num_head_channels=32).eval()


@pytest.mark.parametrize("grid,stochastic", [((3, 5), False), ((4, 7), False),
                                             ((4, 7), True)])
def test_wavefront_equals_sequential(tiny, grid, stochastic):
    """3 x 5 tiles of 32: the wavefronts hold at most 3 tiles, which run one
    by one in wavefront order (not row-major), so the canvas is bit-equal to
    the sequential one. 4 x 7 tiles: the widest wavefronts run as batched
    groups of 4 beside 1-3 tile remainders; with deterministic noise and
    with stochastic noise the canvas equals the sequential one within 1e-3
    (module docstring)."""
    h, w = 16 * (grid[0] + 1), 16 * (grid[1] + 1)
    groups = tiling._plan_groups(tiling.tile_grid(h, w, 32, 16))
    batched = max(len(g) for g in groups) > 1
    assert batched == (grid == (4, 7))
    assert [t.index for g in groups for t in g] != sorted(t.index for g in groups for t in g)
    gt = np.random.default_rng(5).uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    kw = dict(scale=4, tile=32, stride=16, device="cpu")
    if not stochastic:
        kw["noise_fn"] = lambda g, s: torch.zeros(s)
    tables = build_posterior_tables(**TINY)
    seq = tiling.mask_shift_sample(lambda x, t: tiny(x, t), gt, "sr_averagepooling", tables,
                                   3, tile_init="fresh", **kw)
    par = tiling.mask_shift_sample(lambda x, t: tiny(x, t), gt, "sr_averagepooling", tables,
                                   3, parallel=True, **kw)
    if batched:
        np.testing.assert_allclose(par["final"], seq["final"], atol=1e-3)
    else:
        assert np.array_equal(par["final"], seq["final"])
    if stochastic:
        other = tiling.mask_shift_sample(lambda x, t: tiny(x, t), gt, "sr_averagepooling",
                                         tables, 4, parallel=True, **kw)
        assert np.abs(other["final"] - par["final"]).max() > 1e-3  # the seed matters


def test_tile_generators_are_per_tile_and_per_stream():
    draw = lambda g: torch.randn(4, generator=g)
    a = [draw(g) for g in tile_generators(1, 0, [(0, 0), (0, 1), (1, 0)], STREAM_SAMPLE, "cpu")]
    b = [draw(g) for g in tile_generators(1, 0, [(1, 0), (0, 1), (0, 0)], STREAM_SAMPLE, "cpu")]
    assert torch.equal(a[0], b[2]) and torch.equal(a[2], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    for other in (tile_generators(1, 0, [(0, 0)], STREAM_INIT, "cpu"),
                  tile_generators(1, 1, [(0, 0)], STREAM_SAMPLE, "cpu"),
                  tile_generators(2, 0, [(0, 0)], STREAM_SAMPLE, "cpu")):
        assert not torch.equal(draw(other[0]), a[0])


@pytest.mark.parametrize("deg", ["inpainting", "sr_averagepooling"])
def test_batched_tile_sample_matches_per_image(tiny, deg):
    """Stochastic noise: image i of one batched call equals mask_shift_sample
    of image i alone with the same seed and image index."""
    rng = np.random.default_rng(11)
    n = 3
    gts = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    masks = [_mask(32, 32, 20 + i) for i in range(n)]
    tables = build_posterior_tables(**TINY)
    kw = dict(scale=4, tile=32, device="cpu")
    batched = tiling.batched_tile_sample(lambda x, t: tiny(x, t), gts, deg, tables, 9,
                                         [5, 6, 7], masks=masks if deg == "inpainting" else None,
                                         **kw)
    assert batched["final"].shape == (n, 32, 32, 3)
    for i in range(n):
        single = tiling.mask_shift_sample(lambda x, t: tiny(x, t), gts[i][None], deg, tables, 9,
                                          image_index=5 + i, stride=16,
                                          mask=masks[i] if deg == "inpainting" else None, **kw)
        np.testing.assert_allclose(batched["final"][i], single["final"][0], atol=1e-3)
        np.testing.assert_allclose(batched["apy"][i], single["apy"][0], atol=1e-6)
        np.testing.assert_allclose(batched["y"][i], single["y"][0], atol=1e-6)


def test_batched_tile_sample_refusals(tiny):
    tables = build_posterior_tables(**TINY)
    model = lambda x, t: tiny(x, t)
    with pytest.raises(ValueError, match="single-tile"):
        tiling.batched_tile_sample(model, np.zeros((1, 48, 48, 3), np.float32),
                                   "sr_averagepooling", tables, 0, tile=32, device="cpu")
    with pytest.raises(ValueError, match="one mask per image"):
        tiling.batched_tile_sample(model, np.zeros((2, 32, 32, 3), np.float32), "inpainting",
                                   tables, 0, masks=[np.ones((32, 32))], tile=32, device="cpu")
    with pytest.raises(ValueError, match="mask shape"):
        tiling.batched_tile_sample(model, np.zeros((1, 32, 32, 3), np.float32), "inpainting",
                                   tables, 0, masks=[np.ones((48, 48))], tile=32, device="cpu")


@pytest.mark.parametrize("kw,err", [
    # ported: each runs and agrees with JAX (ids kept from when they raised)
    pytest.param(dict(mesh=2), None, id="kw0-Queue 1 F"),
    pytest.param(dict(encoder_cache=2), None, id="kw1-Queue 1 D"),
    pytest.param(dict(solver="multistep"), None, id="kw2-Queue 1 D"),
    pytest.param(dict(checkpoint_dir="ckpt"), None, id="kw3-Queue 1 C"),
    pytest.param(dict(resume=True), None, id="kw4-Queue 1 C"),
])
def test_not_ported_options_raise(kw, err, toy, monkeypatch, tmp_path):
    """The encoder cache (with the ADM's split halves), the multistep
    solver, `checkpoint_dir` (whose state is gone once the run completes)
    and `resume` run a 48 x 48 canvas of the toy32 ADM within 1e-3 of the
    JAX package's, in the fresh order, every tile after the first from one
    shared random pattern (shared_noise). `mesh` runs batched_tile_sample
    on 2 images over a CPU mesh of 2, one image a shard (the canvas's
    wavefronts are single tiles, which run unsharded on the first entry;
    hq_main_torch --dp 2 runs those, tests/test_torch_hq_cli.py), against
    the JAX package's on its mesh of 2 virtual devices.
    Not the constant 0.25 of test_mask_shift_48_matches_jax: a cached step's
    eps does not follow x, so at high noise x0 = x / sqrt(abar) - ...
    multiplies x's fp32 differences by up to 157, and from a constant init
    the two frameworks' ~1e-6 differences then grow to 0.04 (measured on the
    port alone with the weights perturbed by 3e-7: 5e-3 at interval 2)."""
    from ddnm_tpu.parallel import make_mesh as j_make_mesh
    from ddnm_tpu.parallel import replicate as j_replicate
    from ddnm_tpu.sampling import accel as j_accel
    from ddnm_tpu_torch.parallel import make_mesh
    from ddnm_tpu_torch.sampling import accel
    from tests._golden_adm import _mod

    monkeypatch.setattr(jt, "TILE", 32)
    monkeypatch.setattr(jt, "STRIDE", 16)
    shared_noise(monkeypatch)
    rng = np.random.default_rng(2)
    gt = rng.uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    init = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    fn, params = load_our_model(ADM_TOY32)
    ours_kw, ref_kw = dict(kw), dict(kw)
    if "encoder_cache" in kw:
        jmodel = getattr(_mod(ADM_TOY32.trainer_mod), ADM_TOY32.build_fn)(dtype=jnp.float32)
        ref_kw["encode_fn"], ref_kw["decode_fn"] = j_accel.adm_split_fns(jmodel)
        ours_kw["encode_fn"], ours_kw["decode_fn"] = accel.adm_split_fns(toy)
    if "checkpoint_dir" in kw:
        ours_kw["checkpoint_dir"] = tmp_path / "ours"
        ref_kw["checkpoint_dir"] = tmp_path / "jax"
    if "mesh" in kw:
        gts = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        batches = []
        ours = tiling.batched_tile_sample(
            lambda x, t: batches.append(x.shape[0]) or toy(x, t), gts, "sr_averagepooling",
            build_posterior_tables(**GOLDEN), 0, scale=4, noise_fn=lambda g, s: torch.zeros(s), tile=32, device="cpu",
            mesh=make_mesh(kw["mesh"], device="cpu"))
        j_mesh = j_make_mesh(kw["mesh"])
        ref = jt.batched_tile_sample(
            fn, gts, "sr_averagepooling", j_tables(**GOLDEN),
            list(jax.random.split(jax.random.PRNGKey(0), 2)), scale=4,
            noise_fn=lambda k, s: jnp.zeros(s, jnp.float32),
            params=j_replicate(j_mesh, params), mesh=j_mesh)
        assert ours["final"].shape == (2, 32, 32, 3) and set(batches) == {1}  # sharded
        np.testing.assert_allclose(ours["final"], ref["final"], atol=1e-3)
        assert np.abs(ours["final"]).max() > 0.1
        return
    ours = tiling.mask_shift_sample(
        lambda x, t: toy(x, t), gt, "sr_averagepooling", build_posterior_tables(**GOLDEN), 0,
        scale=4, noise_fn=lambda g, s: torch.zeros(s), tile_init="fresh", init_noise=init,
        tile=32, stride=16, device="cpu", **ours_kw)
    ref = jt.mask_shift_sample(
        fn, gt, "sr_averagepooling", j_tables(**GOLDEN), jax.random.PRNGKey(0), scale=4,
        noise_fn=lambda k, s: jnp.zeros(s, jnp.float32), tile_init="fresh", init_noise=init,
        params=params, **ref_kw)
    np.testing.assert_allclose(ours["final"], ref["final"], atol=1e-3)
    assert np.abs(ours["final"]).max() > 0.1
    assert not (tmp_path / "ours" / "mask_shift_state.npz").exists()


def test_tile_order_refusals():
    gt = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises(ValueError, match="parallel"):
        tiling.mask_shift_sample(None, gt, "sr_averagepooling", None, 0, parallel=True,
                                 tile_init="carry", tile=32, device="cpu")
    with pytest.raises(ValueError, match="tile_init"):
        tiling.mask_shift_sample(None, gt, "sr_averagepooling", None, 0, tile_init="warm",
                                 tile=32, device="cpu")
