"""Spatial partitioning of the port (ddnm_tpu_torch/parallel/spatial.py,
halo.py; the sharded UNets of models/nn.py) on the CPU, against the JAX
package's unsharded runs, as tests/test_parallel_spatial.py holds the JAX
package's sharded runs.

In one process, no process group: the halo arithmetic of the three 3x3
convolution kinds (the stride-1 conv, the DDPM's stride-2 conv after its
(0, 1, 0, 1) pad, the ADM's stride-2 conv with padding 1) on 2 and 4 row
blocks against the unsharded F.conv2d; the GroupNorm's partial sums of 2
and 4 row blocks, added and finalised, against the one-pass plain version
and JAX's group_norm; the plain attention of a shard's queries against
every key; the refusals.

One group of 4 gloo processes on 127.0.0.1 (tests/_torch_spatial_worker.py),
spawned once for the file while this process computes JAX's references:
the tiny DDPM UNet's forward at sp = 4, the toy32 ADM's at sp = 2 and 4
(and its encoder cache's halves at sp = 2), the posterior trajectory on a
(dp 2, sp 2) grid, Mask-Shift's sequential carry chain at (1, 4) and its
wavefront at (2, 2); every rank's outputs equal bit for bit.

Then hq_main_torch.py --sp 2 as two ranks against its own --sp 1 run.

Gates, as the JAX package's own spatial tests set them: the forward 1e-5
(tiny DDPM; the sums of a shard's GroupNorm and the gathered attention
run in another order than one device's) and 1e-4 for the toy32 ADM (the
port's gate against JAX, tests/test_torch_adm.py); the trajectory 1e-3
(the drift compounds over the steps); the tiling 2e-5; the halo and the
partial sums fp32 to 1e-6 and 1e-5; the CLI within 1 uint8 level (the
port's CPU gate between two runs, tests/test_torch_parallel.py).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from ddnm_tpu import schedules as j_sch
from ddnm_tpu.models.convert import torch_state_dict_to_flax
from ddnm_tpu.models.unet_ddpm import DDPMUNet as JDDPMUNet
from ddnm_tpu.operators import build_functional_operator as j_build_fop
from ddnm_tpu.ops.attention import fused_attention as j_attention
from ddnm_tpu.ops.groupnorm import group_norm as j_group_norm
from ddnm_tpu.sampling.posterior import build_posterior_tables as j_tables
from ddnm_tpu.sampling.posterior import sample_posterior as j_sample_posterior
from ddnm_tpu.tiling import mask_shift_sample as j_mask_shift_sample
from ddnm_tpu_torch.models import DDPMUNet
from ddnm_tpu_torch.ops.attention import _torch_attention
from ddnm_tpu_torch.ops.groupnorm import (
    _torch_affine_from_sums,
    _torch_apply,
    _torch_stats_affine,
    _torch_stats_partial,
)
from ddnm_tpu_torch.parallel import halo, make_mesh_2d, multihost
from ddnm_tpu_torch.parallel.spatial import (
    Grid,
    SpatialGroup,
    lowest_rows,
    shard_tiles,
    split_rows,
)
from tests._golden_adm import ADM_TOY32, load_our_model
from tests._torch_port import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_spatial_worker import JUMPS, TINY

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE",
               "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    return dict(env, OMP_NUM_THREADS="1", **extra)


# ------------------------------------------------------------ in one process


# (stride, padding of the unsharded conv, the input's own pad of (W, H))
CONV_KINDS = {"same": (1, 1, None), "ddpm_down": (2, 0, (0, 1, 0, 1)), "adm_down": (2, 1, None)}


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kind", sorted(CONV_KINDS))
def test_halo_rows_give_the_unsharded_convolution(kind, sp):
    """Each row block with its neighbours' edge rows (zeros at the image's
    edges) convolved with row padding 0 gives its block of the unsharded
    convolution's output."""
    stride, padding, own_pad = CONV_KINDS[kind]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 8, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    full = F.conv2d(F.pad(x, own_pad) if own_pad else x, w, b, stride=stride, padding=padding)
    above, below = halo.rows_needed(stride, padding)
    blocks = list(x.chunk(sp, dim=2))
    parts = [halo.edge_rows(blk, above, below) for blk in blocks]
    outs = []
    for r, blk in enumerate(blocks):
        if own_pad:  # the DDPM's pad: its columns; its row below is the halo's
            blk = F.pad(blk, own_pad[:2])
        up, down = halo.neighbour_rows(parts, r, above, below)
        if own_pad:
            up, down = F.pad(up, own_pad[:2]), F.pad(down, own_pad[:2])
        outs.append(F.conv2d(halo.apply(blk, up, down), w, b, stride=stride,
                             padding=(0, padding)))
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), full.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("film", [False, True])
def test_partial_sums_of_row_blocks_give_the_whole_groupnorm(film, sp):
    """The blocks' per-channel sums added in rank order and finalised equal
    the one-pass affine, and the normalised blocks JAX's group_norm."""
    rng = np.random.default_rng(4)
    B, H, W, C, G = 2, 16, 8, 64, 32
    x = rng.standard_normal((B, H, W, C)).astype(np.float32) * 2 + 0.5
    gamma = rng.standard_normal(C).astype(np.float32)
    beta = rng.standard_normal(C).astype(np.float32)
    fs = rng.standard_normal((B, C)).astype(np.float32) * 0.1 if film else None
    ft = rng.standard_normal((B, C)).astype(np.float32) * 0.1 if film else None
    tt = lambda a: None if a is None else torch.from_numpy(a)
    xt = torch.from_numpy(x)
    sums = None
    for blk in xt.chunk(sp, dim=1):
        part = _torch_stats_partial(blk)
        sums = part if sums is None else sums + part
    a, b = _torch_affine_from_sums(sums, H * W, tt(gamma), tt(beta), G, 1e-5, tt(fs), tt(ft))
    a_ref, b_ref = _torch_stats_affine(xt, tt(gamma), tt(beta), G, 1e-5, tt(fs), tt(ft))
    np.testing.assert_allclose(a.numpy(), a_ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b.numpy(), b_ref.numpy(), atol=1e-5, rtol=0)
    ours = torch.cat([_torch_apply(blk, a, b, True) for blk in xt.chunk(sp, dim=1)], dim=1)
    ref = j_group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), num_groups=G,
                       eps=1e-5, swish=True, film_scale=None if fs is None else jnp.asarray(fs),
                       film_shift=None if ft is None else jnp.asarray(ft))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("sp", [2, 4])
def test_shard_queries_against_every_key_match_jax_rows(sp):
    """The plain attention of T / sp queries against all T keys and values
    gives those queries' rows of JAX's attention."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((3, 64, 32)).astype(np.float32) for _ in range(3))
    ref = np.asarray(j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.2))
    rows = 64 // sp
    for r in range(sp):
        ours = _torch_attention(torch.from_numpy(q[:, r * rows:(r + 1) * rows]),
                                torch.from_numpy(k), torch.from_numpy(v), 0.2)
        np.testing.assert_allclose(ours.numpy(), ref[:, r * rows:(r + 1) * rows], atol=1e-5,
                                   rtol=0)


def test_rows_that_do_not_divide_raise():
    """sp must divide the tile's rows and the model's lowest grid (the tiny
    DDPM halves 32 rows once: 16)."""
    model = DDPMUNet(**TINY)
    assert lowest_rows(model, 32, 4) == 16 and lowest_rows(model, 32, 16) == 16
    with pytest.raises(ValueError, match="lowest grid"):
        lowest_rows(model, 32, 32)
    with pytest.raises(ValueError, match="lowest grid"):
        lowest_rows(model, 34, 2)  # 17 rows at the lowest grid
    with pytest.raises(ValueError, match="does not divide 30 rows"):
        split_rows(torch.zeros(1, 30, 4, 3), SpatialGroup(None, 0, 4))
    assert split_rows(torch.arange(8.0).reshape(1, 8, 1, 1), SpatialGroup(None, 2, 4)
                      ).flatten().tolist() == [4.0, 5.0]


def test_grid_without_a_process_group_names_its_launch():
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        make_mesh_2d(1, 2, device="cpu")
    assert make_mesh_2d(2, 1, device="cpu").size == 2  # sp == 1: the data mesh


def test_hq_cli_refuses_what_sp_does_not_take(tmp_path):
    """hq_main_torch --sp: 256 % sp and the model's lowest grid (smoke.yml:
    32 rows) are checked, before any process group."""
    import hq_main_torch

    common = ["--deg", "sr_averagepooling", "--random_init", "--device", "cpu", "-i",
              str(tmp_path)]
    with pytest.raises(SystemExit, match="must divide the 256-px tile"):
        hq_main_torch.main(["--config", "configs/hq/smoke.yml", "--sp", "3", *common])
    with pytest.raises(ValueError, match="lowest grid"):
        hq_main_torch.main(["--config", "configs/hq/smoke.yml", "--sp", "64", *common])


def test_shard_tiles_on_a_grid_takes_this_ranks_part():
    """shard_tiles over a Grid (ddnm_tpu/parallel/spatial.py _specs): the
    leading axis over the data indices and the H of a 4-D leaf over the
    spatial ranks where they divide, kept whole where not; the images of a
    sweep over the data indices (process_subset with the Grid's)."""
    grid = Grid(dp=2, sp=2, data_index=1, spatial_rank=1, device=torch.device("cpu"),
                spatial=SpatialGroup(None, 1, 2))
    x = torch.arange(4 * 6 * 2 * 1.0).reshape(4, 6, 2, 1)
    out = shard_tiles(grid, {"x": x, "odd": x[:3], "t": torch.arange(4.0), "n": 7})
    assert torch.equal(out["x"], x[2:, 3:]) and torch.equal(out["odd"], x[:3, 3:])
    assert torch.equal(out["t"], torch.arange(2.0, 4.0)) and out["n"] == 7
    assert [multihost.process_subset(5, d, 2) for d in range(2)] == [(0, 3), (3, 5)]


# ------------------------------------------------------ 4 gloo processes


def _jax_tiny_ddpm(state_dict):
    model = JDDPMUNet(**{k: v for k, v in TINY.items()})
    return model, {"params": torch_state_dict_to_flax(
        {k: v.numpy() for k, v in state_dict.items()})}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The 4 ranks' outputs (one dict per rank) and JAX's references."""
    out = tmp_path_factory.mktemp("spatial_group")
    rng = np.random.default_rng(11)
    torch.manual_seed(0)
    ddpm = DDPMUNet(**TINY).eval()
    torch.save(ddpm.state_dict(), out / "tiny_ddpm.pt")
    inp = {
        "ddpm_x": rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
        "ddpm_t": np.full((2,), 10.0, np.float32),
        "adm_x": rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
        "adm_t": np.array([3.0, 999.0], np.float32),
        "post_x": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
        "post_x_init": rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
        "gt384": rng.uniform(-1, 1, (1, 384, 384, 3)).astype(np.float32),
        "gt512": rng.uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32),
        "init256": rng.standard_normal((1, 256, 256, 3)).astype(np.float32),
    }
    j_op = j_build_fop("sr_averagepooling", image_size=32, deg_scale=4)
    inp["post_apy"] = np.asarray(j_op.Ap(j_op.A(jnp.asarray(inp["post_x"]))))
    np.savez(out / "inputs.npz", **inp)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_spatial_worker.py"), str(r), str(WORLD),
         str(port), str(out)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        ref = _jax_references(ddpm, inp)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}: {log[-3000:]}"
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, ref


def _jax_references(ddpm, inp) -> dict:
    ref = {}
    jm, params = _jax_tiny_ddpm(ddpm.state_dict())
    ref["ddpm"] = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(inp["ddpm_x"]),
                                               jnp.asarray(inp["ddpm_t"])))
    fn, aparams = load_our_model(ADM_TOY32)
    ref["adm"] = np.asarray(jax.jit(fn)(aparams, jnp.asarray(inp["adm_x"]),
                                        jnp.asarray(inp["adm_t"])))

    def model6_fn(p, xx, tt):
        eps = jm.apply(p, xx, tt)
        return jnp.concatenate([eps, jnp.zeros_like(eps)], axis=-1)

    tables = j_tables(betas=j_sch.named_beta_schedule("linear", 100, use_scale=True),
                      timestep_respacing="3", sigma_y=0.0, schedule_jump_params=dict(JUMPS))
    zero = lambda key, shape: jnp.zeros(shape, jnp.float32)
    op = j_build_fop("sr_averagepooling", image_size=32, deg_scale=4)
    x, x0 = j_sample_posterior(model6_fn, jnp.asarray(inp["post_x_init"]),
                               jnp.asarray(inp["post_apy"]), op, tables,
                               jax.random.PRNGKey(5), noise_fn=zero, params=params)
    ref["post_x"], ref["post_x0"] = np.asarray(x), np.asarray(x0)

    def toy(xx, t):
        del t
        return jnp.concatenate([0.1 * xx, jnp.zeros_like(xx)], axis=-1)

    normal = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: jnp.full(shape, 0.25, dtype)
    try:
        for name, gt, parallel in (("carry_1x4", inp["gt384"], False),
                                   ("wavefront_2x2", inp["gt512"], True)):
            ref[name] = j_mask_shift_sample(
                toy, gt, "sr_averagepooling", tables, jax.random.PRNGKey(0), scale=4,
                noise_fn=zero, parallel=parallel, init_noise=inp["init256"])["final"]
    finally:
        jax.random.normal = normal
    return ref


def test_every_rank_holds_the_same_bits(group):
    """The gathered outputs, the trajectory and the tiles are bit-equal on
    every rank; every kind of collective ran."""
    ranks, _ = group
    for key in ranks[0]:
        if key != "collectives":
            for r in range(1, WORLD):
                assert np.array_equal(ranks[r][key], ranks[0][key]), (key, r)
    assert (ranks[0]["collectives"] > 0).all()


def test_sharded_tiny_ddpm_forward_matches_jax(group):
    ranks, ref = group
    np.testing.assert_allclose(ranks[0]["ddpm_sp4"], ref["ddpm"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("sp", [2, 4])
def test_sharded_toy32_adm_forward_matches_jax(group, sp):
    ranks, ref = group
    assert ranks[0][f"adm_sp{sp}"].shape == (2, 32, 32, 6)
    np.testing.assert_allclose(ranks[0][f"adm_sp{sp}"], ref["adm"], atol=1e-4, rtol=0)


def test_sharded_encoder_halves_equal_the_sharded_forward(group):
    """The encoder cache's encode + decode through the sharded ADM, each rank
    caching its own rows, is the sharded forward bit for bit."""
    ranks, _ = group
    assert np.array_equal(ranks[0]["adm_sp2_split"], ranks[0]["adm_sp2"])


def test_posterior_trajectory_on_a_2x2_grid_matches_jax(group):
    ranks, ref = group
    np.testing.assert_allclose(ranks[0]["post_x"], ref["post_x"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(ranks[0]["post_x0"], ref["post_x0"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", ["carry_1x4", "wavefront_2x2"])
def test_tiling_on_a_grid_matches_jax_meshless(group, name):
    ranks, ref = group
    assert ranks[0][name].shape == ref[name].shape
    np.testing.assert_allclose(ranks[0][name], ref[name], atol=2e-5, rtol=0)


# ------------------------------------------------------------ the CLI


def test_hq_cli_at_sp2_matches_sp1_and_only_rank0_writes(tmp_path):
    """hq_main_torch.py --device cpu --sp 2 as two ranks (gloo on 127.0.0.1)
    on configs/hq/smoke.yml (respacing 3), one 256 px tile, against the same
    command at --sp 1: within 1 uint8 level; rank 1 wrote nothing."""
    from ddnm_tpu_torch.data.io import load_image, save_image

    lr = tmp_path / "lr.png"
    save_image(np.random.default_rng(6).uniform(0, 1, (64, 64, 3)).astype(np.float32), lr)
    common = ["--config", "configs/hq/smoke.yml", "--path_y", str(lr), "--deg",
              "sr_averagepooling", "--scale", "4", "--resize_y", "--random_init", "--device",
              "cpu"]
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
    assert "grid dp=1 x sp=2: rank 1 is data 0, spatial 1" in logs[1]
    assert "this rank writes nothing" in logs[1] and "wrote" in logs[0]
    names = sorted(str(f.relative_to(tmp_path / "sp2")) for f in (tmp_path / "sp2").rglob("*.png"))
    assert names == sorted(str(f.relative_to(tmp_path / "sp1"))
                           for f in (tmp_path / "sp1").rglob("*.png"))
    a = np.round(load_image(tmp_path / "sp2" / "final.png") * 255)
    b = np.round(load_image(tmp_path / "sp1" / "final.png") * 255)
    assert np.abs(a - b).max() <= 1 and a.std() > 1
