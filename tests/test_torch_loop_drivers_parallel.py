"""The scan loop driver of the port over a data mesh and under --sp
(ddnm_tpu_torch/sampling/graphs.py `placed` and `capturable`,
parallel/mesh.py, parallel/spatial.py `grid_sampler`), on the CPU at
toy32, where JAX runs its scan on sharded arrays.

  (a) the resolution table: a data mesh, a grid at sp 1, a CPU gloo grid
      and an NCCL grid at sp 2 resolve "auto" to "scan"; a gloo spatial
      group on a card resolves "auto" to "host" and "scan" raises a message
      that names gloo; the encoder cache stays host-driven;
  (b) a CPU mesh of 2 with stand-in graphs (tests/_torch_port.py
      StandInGraph: a capture runs the body once, each replay reruns it):
      the simplified sampler with time travel and the SVD cs_walshhadamard
      sampler against JAX's loop="scan" on a batch sharded over 2 virtual
      CPU devices, under zero noise, within 1e-3 (the gate of
      tests/test_torch_sampling.py); bit-equal to the port's host loop on
      the same mesh; one graph a shard, launches per shard equal;
  (c) two gloo CPU ranks at sp 2 (tests/_torch_loop_drivers_worker.py):
      the toy32 hq golden tile and the guided golden tile under stand-in
      scan bit-equal to host on each rank, collectives counted equal under
      both drivers, within the JAX goldens' gates of
      tests/test_torch_spatial_guidance.py (1e-3 a pixel, 0.01 dB); a call
      after one rank alone dropped its graphs completes on both ranks, a
      capture that fails on one rank raises on both, and one that runs out
      of memory on one rank is captured again by both.
"""

from __future__ import annotations

import json
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

import chip_smoke
from ddnm_tpu.operators import build_functional_operator as j_build_fop
from ddnm_tpu.operators import build_svd_operator as j_build_sop
from ddnm_tpu.parallel import make_mesh as j_make_mesh
from ddnm_tpu.parallel import replicate as j_replicate
from ddnm_tpu.parallel import shard_batch as j_shard_batch
from ddnm_tpu.sampling import build_schedule as j_build_schedule
from ddnm_tpu.sampling import sample_simplified as j_sample_simplified
from ddnm_tpu.sampling import sample_svd as j_sample_svd
from ddnm_tpu_torch import ops
from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch import tiling
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.ops import _build
from ddnm_tpu_torch.parallel import make_mesh, replicate, sharded_sampler
from ddnm_tpu_torch.parallel.spatial import Grid, SpatialGroup, grid_sampler
from ddnm_tpu_torch.sampling import build_schedule, graphs, sample_simplified, sample_svd
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators
from tests._golden import toy_perm
from tests._torch_port import (  # noqa: F401
    TIERS,
    StandInGraph,
    jax_model,
    one_torch_thread,
    port_model,
)

REPO = Path(__file__).resolve().parents[1]
TOY = TIERS["toy32"]
BETAS = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=1000).astype(np.float32)
# a DDNM schedule with time travel: 6 steps, jumps of 2 repeated twice
SCHED = dict(betas=BETAS, t_sampling=6, travel_length=2, travel_repeat=2)
JAX_TOL = 1e-3
N = 4  # images: 2 a shard


# ------------------------------------------------------------ (a) resolution


def _grid(sp: int, backend: str, device: str) -> Grid:
    return Grid(1, sp, 0, 0, torch.device(device), SpatialGroup(None, 0, sp, backend))


@pytest.mark.parametrize("where", ["data mesh", "grid at sp 1", "cpu gloo grid at sp 2",
                                   "nccl grid at sp 2"])
def test_auto_is_scan_over_a_mesh_and_a_grid(where):
    mesh = {"data mesh": lambda: make_mesh(2, device="cpu"),
            "grid at sp 1": lambda: _grid(1, "gloo", "cuda:0"),
            "cpu gloo grid at sp 2": lambda: _grid(2, "gloo", "cpu"),
            "nccl grid at sp 2": lambda: _grid(2, "nccl", "cuda:0")}[where]()
    assert graphs.capturable(mesh)
    assert [graphs.resolve_loop(loop, mesh=mesh) for loop in ("auto", "scan", "host")] == [
        "scan", "scan", "host"]


def test_gloo_on_a_card_is_host_and_scan_names_gloo():
    """A gloo spatial group whose tensors are on a card: auto is host, an
    explicit scan raises naming gloo (not quietly host), at the tiling
    engine's entry too; grid_sampler runs its ranks inside host_only."""
    grid = _grid(2, "gloo", "cuda:0")
    assert not graphs.capturable(grid)
    assert graphs.resolve_loop("auto", mesh=grid) == "host"
    assert graphs.resolve_loop("host", mesh=grid) == "host"
    with pytest.raises(ValueError, match="over gloo") as err:
        graphs.resolve_loop("scan", mesh=grid)
    assert str(err.value) == graphs.SCAN_OVER_GLOO
    with pytest.raises(ValueError, match="over gloo"):
        tiling.batched_tile_sample(None, np.zeros((1, 32, 32, 3), np.float32),
                                   "sr_averagepooling", None, 0, mesh=grid, loop="scan")
    seen = grid_sampler(lambda x, loop: graphs.resolve_loop(loop), grid)
    assert seen(torch.zeros(1), loop="auto") == "host"
    with pytest.raises(ValueError, match="over gloo"):
        seen(torch.zeros(1), loop="scan")


@pytest.mark.parametrize("mesh", [None, "data mesh", "nccl grid"])
def test_the_encoder_cache_stays_host_driven(mesh):
    mesh = {None: None, "data mesh": make_mesh(2, device="cpu"),
            "nccl grid": _grid(2, "nccl", "cuda:0")}[mesh]
    assert graphs.resolve_loop("auto", mesh=mesh, encoder_cache=3) == "host"
    with pytest.raises(ValueError, match="host-driven accel"):
        graphs.resolve_loop("scan", mesh=mesh, encoder_cache=3)


# ------------------------------------------------- (b) a CPU mesh of 2


@pytest.fixture
def stand_in(monkeypatch):
    graphs.clear_graphs()
    monkeypatch.setitem(graphs._BACKENDS, "cpu", StandInGraph)
    yield
    graphs.clear_graphs()


@pytest.fixture(scope="module")
def toy():
    """(JAX model_fn, params), the port's model, the inputs of N images."""
    rng = np.random.default_rng(4)
    xt = rng.standard_normal((N, 32, 32, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (N, 32, 32, 3)).astype(np.float32)
    return jax_model(TOY), port_model(TOY), xt, gt


_CASES: dict = {}


def _case(mode: str, gt: np.ndarray):
    """(port operator, y, JAX operator, JAX y) of a mode, one per mode for
    the module: an SVD operator is part of a graph's key by identity."""
    if mode not in _CASES:
        _CASES[mode] = _make_case(mode, gt)
    return _CASES[mode]


def _make_case(mode: str, gt: np.ndarray):
    if mode == "simplified":
        op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0)
        jop = j_build_fop("sr_averagepooling", image_size=32, deg_scale=4.0)
        return op, op.A(torch.from_numpy(gt)), jop, jop.A(jnp.asarray(gt))
    kw = dict(channels=3, image_size=32, deg_scale=0.25, perm=toy_perm(32))
    vec = np.ascontiguousarray(np.transpose(gt, (0, 3, 1, 2))).reshape(N, -1)
    op, jop = build_svd_operator("cs_walshhadamard", **kw), j_build_sop("cs_walshhadamard", **kw)
    return op, op.A(torch.from_numpy(vec)), jop, jop.A(jnp.asarray(vec))


def _jax_scan_sharded(mode, toy):
    (fn, params), _, xt, gt = toy
    _, _, jop, jy = _case(mode, gt)
    mesh = j_make_mesh(2)
    sample = j_sample_simplified if mode == "simplified" else j_sample_svd
    out, _ = sample(fn, j_shard_batch(mesh, jnp.asarray(xt)), j_shard_batch(mesh, jy), jop,
                    j_build_schedule(**SCHED), jax.random.PRNGKey(0),
                    noise_fn=lambda k, s: jnp.zeros(s, jnp.float32), loop="scan",
                    params=j_replicate(mesh, params))
    return np.asarray(out)


def _port_on_mesh(mode, toy, loop):
    """The port's sampler sharded over a CPU mesh of 2 under `loop`, its
    model counting one stand-in launch a call (the CPU's kernels count
    none); (x, launches per shard)."""
    _, model, xt, gt = toy
    op, y, _, _ = _case(mode, gt)
    mesh = make_mesh(2, device="cpu")

    def counted(x, t):
        _build.count_launch(ops._groupnorm.LAUNCHES, "groupnorm_stats")
        return model(x, t)

    sample = sample_simplified if mode == "simplified" else sample_svd
    ops.reset_launch_counts()
    x, _ = sharded_sampler(sample, mesh)(
        replicate(mesh, counted), torch.from_numpy(xt), y, replicate(mesh, op),
        build_schedule(**SCHED), image_generators(0, range(N), STREAM_SAMPLE, "cpu"),
        noise_fn=lambda g, s: torch.zeros(s), loop=loop)
    per_shard = {k: {n: c for n, c in v.items() if c}
                 for k, v in ops.tagged_launch_counts().items()}
    ops.reset_launch_counts()
    return x, per_shard


@pytest.mark.parametrize("mode", ["simplified", "svd"])
def test_mesh_of_2_scan_matches_jax_scan_and_the_host_loop(toy, stand_in, mode):
    host, host_launches = _port_on_mesh(mode, toy, "host")
    assert graphs.graph_stats() == []
    scan, scan_launches = _port_on_mesh(mode, toy, "scan")
    stats = graphs.graph_stats()
    assert sorted(s["entry"] for s in stats) == [0, 1]  # one graph a shard
    assert all(s["replays"] == 1 and s["shape"] == (N // 2, 32, 32, 3) for s in stats)
    replay, replay_launches = _port_on_mesh(mode, toy, "auto")
    assert [s["replays"] for s in graphs.graph_stats()] == [2, 2]
    assert torch.equal(scan, host) and torch.equal(replay, host)
    calls = sum(not t for t in build_schedule(**SCHED).is_travel)
    want = {0: {"groupnorm_stats": calls}, 1: {"groupnorm_stats": calls}}
    assert host_launches == scan_launches == replay_launches == want
    ref = _jax_scan_sharded(mode, toy)
    assert scan.shape == ref.shape and torch.isfinite(scan).all()
    assert float(np.abs(scan.numpy() - ref).max()) <= JAX_TOL
    assert float(scan.abs().max()) > 0.1


def test_two_entries_of_one_device_keep_a_graph_each(stand_in, monkeypatch):
    """Two mesh entries of one device key two graphs (the entry's index),
    and MAX_GRAPHS counts a place (device and entry): each entry keeps its
    newest graph."""
    monkeypatch.setattr(graphs, "MAX_GRAPHS", 1)
    make = lambda: (lambda x, *, noise, steps=None: (x + 1,))  # noqa: E731
    for n in (1, 2):
        for entry in (0, 1):
            with graphs.placed(entry=entry):
                graphs.run(("entries",), make, (torch.zeros(n),), [None], [0])
    assert [(s["entry"], s["shape"]) for s in graphs.graph_stats()] == [(0, (2,)), (1, (2,))]


# ------------------------------------------------- (c) two gloo ranks at sp 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("loop_drivers_sp2")
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_loop_drivers_worker.py"), str(r), "2",
         str(port), str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:  # each rank joined within its own time limit
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}: {log[-3000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("tile", ["hq", "guided", "short"])
def test_sp2_scan_is_bit_equal_to_host_on_every_rank(ranks, tile):
    keys = ["scan"] + (["auto", "after_clear"] if tile == "short" else [])
    for r in ranks:
        for k in keys:
            assert np.array_equal(r[f"{tile}_{k}"], r[f"{tile}_host"]), (tile, k)
        assert np.array_equal(r[f"{tile}_host"], ranks[0][f"{tile}_host"])


@pytest.mark.parametrize("tile", ["hq", "guided", "short"])
def test_sp2_collectives_are_counted_equal_under_both_drivers(ranks, tile):
    """Under scan the capture's collectives count at each replay (the
    warm-up's not at all): the same table as the host loop's, the
    guidance backward's included."""
    keys = ["scan"] + (["auto", "after_clear"] if tile == "short" else [])
    for r in ranks:
        host = r[f"{tile}_host_collectives"]
        assert host[:5].sum() > 0 and (tile != "guided" or host[5:].sum() > 0)
        for k in keys:
            assert np.array_equal(r[f"{tile}_{k}_collectives"], host), (tile, k)


def test_sp2_scan_holds_the_jax_goldens(ranks):
    golden = json.loads(chip_smoke.GUIDED_GOLDEN.read_text())["tiers"]["toy32"]
    hq = json.loads(chip_smoke.TOY_ADM_PSNR.read_text())[chip_smoke.TASKS_HQ[0][0]]
    for r in ranks:
        assert abs(float(r["hq_scan_psnr"]) - hq["ours_psnr"]) <= chip_smoke.HQ_PSNR_TOL
        final = r["guided_scan"]
        assert np.isfinite(final).all()
        assert np.abs(final - chip_smoke.decode_f32(golden["jax_output"])).max() <= JAX_TOL
        assert abs(float(r["guided_scan_psnr"]) - golden["psnr"]) <= chip_smoke.HQ_PSNR_TOL


def test_a_rank_that_dropped_its_graphs_alone_does_not_hang_the_group(ranks):
    """After rank 0 alone cleared its graphs the group agreed to capture
    afresh: both ranks finished the call on a new graph (one replay each),
    the replay before it on the old one (two)."""
    for r in ranks:
        assert r["short_replays"].tolist() == [2]
        assert r["short_after_clear_replays"].tolist() == [1]


def test_a_failed_capture_on_one_rank_raises_on_every_rank(ranks):
    assert str(ranks[0]["short_failed_error"]) == (
        "RuntimeError: stand-in capture failed after its body")
    assert str(ranks[1]["short_failed_error"]).startswith(
        "RuntimeError: spatial rank(s) [0] failed to capture")


def test_an_out_of_memory_capture_on_one_rank_is_captured_again_by_every_rank(ranks):
    for r in ranks:
        assert str(r["short_oom_error"]) == ""
        assert np.array_equal(r["short_oom"], r["short_host"])
        assert int(r["short_oom_graphs"]) == 1
