"""The port's data parallelism (ddnm_tpu_torch/parallel) on the CPU: the
process-slicing arithmetic and the launch detection against the JAX
package's, the CPU mesh (N shards of the one CPU, run in turn on the
caller's thread), the sharded simplified and SVD samplers on the trained toy32
DDPM against the port's unsharded run and against the JAX package's
sharded sampler on its 8 virtual CPU devices, the runner's per-process
dataset slice, two main_torch processes (gloo on 127.0.0.1), and the
kernels' host state that several shards share (GroupNorm's launch counters
per stream, launch counts per shard).

Gates: a sharded run equals, bit for bit, the unsharded port run on each
shard's images alone (the mesh adds no arithmetic); it equals the
unsharded port at the whole batch to 1e-4 (CPU convolutions round a batch
of 4 and one of 8 apart by ~1e-7, and the first step's x0 = x / sqrt(abar)
multiplies that by up to 157: 2.5e-5 measured at 3 steps), and the JAX
package's sharded run to 1e-3 (the port's parity gate,
tests/test_torch_sampling.py); images of two processes within 1 uint8
level of one process's (the same rounding, tests/test_torch_runner_overlap.py)."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.operators import build_functional_operator as j_build_fop
from ddnm_tpu.operators import build_svd_operator as j_build_sop
from ddnm_tpu.parallel import make_mesh as j_make_mesh
from ddnm_tpu.parallel import replicate as j_replicate
from ddnm_tpu.parallel import sharded_sampler as j_sharded_sampler
from ddnm_tpu.parallel.multihost import process_subset as j_process_subset
from ddnm_tpu.sampling import build_schedule as j_build_schedule
from ddnm_tpu.sampling import sample_simplified as j_sample_simplified
from ddnm_tpu.sampling import sample_svd as j_sample_svd
from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
from ddnm_tpu_torch.parallel import (
    Replicas,
    make_mesh,
    make_mesh_2d,
    maybe_init_distributed,
    multihost,
    process_subset,
    replicate,
    sharded_sampler,
)
from ddnm_tpu_torch.sampling import build_schedule, sample_simplified, sample_svd
from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators
from tests._torch_port import TIERS, jax_model, one_torch_thread, port_model  # noqa: F401
from tests.test_torch_sampling import BETAS

REPO = Path(__file__).resolve().parents[1]
TOY = TIERS["toy32"]
LAUNCH_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID", "SLURM_JOB_NUM_NODES",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")


@pytest.mark.parametrize("n", [0, 1, 7, 8, 100, 1001])
def test_process_subset_matches_jax(n):
    for c in (1, 2, 3, 8, 16):
        spans = [process_subset(n, p, c) for p in range(c)]
        assert spans == [j_process_subset(n, p, c) for p in range(c)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(e0 == s1 for (_, e0), (s1, _) in zip(spans, spans[1:]))


@pytest.fixture
def clean_env(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", [
    {}, {"SLURM_JOB_NUM_NODES": "1"}, {"WORLD_SIZE": "1", "RANK": "0", "MASTER_ADDR": "x"},
    {"WORLD_SIZE": "2", "RANK": "0"},  # torchrun's evidence needs MASTER_ADDR
], ids=["empty", "slurm-one-node", "world-1", "no-master"])
def test_maybe_init_distributed_without_a_launch(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert multihost.launch_from_env() is None
    assert maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)


@pytest.mark.parametrize("env,launcher", [
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "MASTER_ADDR": "127.0.0.1"},
     "torchrun"),
    ({"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "port"},
     "torchrun"),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "3", "SLURM_LOCALID": "1"}, "slurm"),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "0"}, "openmpi"),
], ids=["torchrun-no-port", "torchrun-bad-port", "slurm", "openmpi"])
def test_maybe_init_distributed_raises_when_a_launch_cannot_join(clean_env, env, launcher):
    """A detected launch whose process group cannot be joined raises (the
    JAX package logs and runs single-process; here every rank would then
    restore the whole dataset)."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    launch = multihost.launch_from_env()
    assert launch["launcher"] == launcher and launch["world_size"] > 1
    with pytest.raises(RuntimeError, match="could not be joined"):
        maybe_init_distributed()
    assert not torch.distributed.is_initialized()


def test_local_device_and_meshes(clean_env):
    assert multihost.local_device("cpu").type == "cpu"
    assert multihost.local_device("cuda:3") == torch.device("cuda", 3)
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "1")
    clean_env.setenv("LOCAL_RANK", "1")
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="local rank 1 has no card"):
        multihost.local_device("cuda")
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        make_mesh(2)
    mesh = make_mesh(3, device="cpu")
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert make_mesh(devices=["cpu"] * 2).size == 2
    assert make_mesh_2d(2, 1, device="cpu").size == 2
    # sp > 1 is a grid of processes (tests/test_torch_spatial.py): without a
    # process group it names the launch it needs
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        make_mesh_2d(1, 2, device="cpu")
    # shards of one device share one copy; a Replicas passes through
    model = torch.nn.Linear(2, 2)
    reps = replicate(mesh, {"model": model})
    assert isinstance(reps, Replicas) and all(r["model"] is model for r in reps)
    assert replicate(mesh, reps) is reps


@pytest.fixture
def fresh_warnings(monkeypatch):
    """The mesh's warn-once record emptied, so that a test sees its warning."""
    from ddnm_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "_warned", set())


def test_shard_batch_and_shard_tiles(caplog, fresh_warnings):
    from ddnm_tpu_torch.parallel import shard_batch, shard_tiles

    mesh = make_mesh(2, device="cpu")
    x = torch.arange(12.0).reshape(4, 3)
    gens = [torch.Generator() for _ in range(4)]
    a, b = shard_batch(mesh, x)
    assert torch.equal(a, x[:2]) and torch.equal(b, x[2:])
    sx, sg = shard_batch(mesh, (x, gens))
    assert [len(g) for g in sg] == [2, 2] and sg[1][0] is gens[2]
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(mesh, x[:3])
    tiles = shard_tiles(mesh, {"even": x, "odd": x[:3], "scalar": torch.tensor(1.0)})
    assert torch.equal(tiles["even"][1], x[2:])
    assert all(torch.equal(t, x[:3]) for t in tiles["odd"])  # on every entry, whole
    assert len(tiles["scalar"]) == 2
    assert "does not divide dimension 3" in caplog.text


def _jax_sharded(mode: str, fn, params, xt, y, jop, sched):
    mesh = j_make_mesh(8)
    sample = j_sample_simplified if mode == "simplified" else j_sample_svd
    out, _ = j_sharded_sampler(sample, mesh)(
        fn, jnp.asarray(xt), jnp.asarray(y), jop, sched, jax.random.PRNGKey(0), eta=0.85,
        sigma_y=0.0, noise_fn=lambda k, s: jnp.zeros(s), params=j_replicate(mesh, params))
    return np.asarray(out)


@pytest.fixture(scope="module")
def runs():
    """Per mode: the inputs, the port's unsharded output and the JAX
    package's sharded output (8 images, 3 steps, zero noise)."""
    (fn, params), model = jax_model(TOY), port_model(TOY)
    rng = np.random.default_rng(0)
    xt = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    out = {}
    for mode in ("simplified", "svd"):
        if mode == "simplified":
            jop = j_build_fop("sr_averagepooling", image_size=32, deg_scale=4.0)
            op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0)
            y = np.asarray(jop.A(jnp.asarray(gt)), np.float32)
        else:
            jop = j_build_sop("sr_averagepooling", channels=3, image_size=32, deg_scale=4.0)
            op = build_svd_operator("sr_averagepooling", channels=3, image_size=32,
                                    deg_scale=4.0)
            vec = np.transpose(gt, (0, 3, 1, 2)).reshape(8, -1)
            y = np.asarray(jop.A(jnp.asarray(vec)), np.float32)
        ref = _jax_sharded(mode, fn, params, xt, y, jop,
                           j_build_schedule(betas=BETAS, t_sampling=3))
        single = _port(mode, model, op, xt, y)
        out[mode] = dict(model=model, op=op, xt=xt, y=y, jax=ref, single=single)
    return out


def _port(mode, model_fn, op, xt, y, mesh=None):
    sample = sample_simplified if mode == "simplified" else sample_svd
    if mesh is not None:
        sample = sharded_sampler(sample, mesh)
        model_fn, op = replicate(mesh, model_fn), replicate(mesh, op)
    out, _ = sample(model_fn, torch.tensor(xt), torch.tensor(y), op,
                    build_schedule(betas=BETAS, t_sampling=3),
                    image_generators(0, range(len(xt)), STREAM_SAMPLE, "cpu"), eta=0.85,
                    sigma_y=0.0, noise_fn=lambda g, s: torch.zeros(s))
    return out.numpy()


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode", ["simplified", "svd"])
def test_sharded_sampler_matches_unsharded_and_jax(runs, mode, shards):
    r = runs[mode]
    seen = []

    def spy(model):
        def model_fn(x, t):
            seen.append((threading.current_thread().name, x.shape[0]))
            return model(x, t)
        return model_fn

    ours = _port(mode, Replicas([spy(r["model"])] * shards), r["op"], r["xt"], r["y"],
                 make_mesh(shards, device="cpu"))
    # each shard ran its own batch, in turn, on the caller's thread
    assert seen == [(threading.current_thread().name, 8 // shards)] * (3 * shards)
    k = 8 // shards
    alone = np.concatenate([_port(mode, r["model"], r["op"], r["xt"][i:i + k],
                                  r["y"][i:i + k]) for i in range(0, 8, k)])
    assert np.array_equal(ours, alone)
    assert float(np.abs(ours - r["single"]).max()) <= 1e-4
    assert float(np.abs(ours - r["jax"]).max()) <= 1e-3
    assert np.abs(ours).max() > 0.1


def test_sharded_sampler_runs_a_batch_it_cannot_split_unsharded(runs, caplog, fresh_warnings):
    r = runs["simplified"]
    ours = _port("simplified", r["model"], r["op"], r["xt"][:3], r["y"][:3],
                 make_mesh(2, device="cpu"))
    assert np.array_equal(ours, _port("simplified", r["model"], r["op"], r["xt"][:3],
                                      r["y"][:3]))
    assert "does not divide dimension 3" in caplog.text


def _write_images(d: Path, n: int) -> Path:
    from ddnm_tpu_torch.data.io import save_image

    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        save_image(rng.uniform(size=(32, 32, 3)).astype(np.float32), d / f"{i}.png")
    return d


def test_runner_takes_the_process_slice(tmp_path, monkeypatch):
    """Process 1 of 2 over 5 images takes items 3 and 4 and keeps their
    global indices (tests/test_cli_and_parallel.py's JAX counterpart)."""
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.runner import RunArgs, Runner

    d = _write_images(tmp_path / "imgs", 5)
    config = load_config(REPO / "configs" / "toy32.yml")
    make = lambda: RunArgs(config="configs/toy32.yml", deg="sr_averagepooling", path_y=str(d),
                           image_folder=str(tmp_path / "o"), simplified=True,
                           random_init=True, device="cpu")
    every = Runner(make(), config).build_dataset().paths
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    args = make()
    runner = Runner(args, config)
    assert runner.mesh is None and runner.device.type == "cpu"
    assert runner.build_dataset().paths == every[3:5]
    assert args.subset_start == 3


@pytest.mark.parametrize("flags", [
    ["--simplified"],
    ["--simplified", "--solver", "multistep"],
    ["--simplified", "--encoder_cache", "2"],
    ["--deg", "cs_walshhadamard", "--deg_scale", "0.25"],
], ids=["simplified", "multistep", "encoder_cache", "svd"])
def test_runner_on_a_mesh_equals_its_shards_alone(tmp_path, monkeypatch, flags):
    """main_torch on a CPU mesh of 2 at batch 4: the PNGs byte-equal to an
    unsharded run at batch 2, each shard's batch (every route the JAX
    runner shards: simplified, the multistep solver, the encoder cache, SVD;
    the guided route: tests/test_torch_guidance.py's Runner on TOY_CC)."""
    import main_torch

    common = ["--config", "configs/toy32.yml", "--path_y", "toy32", "--deg",
              "sr_averagepooling", "--ckpt", str(REPO / "tests" / "fixtures" / "toy_ddpm32.pt"),
              "--device", "cpu", "--max_images", "4", "--t_sampling", "3", "--ni", "--verbose",
              "warning", "--exp", str(REPO / "exp"), *flags]
    from ddnm_tpu_torch import runner

    calls = []
    real = runner.sharded_sampler
    monkeypatch.setattr(runner, "sharded_sampler",
                        lambda fn, mesh: calls.append(fn.__name__) or real(fn, mesh))
    sharded = main_torch.main(common + ["--batch_size", "4", "-i", str(tmp_path / "mesh")],
                              mesh=make_mesh(2, device="cpu"))
    assert calls  # every batch went through the mesh
    alone = main_torch.main(common + ["--batch_size", "2", "-i", str(tmp_path / "alone")])
    assert sharded["num_samples"] == alone["num_samples"] == 4
    for i in range(4):
        assert ((tmp_path / "mesh" / f"{i}_0.png").read_bytes()
                == (tmp_path / "alone" / f"{i}_0.png").read_bytes())


def test_guided_runner_on_a_mesh_equals_its_shards_alone(tmp_path):
    """The guided SVD route (a class-conditional ADM and its classifier,
    tests/_torch_port.py TOY_CC_CONFIG) on a CPU mesh of 2 at batch 2,
    against the unsharded run at batch 1."""
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.runner import RunArgs, Runner
    from tests._torch_port import write_toy_cc_config

    cfg_path = write_toy_cc_config(tmp_path / "cc.yml")
    d = tmp_path / "imgs"
    d.mkdir()
    from ddnm_tpu_torch.data.io import save_image

    rng = np.random.default_rng(1)
    for i in range(2):
        save_image(rng.uniform(size=(64, 64, 3)).astype(np.float32), d / f"{i}.png")
    runs = {}
    for name, batch, mesh in (("mesh", 2, make_mesh(2, device="cpu")), ("alone", 1, None)):
        args = RunArgs(config=str(cfg_path), deg="sr_averagepooling", path_y=str(d),
                       image_folder=str(tmp_path / name), random_init=True, device="cpu",
                       batch_size=batch)
        runner = Runner(args, load_config(cfg_path), mesh=mesh)
        assert runner.config.model.class_cond and runner.config.classifier is not None
        runs[name] = runner.run()
    for i in range(2):
        assert ((tmp_path / "mesh" / f"{i}_0.png").read_bytes()
                == (tmp_path / "alone" / f"{i}_0.png").read_bytes())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_restore_each_image_once(tmp_path, monkeypatch):
    """main_torch.py --device cpu as two ranks (gloo on 127.0.0.1) over 5
    toy32 images into one folder: every image once, under its global
    name, within 1 level of a single-process run; each rank's metrics in
    its own file."""
    import main_torch
    from ddnm_tpu_torch.data.io import load_image

    common = ["--config", "configs/toy32.yml", "--path_y", "toy32", "--deg",
              "sr_averagepooling", "--simplified", "--ckpt",
              str(REPO / "tests" / "fixtures" / "toy_ddpm32.pt"), "--device", "cpu",
              "--max_images", "5", "--batch_size", "2", "--t_sampling", "4", "--ni",
              "--verbose", "warning", "--exp", str(REPO / "exp")]
    out = tmp_path / "ranks"
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "main_torch.py"), *common, "-i", str(out)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for clean in LAUNCH_VARS:
        monkeypatch.delenv(clean, raising=False)
    single = main_torch.main(common + ["-i", str(tmp_path / "single")])
    results = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, results):
        assert p.returncode == 0, se[-3000:]
    assert "Number of samples: 3" in results[0][0] and "Number of samples: 2" in results[1][0]
    assert single["num_samples"] == 5
    assert sorted(f.name for f in out.glob("*_0.png")) == [f"{i}_0.png" for i in range(5)]
    assert (out / "metrics_rank0.jsonl").exists() and (out / "metrics_rank1.jsonl").exists()
    for i in range(5):
        a = np.round(load_image(out / f"{i}_0.png") * 255)
        b = np.round(load_image(tmp_path / "single" / f"{i}_0.png") * 255)
        assert np.abs(a - b).max() <= 1


def test_groupnorm_counters_are_per_stream():
    """Two streams of one device get launch counters of their own (a
    stand-in stream key on the CPU); a key keeps its buffer until a launch
    needs more, and growing one key's leaves the other's."""
    from ddnm_tpu_torch.ops import groupnorm

    cpu = torch.device("cpu")
    a, b = groupnorm._counters(cpu, 16, stream=101), groupnorm._counters(cpu, 16, stream=102)
    assert a.data_ptr() != b.data_ptr() and not a.any() and not b.any()
    assert groupnorm._counters(cpu, 4096, stream=101) is a
    grown = groupnorm._counters(cpu, 5000, stream=101)
    assert grown.numel() >= 5000 and grown is not a
    assert groupnorm._counters(cpu, 16, stream=102) is b
    for key in ((None, 101), (None, 102)):
        groupnorm._COUNTERS.pop(key)


def test_launch_counts_are_per_shard():
    """Launches made under a shard's tag count under it too (ops.
    tagged_launch_counts), those of another thread included (autograd
    runs a backward on its device thread while the caller waits); a launch
    outside a tag counts in the total alone, and a reset clears both."""
    from ddnm_tpu_torch import ops
    from ddnm_tpu_torch.ops import _build, groupnorm

    ops.reset_launch_counts()
    for i in range(3):
        with _build.launch_tag(i):
            for _ in range(i + 1):
                _build.count_launch(groupnorm.LAUNCHES, "groupnorm_stats")
            t = threading.Thread(target=_build.count_launch,
                                 args=(groupnorm.LAUNCHES, "groupnorm_apply"))
            t.start()
            t.join(timeout=60)
    _build.count_launch(groupnorm.LAUNCHES, "groupnorm_apply")  # no tag
    counts = ops.launch_counts()
    assert counts["groupnorm_stats"] == 6 and counts["groupnorm_apply"] == 4
    tagged = ops.tagged_launch_counts()
    assert sorted(tagged) == [0, 1, 2]
    assert all(t["groupnorm_stats"] == i + 1 and t["groupnorm_apply"] == 1
               and t["attention"] == 0 for i, t in tagged.items())
    ops.reset_launch_counts()
    assert ops.tagged_launch_counts() == {} and not any(ops.launch_counts().values())


def test_clone_generator_draws_the_same_numbers():
    from ddnm_tpu_torch.parallel.mesh import clone_generator

    g = torch.Generator().manual_seed(7)
    torch.randn(5, generator=g)
    h = clone_generator(g, "cpu")
    assert torch.equal(torch.randn(9, generator=g), torch.randn(9, generator=h))
