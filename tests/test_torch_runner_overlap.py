"""The runner's host overlap (ddnm_tpu_torch/runner.py: decode ahead, drain
behind on a thread pool), iterate_batches' prefetch, MetricsLogger and
main_torch's --trace_dir and --loop, on the CPU at toy size (the trained
toy32 DDPM, 3 steps, 7 images of exp/datasets/toy32 so the last batch is
a tail).

Tolerances: the PNGs the overlapped runner writes are byte-equal to those
of a direct, serial sampler call on the same generators at each batch size
(1, 3 and 4); across batch sizes they agree within one uint8 level (CPU
convolutions at batch 1 round differently from batch 3 and 4, in the
serial runner too); prefetched batches equal synchronous ones exactly; the
metrics lines carry JAX's keys exactly."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ddnm_tpu_torch.config import load_config
from ddnm_tpu_torch.data.datasets import FolderDataset, iterate_batches
from ddnm_tpu_torch.data.io import decode_png, encode_png
from ddnm_tpu_torch.data.transforms import data_transform, inverse_data_transform
from ddnm_tpu_torch.runner import RunArgs, Runner
from ddnm_tpu_torch.sampling import sample_simplified
from ddnm_tpu_torch.sampling.rng import (
    STREAM_INIT,
    STREAM_SAMPLE,
    default_noise,
    image_generators,
)
from tests._torch_port import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TOY_DIR = REPO / "exp" / "datasets" / "toy32"
CKPT = REPO / "tests" / "fixtures" / "toy_ddpm32.pt"


def _runner(out: Path, batch: int, **kw) -> Runner:
    config = load_config(REPO / "configs" / "toy32.yml")
    config.time_travel.T_sampling = 3
    args = RunArgs(config=str(REPO / "configs" / "toy32.yml"), deg="sr_averagepooling",
                   deg_scale=4.0, path_y=str(TOY_DIR), image_folder=str(out), simplified=True,
                   ckpt=str(CKPT), batch_size=batch, max_images=7, device="cpu", **kw)
    return Runner(args, config)


def _q(img01) -> bytes:
    """save_image's bytes of a [0, 1] image."""
    return encode_png(np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8))


def _serial(runner: Runner) -> dict:
    """{file name: PNG bytes} of the serial loop on the same generators:
    sample, then A+y, orig and x written one image after another."""
    model, op, ds = runner.build_model(), runner.build_operator(), runner.build_dataset()
    seed, size = runner.args.seed, runner.config.data.image_size
    files, idx0 = {}, 0
    for imgs, _, valid in iterate_batches(ds, runner.batch_size, prefetch=0):
        n = len(imgs)
        idxs = range(idx0, idx0 + n)
        x_orig = data_transform(torch.from_numpy(imgs))
        x_init = default_noise(image_generators(seed, idxs, STREAM_INIT, "cpu"),
                               (n, size, size, 3))
        y = op.A(x_orig)
        x, _ = sample_simplified(model, x_init, y, op, runner.sched,
                                 image_generators(seed, idxs, STREAM_SAMPLE, "cpu"),
                                 eta=runner.args.eta, sigma_y=0.0)
        for i in range(valid):
            files[f"Apy/Apy_{idx0 + i}.png"] = _q(inverse_data_transform(op.Ap(y))[i])
            files[f"Apy/orig_{idx0 + i}.png"] = _q(inverse_data_transform(x_orig)[i])
            files[f"{idx0 + i}_0.png"] = _q(inverse_data_transform(x)[i])
        idx0 += valid
    return files


def _written(out: Path) -> dict:
    return {p.relative_to(out).as_posix(): p.read_bytes() for p in sorted(out.rglob("*.png"))}


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_overlapped_runner_writes_the_serial_bytes(tmp_path, batch):
    out = tmp_path / f"b{batch}"
    runner = _runner(out, batch)
    stats = runner.run()
    got = _written(out)
    assert stats["num_samples"] == 7 and len(got) == 21
    assert got == _serial(runner)
    assert stats["sample_seconds"] > 0 and 0.0 <= stats["range_space_max_abs"] <= 1e-4
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["images"] for r in rows] == [min(batch * (k + 1), 7) for k in range(len(rows))]
    if batch == 4:  # within one level of batch 3's images (see the docstring)
        _runner(tmp_path / "b3", 3).run()
        other = _written(tmp_path / "b3")
        for name, data in got.items():
            a, b = decode_png(data).astype(int), decode_png(other[name]).astype(int)
            assert np.abs(a - b).max() <= 1, name


@pytest.mark.parametrize("prefetch,workers", [(2, 4), (1, 1), (5, 2)])
def test_prefetch_yields_the_synchronous_batches(prefetch, workers):
    ds = FolderDataset(TOY_DIR, 32)
    ds.paths = ds.paths[:7]
    want = list(iterate_batches(ds, 3, prefetch=0))
    got = list(iterate_batches(ds, 3, prefetch=prefetch, num_workers=workers))
    assert [v for *_, v in got] == [v for *_, v in want] == [3, 3, 1]
    for (a, la, _), (b, lb, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    assert got[-1][0].shape == (3, 32, 32, 3)  # the tail padded by repetition


def test_metrics_logger_lines_match_jax(tmp_path):
    """The same logkv / logkv_mean calls give JAX's line: the same keys
    (ts first, the rest sorted) and values."""
    from ddnm_tpu.utils.observability import MetricsLogger as JMetricsLogger
    from ddnm_tpu_torch.utils.observability import MetricsLogger

    lines = {}
    for name, cls in (("jax", JMetricsLogger), ("port", MetricsLogger)):
        m = cls(tmp_path / name / "metrics.jsonl")
        m.logkv_mean("psnr", 30.0)
        m.logkv_mean("psnr", 32.0)
        m.logkv_mean("ssim", 0.5)
        m.logkv("images", 3)
        m.logkv("images_per_sec", 1.5)
        assert m.dumpkvs() == {"images": 3, "images_per_sec": 1.5, "psnr": 31.0, "ssim": 0.5}
        assert m.dumpkvs() == {}  # cleared
        m.close()
        lines[name] = json.loads((tmp_path / name / "metrics.jsonl").read_text())
    assert list(lines["port"]) == list(lines["jax"]) == ["ts", "images", "images_per_sec",
                                                         "psnr", "ssim"]
    assert {k: v for k, v in lines["port"].items() if k != "ts"} == \
        {k: v for k, v in lines["jax"].items() if k != "ts"}


def test_main_torch_trace_dir_and_loop(tmp_path):
    """--trace_dir writes a Chrome trace of the run on the CPU; --loop is
    accepted (every choice runs the one eager loop); the runner's metrics
    lines have JAX's keys; a bad loop name raises as the JAX sampler does."""
    import main_torch

    ns = main_torch.parse_args(["--config", "configs/toy32.yml", "--deg", "x", "--loop", "scan"])
    assert ns.loop == "scan" and ns.trace_dir is None
    out = tmp_path / "out"
    stats = main_torch.main([
        "--config", str(REPO / "configs" / "toy32.yml"), "--path_y", str(TOY_DIR),
        "--deg", "sr_averagepooling", "--simplified", "--ckpt", str(CKPT), "--t_sampling", "2",
        "--batch_size", "2", "--max_images", "3", "-i", str(out), "--ni", "--device", "cpu",
        "--trace_dir", str(tmp_path / "trace"), "--loop", "host", "--verbose", "warning"])
    assert stats["num_samples"] == 3
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    rows = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in rows] == [["images", "images_per_sec", "psnr", "ssim", "ts"]] * 2
    with pytest.raises(ValueError, match="auto|host|scan"):
        _runner(tmp_path / "bad", 1, loop="vectorized")


def test_profile_none_and_step_timer():
    from ddnm_tpu_torch.utils.observability import StepTimer, profile

    with profile(None) as prof:
        assert prof is None
    timer = StepTimer()
    timer.start()
    timer.stop({"x": torch.ones(2)}, items=4)
    timer.start()
    timer.stop([torch.ones(1)], items=4)
    assert timer.steps == 2 and timer.items == 8 and timer.items_per_sec() > 0
