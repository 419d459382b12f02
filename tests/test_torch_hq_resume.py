"""Tile-granular checkpoint and resume of Mask-Shift tiling
(ddnm_tpu_torch/tiling.py `checkpoint_dir` / `resume`, hq_main_torch.py
--resume), the accelerators' routing through the tiling engine, and the
library's tile-init default for the multistep solver.

Gates: a run interrupted after 2 tiles and resumed equals the
uninterrupted run bit for bit (torch's CPU kernels are deterministic), in
the carry, fresh and wavefront orders, with stochastic noise; a state file
of another run (another image, seed, solver or encoder-cache policy) is
ignored with a warning; the state file is gone once a run completes;
batched_tile_sample with the accelerators within 1e-3 of per-image runs
(as tests/test_torch_tiling.py); the CLI's --resume equal to an
uninterrupted CLI run."""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import hq_main_torch
from ddnm_tpu_torch import schedules as sch
from ddnm_tpu_torch import tiling
from ddnm_tpu_torch.data.io import load_image, save_image
from ddnm_tpu_torch.models import ADMUNet
from ddnm_tpu_torch.runner import load_checkpoint
from ddnm_tpu_torch.sampling import accel
from ddnm_tpu_torch.sampling.posterior import build_posterior_tables
from tests._torch_port import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_hq_cli import TOY_CLASSIFIER, TOY_CONF

REPO = Path(__file__).resolve().parents[1]
TOY_PT = REPO / "tests" / "fixtures" / "toy_adm32.pt"
TOY_KW = json.loads((REPO / "tests/fixtures/toy_adm32.json").read_text())["adm_kw"]
# 8 model calls and 2 undo jumps a tile
SHORT = dict(betas=sch.named_beta_schedule("linear", 1000), timestep_respacing="6",
             schedule_jump_params=dict(t_T=6, n_sample=1, jump_length=2, jump_n_sample=2))
STATE = "mask_shift_state.npz"


@pytest.fixture(scope="module")
def toy():
    model = ADMUNet(**TOY_KW).eval()
    load_checkpoint(model, TOY_PT)
    return model


@pytest.fixture(scope="module")
def gt():
    img = load_image(sorted((REPO / "exp/datasets/natural64").glob("*.png"))[1])[:48, :48]
    return (img * 2.0 - 1.0)[None].astype(np.float32)


class Interrupt(Exception):
    pass


def _run(toy, gt, tables=None, *, stop_after=None, seed=0, **kw):
    """mask_shift_sample on the 48 x 48 canvas (2 x 2 tiles of 32); with
    `stop_after` the progress hook raises at the tile after that many."""
    seen = []

    def progress(t, x0):
        if stop_after is not None and len(seen) == stop_after:
            raise Interrupt
        seen.append(t.index)

    out = tiling.mask_shift_sample(lambda x, t: toy(x, t), gt, "sr_averagepooling",
                                   tables or build_posterior_tables(**SHORT), seed, scale=4,
                                   tile=32, stride=16, device="cpu", progress_fn=progress, **kw)
    return out, seen


@pytest.mark.parametrize("order", ["carry", "fresh", "wavefront"])
def test_interrupt_after_two_tiles_then_resume_equals_the_uninterrupted_run(
        toy, gt, tmp_path, order):
    kw = dict(parallel=True) if order == "wavefront" else dict(tile_init=order)
    full, _ = _run(toy, gt, **kw)
    with pytest.raises(Interrupt):
        _run(toy, gt, stop_after=2, checkpoint_dir=tmp_path, **kw)
    with np.load(tmp_path / STATE) as f:
        state = dict(f)
    assert sorted(map(tuple, state["done"].tolist())) == [(0, 0), (0, 1)]
    assert ("carry_x" in state) == (order == "carry")
    assert not list(tmp_path.glob("*.tmp.npz"))  # written atomically
    resumed, seen = _run(toy, gt, checkpoint_dir=tmp_path, resume=True, **kw)
    assert seen == [(1, 0), (1, 1)]  # the finished tiles are skipped
    assert np.array_equal(resumed["final"], full["final"])
    assert not (tmp_path / STATE).exists()  # the completed run leaves no state


@pytest.mark.parametrize("change", ["image", "seed", "solver", "policy", "salt"])
def test_a_state_of_another_run_is_ignored(toy, gt, tmp_path, caplog, change):
    """The run identity covers the image, the seed, the flags (the solver
    and the encoder-cache policy among them, where the JAX package hashes
    neither) and the caller's salt: a state written by a run that differs
    in one of them is ignored with a warning, and the run starts afresh."""
    split = dict(encode_fn=accel.adm_split_fns(toy)[0], decode_fn=accel.adm_split_fns(toy)[1])
    base = dict(tile_init="fresh", resume_salt=("class", 3))
    if change == "policy":
        base.update(encoder_cache=2, encoder_cache_policy="uniform", **split)
    with pytest.raises(Interrupt):
        _run(toy, gt, stop_after=2, checkpoint_dir=tmp_path, **base)
    assert (tmp_path / STATE).exists()
    other = dict(base)
    run_gt, seed = gt, 0
    if change == "image":
        run_gt = gt.copy()
        run_gt[0, 0, 0, 0] += 0.5
    elif change == "seed":
        seed = 1
    elif change == "solver":
        other["solver"] = "multistep"
    elif change == "policy":
        other["encoder_cache_policy"] = "end_dense"
    else:
        other["resume_salt"] = ("class", 4)
    with caplog.at_level(logging.WARNING, logger="ddnm_tpu_torch"):
        out, seen = _run(toy, run_gt, seed=seed, checkpoint_dir=tmp_path, resume=True, **other)
    assert "another run" in caplog.text
    assert len(seen) == 4  # every tile ran
    fresh, _ = _run(toy, run_gt, seed=seed, **other)
    assert np.array_equal(out["final"], fresh["final"])


def test_checkpoint_without_resume_starts_afresh_and_cleans_up(toy, gt, tmp_path):
    with pytest.raises(Interrupt):
        _run(toy, gt, stop_after=1, checkpoint_dir=tmp_path, tile_init="carry")
    out, seen = _run(toy, gt, checkpoint_dir=tmp_path, tile_init="carry")
    assert len(seen) == 4 and not (tmp_path / STATE).exists()
    assert np.array_equal(out["final"], _run(toy, gt, tile_init="carry")[0]["final"])


def test_multistep_tiles_start_fresh_by_default(toy, gt, monkeypatch):
    """With tile_init left None the library starts every tile of a
    multistep run from its own noise (the JAX package's default: the ODE
    solver needs each tile's init at the top noise level), and a ddim run
    carries the previous tile's state; the CLI passes its flag explicitly."""
    calls = []
    real = tiling._tile_init
    monkeypatch.setattr(tiling, "_tile_init", lambda *a: calls.append(a[2].index) or real(*a))
    _run(toy, gt, solver="multistep")
    assert calls == [(0, 0), (0, 1), (1, 0), (1, 1)]
    calls.clear()
    _run(toy, gt)
    assert calls == [(0, 0)]
    calls.clear()
    _run(toy, gt, solver="multistep", tile_init="carry")
    assert calls == [(0, 0)]


@pytest.mark.parametrize("kw", [dict(solver="multistep"),
                                dict(encoder_cache=3, encoder_cache_policy="end_dense")])
def test_batched_tile_sample_routes_the_accelerators(toy, kw):
    """Stochastic noise: image i of one batched call equals the per-image
    mask_shift_sample with the same accelerator (within 1e-3, a batch of 2
    convolving in another order than batch 1)."""
    if "encoder_cache" in kw:
        kw = dict(kw, **dict(zip(("encode_fn", "decode_fn"), accel.adm_split_fns(toy))))
    rng = np.random.default_rng(4)
    gts = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tables = build_posterior_tables(**SHORT)
    batched = tiling.batched_tile_sample(lambda x, t: toy(x, t), gts, "sr_averagepooling",
                                         tables, 5, [3, 4], tile=32, device="cpu", **kw)
    for i in range(2):
        single = tiling.mask_shift_sample(lambda x, t: toy(x, t), gts[i][None],
                                          "sr_averagepooling", tables, 5, image_index=3 + i,
                                          tile=32, stride=16, device="cpu", **kw)
        np.testing.assert_allclose(batched["final"][i], single["final"][0], atol=1e-3)


@pytest.mark.parametrize("fn", ["mask_shift_sample", "batched_tile_sample"])
def test_accelerator_refusals(toy, fn):
    gt = np.zeros((1, 32, 32, 3), np.float32)
    geometry = dict(stride=16) if fn == "mask_shift_sample" else {}
    run = lambda *a, **kw: getattr(tiling, fn)(*a, **geometry, **kw)
    tables = build_posterior_tables(**SHORT)
    enc, dec = accel.adm_split_fns(toy)
    with pytest.raises(ValueError, match="requires encode_fn and decode_fn"):
        run(None, gt, "sr_averagepooling", tables, 0, tile=32, device="cpu", encoder_cache=2)
    with pytest.raises(ValueError, match="does not compose"):
        run(None, gt, "sr_averagepooling", tables, 0, tile=32, device="cpu", encoder_cache=2,
            encode_fn=enc, decode_fn=dec, solver="multistep")
    with pytest.raises(ValueError, match="unknown solver"):
        run(lambda x, t: toy(x, t), gt, "sr_averagepooling", tables, 0, tile=32,
            device="cpu", solver="heun")


def test_hq_main_torch_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    """hq_main_torch --resume: a run stopped while writing its third tile
    PNG goes on from the state under its tiles folder, and its canvas
    equals an uninterrupted run's bit for bit (stochastic noise; carry)."""
    import ddnm_tpu_torch.data.io as io

    conf = tmp_path / "toy.yml"
    conf.write_text(TOY_CONF.format(class_cond="false", classifier_scale="0.0")
                    .replace('timestep_respacing: "25"', 'timestep_respacing: "6"')
                    .replace("t_T: 25", "t_T: 6").replace("jump_length: 10", "jump_length: 2")
                    + TOY_CLASSIFIER)
    img = load_image(sorted((REPO / "exp/datasets/natural64").glob("*.png"))[0])[:48, :48]
    save_image(img.reshape(12, 4, 12, 4, 3).mean(axis=(1, 3)), tmp_path / "y.png")
    argv = ["--config", str(conf), "--path_y", str(tmp_path / "y.png"), "--resize_y", "--deg",
            "sr_averagepooling", "--scale", "4", "--ckpt", str(TOY_PT), "--device", "cpu"]
    full = hq_main_torch.main(argv + ["-i", str(tmp_path / "full")])

    real_save = io.save_image
    tiles_written = []

    def save_or_stop(img, path):
        if Path(path).parent.name == "tiles":
            if len(tiles_written) == 2:
                raise Interrupt
            tiles_written.append(Path(path).name)
        real_save(img, path)

    monkeypatch.setattr(io, "save_image", save_or_stop)
    with pytest.raises(Interrupt):
        hq_main_torch.main(argv + ["--resume", "-i", str(tmp_path / "run")])
    assert (tmp_path / "run" / "tiles" / STATE).exists()
    monkeypatch.setattr(io, "save_image", real_save)
    out = hq_main_torch.main(argv + ["--resume", "-i", str(tmp_path / "run")])
    assert out["stats"]["tiles"] == 2  # the two that were left
    assert np.array_equal(out["final"], full["final"])
    assert not (tmp_path / "run" / "tiles" / STATE).exists()
    assert sorted(p.name for p in (tmp_path / "run" / "tiles").glob("*.png")) == [
        "0_0.png", "0_1.png", "1_0.png", "1_1.png"]
