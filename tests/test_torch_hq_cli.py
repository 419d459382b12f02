"""The hq config layer, the sweep's pair loader and hq_main_torch.py on the
CPU.

The CLI runs in process with --device cpu on a toy32 hq config written
here (the toy32 ADM of tests/fixtures/toy_adm32.pt, 32 px tiles, the
golden protocol's schedule), in single-image and in sweep mode. Without
--device it needs a card, and raises without one.

Tolerances: configs and pair lists exactly equal to the JAX package's;
pair pixels exactly equal (the same uint8 round trip); the batched sweep
within 1e-3 dB PSNR and one 8-bit level of the per-image sweep (a batch of
2 convolves in another order than batch 1 on the CPU)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import hq_main_torch
from ddnm_tpu.config import load_hq_config as j_load_hq_config
from ddnm_tpu.data.inpaint_pairs import InpaintPairs as JInpaintPairs
from ddnm_tpu_torch.config import HQConfig, load_hq_config
from ddnm_tpu_torch.data.inpaint_pairs import InpaintPairs
from ddnm_tpu_torch.data.io import load_image, save_image
from tests._torch_port import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TOY_PT = REPO / "tests" / "fixtures" / "toy_adm32.pt"
TOY_CONF = """\
name: toy32
image_size: 32
class_cond: {class_cond}
learn_sigma: true
diffusion_steps: 1000
noise_schedule: linear
timestep_respacing: "25"
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
classifier_scale: {classifier_scale}
schedule_jump_params:
  t_T: 25
  n_sample: 1
  jump_length: 10
  jump_n_sample: 2
model_path: null
"""


@pytest.mark.parametrize("name", ["adm128", "face256", "inet256", "smoke"])
def test_load_hq_config_matches_jax(name):
    path = REPO / "configs" / "hq" / f"{name}.yml"
    ours, ref = load_hq_config(path), j_load_hq_config(path)
    assert isinstance(ours, HQConfig) and dict(ours) == dict(ref)
    for key in ours:
        assert type(ours[key]) is type(ref[key]), key
    assert ours.no_such_key is None and ours.timestep_respacing == ref.timestep_respacing
    for dotted in ("schedule_jump_params.t_T", "data.eval.paper_face_mask.gt_path",
                   "data.eval", "name.x", "missing.key"):
        assert ours.pget(dotted) == ref.pget(dotted)
    assert ours.pget("missing", 7) == 7


def _toy_tree(root: Path, n: int = 2) -> tuple[Path, Path]:
    """n toy32 images and keep-masks (a different hole each) under root."""
    gts, masks = root / "gts", root / "masks"
    for i, p in enumerate(sorted((REPO / "exp/datasets/toy32").glob("*.png"))[:n]):
        save_image(load_image(p), gts / f"im{i}.png")
        m = np.ones((32, 32), np.float32)
        m[4 + 6 * i:16 + 6 * i, 8:24] = 0.0
        save_image(m, masks / f"im{i}.png")
    return gts, masks


def test_inpaint_pairs_match_jax(tmp_path):
    face = REPO / "exp/datasets/face"
    ours = InpaintPairs(face / "gts", face / "gt_keep_masks", image_size=256, max_len=2)
    ref = JInpaintPairs(face / "gts", face / "gt_keep_masks", image_size=256, max_len=2)
    assert [(a.name, b.name) for a, b in ours.pairs] == [(a.name, b.name) for a, b in ref.pairs]
    for a, b in zip(ours, ref):
        assert a["GT_name"] == b["GT_name"]
        assert np.array_equal(a["GT"], b["GT"]) and a["GT"].dtype == b["GT"].dtype
        assert np.array_equal(a["gt_keep_mask"], b["gt_keep_mask"])
    # a partial name overlap pairs the sorted trees by position
    gts, masks = _toy_tree(tmp_path, 2)
    (masks / "im1.png").rename(masks / "zz.png")
    kw = dict(image_size=32)
    assert ([(a.name, b.name) for a, b in InpaintPairs(gts, masks, **kw).pairs]
            == [(a.name, b.name) for a, b in JInpaintPairs(gts, masks, **kw).pairs]
            == [("im0.png", "im0.png"), ("im1.png", "zz.png")])
    # an image of another size is centre-cropped (here scaled up) as JAX does
    a, b = InpaintPairs(gts, masks, image_size=64)[1], JInpaintPairs(gts, masks, image_size=64)[1]
    assert a["GT"].shape == (64, 64, 3)
    assert np.array_equal(a["GT"], b["GT"]) and np.array_equal(a["gt_keep_mask"], b["gt_keep_mask"])
    with pytest.raises(FileNotFoundError):
        InpaintPairs(tmp_path / "none", masks)


# the toy classifier of a guided toy32 hq config (hq_main.py
# build_classifier_from_hq: classifier_channel_mult for a non-standard size)
TOY_CLASSIFIER = """\
classifier_width: 32
classifier_depth: 1
classifier_attention_resolutions: "16"
classifier_channel_mult: "1,2"
classifier_pool: attention
classifier_use_scale_shift_norm: true
classifier_resblock_updown: true
"""


@pytest.fixture
def toy_conf(tmp_path):
    def write(class_cond="false", classifier_scale="0.0"):
        path = tmp_path / f"toy_{class_cond}_{classifier_scale}.yml"
        path.write_text(TOY_CONF.format(class_cond=class_cond, classifier_scale=classifier_scale)
                        + TOY_CLASSIFIER)
        return path
    return write


def test_single_image_writes_the_output_tree(tmp_path, toy_conf):
    img = load_image(sorted((REPO / "exp/datasets/natural64").glob("*.png"))[0])[:48, :48]
    save_image(img.reshape(12, 4, 12, 4, 3).mean(axis=(1, 3)), tmp_path / "y.png")
    out_dir = tmp_path / "out"
    out = hq_main_torch.main([
        "--config", str(toy_conf()), "--path_y", str(tmp_path / "y.png"), "--resize_y",
        "--deg", "sr_averagepooling", "--scale", "4", "--ckpt", str(TOY_PT),
        "--device", "cpu", "-i", str(out_dir)])
    assert sorted(p.name for p in out_dir.glob("*.png")) == ["Apy.png", "final.png", "y.png"]
    assert sorted(p.name for p in (out_dir / "tiles").glob("*.png")) == [
        "0_0.png", "0_1.png", "1_0.png", "1_1.png"]
    assert out["final"].shape == (1, 48, 48, 3) and np.isfinite(out["final"]).all()
    assert out["stats"]["tiles"] == 4 and out["stats"]["model_calls"] == 4 * 45
    pooled = out["final"].reshape(1, 12, 4, 12, 4, 3).mean(axis=(2, 4))
    assert np.abs(pooled - out["y"]).max() <= 1e-5  # A(final) = y


def test_sweep_batched_matches_per_image(tmp_path, toy_conf):
    gts, masks = _toy_tree(tmp_path, 2)
    common = ["--config", str(toy_conf()), "--deg", "inpainting", "--gt_path", str(gts),
              "--mask_path_dir", str(masks), "--ckpt", str(TOY_PT), "--device", "cpu"]
    runs = {}
    for batch in (1, 2):
        out_dir = tmp_path / f"out{batch}"
        runs[batch] = hq_main_torch.main(common + ["--sweep_batch", str(batch),
                                                   "-i", str(out_dir)])
        for sub in ("srs", "lrs", "gts", "gt_keep_masks"):
            assert sorted(p.name for p in (out_dir / sub).glob("*.png")) == [
                "im0.png", "im1.png"], sub
    assert (tmp_path / "out1" / "tiles").exists() and not (tmp_path / "out2" / "tiles").exists()
    np.testing.assert_allclose(runs[2]["psnr"], runs[1]["psnr"], atol=1e-3)
    assert min(runs[1]["psnr"]) > 20.0  # a restoration
    for name in ("im0.png", "im1.png"):
        a = load_image(tmp_path / "out1" / "srs" / name)
        b = load_image(tmp_path / "out2" / "srs" / name)
        assert np.abs(a - b).max() <= 1.0 / 255 + 1e-6
        assert np.array_equal(load_image(tmp_path / "out1" / "gts" / name),
                              load_image(gts / name))


def test_sweep_from_the_conf_data_eval(tmp_path, toy_conf):
    gts, masks = _toy_tree(tmp_path, 2)
    conf = toy_conf()
    conf.write_text(conf.read_text() + (
        f"data:\n  eval:\n    toy:\n      gt_path: {gts}\n      mask_path: {masks}\n"
        f"      image_size: 32\n      max_len: 1\n      paths:\n"
        f"        srs: {tmp_path / 'mine'}\n"))
    out = hq_main_torch.main(["--config", str(conf), "--deg", "inpainting", "--ckpt",
                              str(TOY_PT), "--device", "cpu", "-i", str(tmp_path / "o")])
    assert len(out["psnr"]) == 1 and out["tree"]["srs"] == tmp_path / "mine"
    assert [p.name for p in (tmp_path / "mine").glob("*.png")] == ["im0.png"]
    assert (tmp_path / "o" / "lrs" / "im0.png").exists()


def hq_pair(tmp_path, monkeypatch, conf, flags: list) -> tuple[dict, dict]:
    """hq_main_torch (--device cpu) and the JAX package's hq_main.py in
    process on `conf`: 4x SR with --resize_y of a 12 x 12 PNG (a 48 x 48
    canvas of 2 x 2 toy32 tiles), `flags` appended, every normal draw of
    both one pattern (tests/_torch_port.py shared_noise). Returns (port
    output, JAX output)."""
    import hq_main as j_hq_main
    from tests._torch_port import shared_noise

    img = load_image(sorted((REPO / "exp/datasets/natural64").glob("*.png"))[0])[:48, :48]
    save_image(img.reshape(12, 4, 12, 4, 3).mean(axis=(1, 3)), tmp_path / "y.png")
    shared_noise(monkeypatch)
    common = ["--config", str(conf), "--path_y", str(tmp_path / "y.png"), "--resize_y",
              "--deg", "sr_averagepooling", "--scale", "4", "--ckpt", str(TOY_PT), *flags]
    ours = hq_main_torch.main(common + ["--device", "cpu", "-i", str(tmp_path / "port")])
    ref = j_hq_main.main(common + ["-i", str(tmp_path / "jax")])
    return ours, ref


@pytest.mark.parametrize("flags,conf_kw,err", [
    # ported: each runs and agrees with hq_main.py (ids kept from when they
    # raised NotImplementedError)
    pytest.param(["--solver", "multistep"], {}, None, id="flags0-conf_kw0-multistep"),
    pytest.param(["--encoder_cache", "2"], {}, None, id="flags1-conf_kw1-encoder_cache"),
    # --sp 2 runs as two processes (tests/test_torch_spatial.py); in one
    # process, without a process group, it names the launch it needs
    pytest.param(["--sp", "2"], {}, (RuntimeError, "torchrun --nproc_per_node 2"),
                 id="flags2-conf_kw2-mesh"),
    pytest.param(["--dp", "2"], {}, None, id="flags3-conf_kw3-mesh"),
    pytest.param(["--resume"], {}, None, id="flags4-conf_kw4-resume"),
])
def test_unported_paths_raise(tmp_path, toy_conf, flags, conf_kw, err, monkeypatch):
    """--sp 2 without a process group raises before writing anything; --solver
    multistep, --encoder_cache, --resume and --dp 2 (a CPU mesh of 2 against
    hq_main.py's on 2 of its virtual devices: the CLI's mesh and replicas;
    the canvas's wavefronts are single tiles, which run on the first entry,
    and test_torch_tiling.py holds a sharded group against JAX's) run,
    within 1e-4 of the JAX CLI's canvas (a --resume run that completes
    leaves no state)."""
    if err is None:
        ours, ref = hq_pair(tmp_path, monkeypatch, toy_conf(**conf_kw), flags)
        assert ours["final"].shape == ref["final"].shape == (1, 48, 48, 3)
        assert float(np.abs(ours["final"] - ref["final"]).max()) <= 1e-4
        assert not list((tmp_path / "port" / "tiles").glob("*.npz"))
        return
    exc, match = err
    with pytest.raises(exc, match=match):
        hq_main_torch.main(["--config", str(toy_conf(**conf_kw)), "--deg", "sr_averagepooling",
                            "--random_init", "--device", "cpu", "--path_y", "x.png",
                            "-i", str(tmp_path / "o")] + flags)
    assert not (tmp_path / "o").exists()


def test_guided_config_needs_a_classifier_checkpoint_or_random_init(tmp_path, toy_conf):
    """Classifier guidance is ported (class_cond with classifier_scale > 0):
    with a model checkpoint but neither --classifier_ckpt, the config's
    classifier_path nor --random_init, it raises FileNotFoundError where
    hq_main.py does, before writing anything (the guided run itself:
    tests/test_torch_guidance.py)."""
    from ddnm_tpu_torch.config import load_hq_config

    conf = toy_conf(class_cond="true", classifier_scale="1.0")
    ckpt = tmp_path / "cc.pt"
    torch.save(hq_main_torch.build_adm_from_hq(load_hq_config(conf)).state_dict(), ckpt)
    with pytest.raises(FileNotFoundError, match="classifier"):
        hq_main_torch.main(["--config", str(conf), "--deg", "sr_averagepooling",
                            "--ckpt", str(ckpt), "--device", "cpu", "--path_y", "x.png",
                            "-i", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_class_cond_unguided_config_runs(tmp_path, toy_conf):
    """class_cond with classifier_scale 0 is the unguided configuration:
    labels ride into the model, random weights from the seed, bf16."""
    img = load_image(sorted((REPO / "exp/datasets/toy32").glob("*.png"))[0])
    save_image(img, tmp_path / "gt.png")
    out = hq_main_torch.main(["--config", str(toy_conf(class_cond="true")),
                              "--deg", "colorization", "--path_y", str(tmp_path / "gt.png"),
                              "--class", "3", "--random_init", "--dtype", "bfloat16",
                              "--device", "cpu", "-i", str(tmp_path / "o")])
    assert out["stats"]["tiles"] == 1 and np.isfinite(out["final"]).all()


def test_without_device_cpu_it_raises_without_a_card(tmp_path, toy_conf):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, str(REPO / "hq_main_torch.py"), "--config", str(toy_conf()),
         "--deg", "sr_averagepooling", "--random_init", "--path_y", "x.png", "-i", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not out.exists()
