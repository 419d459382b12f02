"""hq_evaluation_torch.py against hq_evaluation.py: the same runs, each the
JAX CLI's hq_main argv with `--device` added (the dry runs of
tests/test_aux_subsystems.py carried over), and the same refusal of a lone
--face_gt / --face_masks."""

import re

import numpy as np
import pytest

import hq_evaluation as jev
import hq_evaluation_torch as tev
from ddnm_tpu.data.io import save_image


def _runs(out: str, cli: str) -> list[str]:
    return re.findall(rf"^== .*?: {cli} (.*)$", out, flags=re.M)


@pytest.mark.parametrize("args", [
    ["--encoder_cache", "3", "--dtype", "bfloat16"],
    ["--demos", "bear,zebra", "--ckpt", "m.pt", "--classifier_ckpt", "c.pt",
     "--parallel_tiles"],
], ids=["all_demos", "filtered"])
def test_demo_dry_run_is_jax_argv_plus_device(args, tmp_path, capsys):
    rng = np.random.default_rng(0)
    for name, _, _ in jev.DEMOS[:-1]:  # zebra missing: skipped by both
        save_image(rng.uniform(size=(32, 32, 3)).astype(np.float32), tmp_path / f"{name}.png")
    common = ["--dry-run", "--random-init", "--data", str(tmp_path),
              "-i", str(tmp_path / "out")] + args
    jev.main(common)
    ref = _runs(capsys.readouterr().out, "hq_main.py")
    assert tev.main(common + ["--device", "cpu"]) == {}
    out = capsys.readouterr().out
    ours = _runs(out, "hq_main_torch.py")
    assert ours == [r + " --device cpu" for r in ref] and ours
    assert "zebra" in out and "missing, skipped" in out
    assert tev.DEMOS == jev.DEMOS


@pytest.mark.parametrize("args", [
    ["--face_gt", "G", "--face_masks", "M", "--max_len", "2", "--sweep_batch", "2",
     "--dtype", "bfloat16"],
    ["--face_config", "configs/hq/face256.yml", "--ckpt", "f.pt", "--encoder_cache", "2"],
], ids=["overrides", "conf_trees"])
def test_face_sweep_dry_run_is_jax_argv_plus_device(args, tmp_path, capsys):
    common = ["--dry-run", "--random-init", "--face_sweep", "-i", str(tmp_path / "out")] + args
    jev.main(common)
    ref = _runs(capsys.readouterr().out, "hq_main.py")
    tev.main(common + ["--device", "cpu"])
    ours = _runs(capsys.readouterr().out, "hq_main_torch.py")
    assert len(ref) == 1 and ours == [ref[0] + " --device cpu"]
    assert "--deg inpainting" in ours[0]


@pytest.mark.parametrize("flag", ["--face_gt", "--face_masks"])
def test_face_sweep_rejects_lone_override(flag, tmp_path):
    """--face_gt / --face_masks come together: defaulting one to the other
    would threshold gt photos into keep-masks."""
    with pytest.raises(SystemExit, match="together"):
        tev.main(["--dry-run", "--random-init", "--face_sweep", "--device", "cpu",
                  "-i", str(tmp_path / "out"), flag, str(tmp_path / "x")])
