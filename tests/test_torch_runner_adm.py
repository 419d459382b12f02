"""The port's main runner on the ADM UNet (model type "openai"): the six
ImageNet rows of evaluation.py on the trained toy32 ADM against the JAX
package's golden (tests/fixtures/toy_adm32_main_golden.json, written by
tools/emit_toy_adm32_main_golden.py), main_torch and evaluation_torch end
to end on the CPU, and classifier guidance wherever the JAX runner guides.

Gates: every image's PSNR within 0.01 dB of the golden's (fp32 on both
sides, zero noise, shared x_T, 20 steps); the golden's rows recomputed with
the JAX package within 1e-3 dB of the file (the same computation on the
same host)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tests._torch_port import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
GOLDEN = json.loads(chip_smoke.TOY_ADM_MAIN_GOLDEN.read_text())
PROTO = GOLDEN["protocol"]
TASKS = {t[0]: t for t in PROTO["tasks"]}


def _write_config(path: Path, **model) -> Path:
    """The golden's toy32 openai config as YAML, with `model` overrides."""
    conf = json.loads(json.dumps(PROTO["config"]))
    conf["model"].update(model)
    lines = []
    for section, body in conf.items():
        items = ", ".join(f"{k}: {json.dumps(v) if isinstance(v, str) else str(v).lower() if isinstance(v, bool) else v}"
                          for k, v in body.items())
        lines.append(f"{section}: {{ {items} }}")
    path.write_text("\n".join(lines) + "\n")
    return path


def test_golden_spells_out_the_protocol():
    assert [t[0] for t in PROTO["tasks"]] == [
        r[0] for r in __import__("evaluation_torch").IMAGENET_RUNS]
    assert (PROTO["n_images"], PROTO["res"], PROTO["x_T_seed"], PROTO["noise"]) == (2, 32, 42,
                                                                                   "zero")
    assert PROTO["config"]["time_travel"]["T_sampling"] == 20 and PROTO["eta"] == 0.85
    for name in TASKS:
        psnrs = GOLDEN["tasks"][name]["per_image_psnr"]
        assert len(psnrs) == 2 and min(psnrs) > 18.0  # a trained model restores signal


@pytest.mark.parametrize("name", ["imagenet_sr_ap_4x", "imagenet_cs_wh_025"])
def test_golden_rows_recomputed_with_jax(name):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        from emit_toy_adm32_main_golden import PROTOCOL, run_task
    finally:
        sys.path.remove(str(REPO / "tools"))
    assert PROTOCOL == PROTO
    live = run_task(name)
    assert np.allclose(live, GOLDEN["tasks"][name]["per_image_psnr"], rtol=0, atol=1e-3)


def test_runner_builds_the_adm_model_operator_and_dataset():
    from ddnm_tpu_torch.data.datasets import FolderDataset
    from ddnm_tpu_torch.models import ADMUNet
    from ddnm_tpu_torch.operators.base import SVDOperator

    runner = chip_smoke.main_golden_runner(PROTO, TASKS["imagenet_inpainting"], "cpu")
    model = runner.build_model()
    assert isinstance(model, ADMUNet) and runner.model_fn(model) is model
    assert model.out[2].out_channels == 6 and model.num_classes is None
    op = runner.build_operator()
    assert isinstance(op, SVDOperator)
    ds = runner.build_dataset()
    assert isinstance(ds, FolderDataset) and ds.crop == "center_arr" and len(ds) == 8
    assert [p.name for p in ds.paths[:2]] == ["00000.png", "00001.png"]  # not shuffled
    x = torch.zeros(2, 32, 32, 3)
    assert runner.model_fn(model)(x, torch.full((2,), 10.0)).shape == (2, 32, 32, 6)


@pytest.mark.parametrize("name", list(TASKS))
def test_imagenet_rows_match_the_jax_golden(name):
    runner = chip_smoke.main_golden_runner(PROTO, TASKS[name], "cpu")
    psnrs, x, _ = chip_smoke.main_golden_run(runner.build_model(), runner, PROTO)
    want = GOLDEN["tasks"][name]["per_image_psnr"]
    assert x.shape == (2, 32, 32, 3) and torch.isfinite(x).all()
    assert all(abs(a - b) <= chip_smoke.MAIN_PSNR_TOL for a, b in zip(psnrs, want)), (psnrs, want)


def test_class_conditional_model_gets_the_guided_class(tmp_path):
    """Without a classifier block a class-conditional ADM runs unguided, and
    every image gets GUIDED_CLASS (ddnm_tpu/runner.py:161-171)."""
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.runner import GUIDED_CLASS, RunArgs, Runner

    cfg = load_config(_write_config(tmp_path / "cc.yml", class_cond=True))
    runner = Runner(RunArgs(random_init=True, device="cpu"), cfg)
    model = runner.build_model()
    seen = []
    model.label_emb.register_forward_pre_hook(lambda m, args: seen.append(args[0].clone()))
    fn = runner.model_fn(model)
    for n in (3, 3, 1):
        assert fn(torch.zeros(n, 32, 32, 3), torch.full((n,), 5.0)).shape == (n, 32, 32, 6)
    assert [s.tolist() for s in seen] == [[GUIDED_CLASS] * 3] * 2 + [[GUIDED_CLASS]]


@pytest.mark.parametrize("kw", [dict(random_init=True), dict(classifier_ckpt="clf.pt"), {}])
def test_runner_refuses_wherever_jax_would_guide(kw, tmp_path):
    """Guidance is ported: where the JAX runner guides (a class-conditional
    ADM with a classifier block) the port guides too. Without a classifier
    checkpoint and without --random_init, configs/imagenet_256_cc.yml
    raises FileNotFoundError as JAX does; with --random_init a guided run
    completes (on tests/_torch_port.py's 64 px cut of that config)."""
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.runner import RunArgs, Runner
    from tests._torch_port import write_toy_cc_config

    if not kw.get("random_init"):
        cfg = load_config(REPO / "configs" / "imagenet_256_cc.yml")
        runner = Runner(RunArgs(config="imagenet_256_cc.yml", device="cpu", **kw), cfg)
        with pytest.raises(FileNotFoundError, match="classifier"):
            runner.build_guidance()
        return
    cfg = load_config(write_toy_cc_config(tmp_path / "cc.yml"))
    args = RunArgs(exp=str(REPO / "exp"), path_y="imagenet", deg="sr_averagepooling",
                   max_images=1, image_folder=str(tmp_path / "out"), device="cpu", **kw)
    stats = Runner(args, cfg).run()
    assert stats["num_samples"] == 1 and np.isfinite(stats["avg_psnr"])
    assert stats["range_space_max_abs"] <= 1e-4
    assert (tmp_path / "out" / "0_0.png").exists()


def test_manifest_labels_follow_max_images_and_subset(tmp_path):
    from ddnm_tpu_torch.config import Config
    from ddnm_tpu_torch.runner import RunArgs, Runner

    (tmp_path / "val.txt").write_text("00003.png 17\n00000.png 951\n00001.png 2\n")
    conf = json.loads(json.dumps(PROTO["config"]))
    for kw, want in ((dict(max_images=2), [17, 951]),
                     (dict(subset_start=1, subset_end=3), [951, 2])):
        args = RunArgs(exp=str(REPO / "exp"), path_y="imagenet", device="cpu",
                       manifest=str(tmp_path / "val.txt"), **kw)
        ds = Runner(args, Config.from_dict(conf)).build_dataset()
        assert ds.labels == want and len(ds.paths) == 2


def test_main_torch_cpu_runs_the_adm_end_to_end(tmp_path):
    cfg = _write_config(tmp_path / "toy_adm.yml")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, str(REPO / "main_torch.py"), "--config", str(cfg), "--exp",
         str(REPO / "exp"), "--path_y", "toy32", "--deg", "inpainting",
         "--ckpt", str(REPO / PROTO["fixture"]), "--t_sampling", "5", "--max_images", "3",
         "--batch_size", "2", "-i", str(out), "--ni", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    psnr = float(proc.stdout.split("Total Average PSNR:")[1].split()[0])
    assert psnr > 18.0 and "Number of samples: 3" in proc.stdout
    assert sorted(p.name for p in out.glob("*_0.png")) == ["0_0.png", "1_0.png", "2_0.png"]
    assert len(list((out / "Apy").glob("*.png"))) == 6


def _dry_run_rows(module, exp: Path) -> list[str]:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(["--dry-run", "--exp", str(exp)])
    return [line for line in buf.getvalue().splitlines() if line.startswith("== ")]


def test_evaluation_torch_dry_run_prints_evaluation_rows(tmp_path):
    import evaluation
    import evaluation_torch

    ours = _dry_run_rows(evaluation_torch, tmp_path)
    ref = _dry_run_rows(evaluation, tmp_path)
    assert len(ours) == len(ref) == 14
    for a, b in zip(ours, ref):
        assert a == (b.replace(": main.py ", ": main_torch.py ", 1)
                     + " --device cuda --dtype float32")


def test_evaluation_torch_sweeps_imagenet_rows_on_the_cpu(tmp_path):
    import evaluation_torch

    cfg = _write_config(tmp_path / "toy_adm.yml")
    report = evaluation_torch.main([
        "--datasets", "imagenet", "--tasks", "imagenet_sr_ap_4x,imagenet_cs_wh",
        "--config-imagenet", str(cfg), "--ckpt-imagenet", str(REPO / PROTO["fixture"]),
        "--path-y-imagenet", "toy32", "--exp", str(REPO / "exp"), "-i", str(tmp_path / "ev"),
        "--t-sampling", "4", "--max-images", "2", "--device", "cpu"])
    assert list(report) == ["imagenet_sr_ap_4x", "imagenet_cs_wh_025"]
    for stats in report.values():
        assert stats["num_samples"] == 2 and stats["range_space_max_abs"] <= 1e-4
    assert json.loads((tmp_path / "ev" / "report.json").read_text()) == report


def test_evaluation_torch_exits_non_zero_on_a_failed_row(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(REPO / "evaluation_torch.py"), "--smoke", "--tasks",
         "celeba_sr_ap_4x", "--exp", str(tmp_path), "-i", str(tmp_path / "ev"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "1 of 1 rows failed: celeba_sr_ap_4x" in proc.stderr
    report = json.loads((tmp_path / "ev" / "report.json").read_text())
    assert "checkpoint" in report["celeba_sr_ap_4x"]["error"]
