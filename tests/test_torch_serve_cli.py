"""serve_torch.py, the port's serving CLI, on the CPU: its flags against
serve.py's, build_service / build_hq_service at toy size (toy32 configs,
the trained toy fixtures or --random_init), --dp 2 on the CPU and the
refusals (a --dp that does not divide --max_batch, the encoder cache with
SVD tasks, --loop scan with the cache), and one server
process taking a request, SIGHUP (reload from --ckpt) and SIGTERM (drain,
exit 0). Exact comparisons throughout."""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import serve
import serve_torch
from ddnm_tpu_torch.data.io import decode_png, encode_png
from tests._torch_port import one_torch_thread  # noqa: F401
from tests.test_torch_hq_cli import TOY_CLASSIFIER, TOY_CONF

REPO = Path(__file__).resolve().parents[1]
TOY_DDPM = str(REPO / "tests" / "fixtures" / "toy_ddpm32.pt")
TOY_ADM = str(REPO / "tests" / "fixtures" / "toy_adm32.pt")


@pytest.mark.parametrize("argv", [
    [],
    ["--config", "configs/smoke.yml", "--random_init", "--degs", "sr_averagepooling,denoising",
     "--max_batch", "2", "--t_sampling", "2", "--queue_size", "7"],
    ["--config", "configs/celeba_hq.yml", "--ckpt", "x.pt", "--svd_degs", "cs_walshhadamard",
     "--deg_scale", "0.25", "--sigma_y", "0.05", "--eta", "0.5", "--seed", "3",
     "--mask_path", "m.npy", "--dtype", "bfloat16", "--dp", "2", "--host", "0.0.0.0",
     "--port", "9000", "--max_wait_ms", "5", "--request_timeout_s", "10",
     "--encoder_cache", "3", "--encoder_cache_policy", "end_dense", "--loop", "scan",
     "--no_warmup"],
    ["--hq_conf", "configs/hq/inet256.yml", "--classifier_ckpt", "c.pt", "--degs",
     "inpainting"],
])
def test_parse_args_is_serve_py_plus_device(argv):
    ours = vars(serve_torch.parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == vars(serve.parse_args(argv))
    assert serve_torch.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def _ns(*argv):
    return serve_torch.parse_args(["--config", "configs/toy32.yml", "--device", "cpu",
                                   "--t_sampling", "2", "--max_batch", "2", *argv])


def test_build_service_at_toy_size():
    svc = serve_torch.build_service(_ns("--random_init", "--degs",
                                        "sr_averagepooling,denoising,inpainting"))
    assert svc.tasks == ("denoising", "inpainting", "sr_averagepooling")
    assert svc.image_size == 32 and svc.max_batch == 2
    assert svc.requires_ctx("inpainting") and svc.device.type == "cpu"
    imgs = np.random.default_rng(0).uniform(0.2, 0.8, (2, 32, 32, 3)).astype(np.float32)
    out = svc.restore(imgs, "denoising", [0, 1], input_kind="gt")
    assert out.shape == (2, 32, 32, 3) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="without a static mask"):
        svc.restore(imgs, "inpainting", [0, 1], input_kind="gt")
    svd = serve_torch.build_service(_ns("--ckpt", TOY_DDPM, "--degs", "",
                                        "--svd_degs", "cs_walshhadamard", "--deg_scale", "0.25"))
    assert svd.is_svd("cs_walshhadamard") and svd.y_shape("cs_walshhadamard") is None
    cached = serve_torch.build_service(_ns("--ckpt", TOY_DDPM, "--encoder_cache", "2",
                                           "--encoder_cache_policy", "end_dense"))
    assert cached._encoder_cache == 2 and cached._split_fns is not None
    assert np.isfinite(cached.restore(imgs[:1], "sr_averagepooling", [0],
                                      input_kind="gt")).all()


def test_build_service_refusals():
    with pytest.raises(SystemExit, match="SVD"):
        serve_torch.build_service(_ns("--random_init", "--svd_degs", "deblur_gauss",
                                      "--encoder_cache", "2"))
    with pytest.raises(SystemExit, match="both"):
        serve_torch.build_service(_ns("--random_init", "--svd_degs", "sr_averagepooling"))
    with pytest.raises(SystemExit, match="unknown task"):
        serve_torch.build_service(_ns("--random_init", "--degs", "nope"))
    with pytest.raises(ValueError, match="host-driven"):
        serve_torch.build_service(_ns("--random_init", "--encoder_cache", "2", "--loop",
                                      "scan"))
    # --dp: a max_batch the mesh does not divide raises before serving; --dp 2
    # builds a CPU mesh of 2 and serves
    with pytest.raises(ValueError, match="must divide over the 3-device mesh"):
        serve_torch.build_service(_ns("--random_init", "--dp", "3", "--max_batch", "8"))
    with pytest.raises(ValueError, match="must divide over the 3-device mesh"):
        serve_torch.main(["--config", "configs/toy32.yml", "--random_init", "--dp", "3",
                          "--max_batch", "8", "--device", "cpu"])
    svc = serve_torch.build_service(_ns("--random_init", "--dp", "2"))
    assert svc._mesh.size == 2 and svc._mesh.devices[0].type == "cpu"
    imgs = np.random.default_rng(0).uniform(0.2, 0.8, (2, 32, 32, 3)).astype(np.float32)
    assert np.isfinite(svc.restore(imgs, "sr_averagepooling", [0, 1], input_kind="gt")).all()


def _toy_hq_conf(tmp_path, class_cond, scale):
    conf = TOY_CONF.format(class_cond=class_cond, classifier_scale=scale) + TOY_CLASSIFIER
    conf = conf.replace('timestep_respacing: "25"', 'timestep_respacing: "4"')
    conf = conf.replace("t_T: 25", "t_T: 4").replace("jump_length: 10", "jump_length: 1")
    path = tmp_path / f"toy_{class_cond}_{scale}.yml"
    path.write_text(conf)
    return str(path)


def test_build_hq_service_at_toy_size(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    gt = np.random.default_rng(1).uniform(0.2, 0.8, (1, 32, 32, 3)).astype(np.float32)
    ns = serve_torch.parse_args(["--hq_conf", _toy_hq_conf(tmp_path, "false", "0.0"),
                                 "--ckpt", TOY_ADM, "--degs", "sr_averagepooling,inpainting",
                                 "--max_batch", "2", "--device", "cpu"])
    svc = serve_torch.build_hq_service(ns)
    assert svc.tasks == ("inpainting", "sr_averagepooling") and not svc.class_cond
    assert svc.requires_ctx("inpainting")
    assert svc.restore(gt, "sr_averagepooling", [0], input_kind="gt").shape == (1, 32, 32, 3)
    # class-conditional and guided, random weights: labels steer the output
    ns = serve_torch.parse_args(["--hq_conf", _toy_hq_conf(tmp_path, "true", "1.0"),
                                 "--random_init", "--degs", "sr_averagepooling",
                                 "--max_batch", "2", "--device", "cpu"])
    svc = serve_torch.build_hq_service(ns)
    assert svc.class_cond and svc.num_classes == 1000 and svc._guidance_fn is not None
    assert torch.backends.cudnn.deterministic  # the guidance gradient's bits hold
    out = svc.restore(np.repeat(gt, 2, 0), "sr_averagepooling", [3, 3], input_kind="gt",
                      classes=[5, 700])
    assert np.isfinite(out).all()
    with pytest.raises(SystemExit, match="unknown hq task"):
        serve_torch.build_hq_service(serve_torch.parse_args(
            ["--hq_conf", _toy_hq_conf(tmp_path, "false", "0.0"), "--random_init",
             "--degs", "deblur_gauss", "--device", "cpu"]))


def test_sigterm_drains_and_sighup_reloads():
    """A server process on the CPU: it serves a request, reloads its
    weights on SIGHUP (applied before the next group), and exits 0 on
    SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "serve_torch.py"), "--config", "configs/toy32.yml",
         "--ckpt", TOY_DDPM, "--degs", "sr_averagepooling", "--t_sampling", "2",
         "--max_batch", "2", "--port", "0", "--no_warmup", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")),
                              daemon=True)
    reader.start()

    def wait_for(text, timeout=120):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            hit = [line for line in list(lines) if text in line]
            if hit:
                return hit[0]
            if proc.poll() is not None:
                raise AssertionError("server exited: " + "".join(lines))
            time.sleep(0.1)
        raise AssertionError(f"no {text!r} in: " + "".join(lines))

    try:
        port = int(wait_for("serving").rsplit(":", 1)[1].split()[0])
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.load(r)["status"] == "ok"
        img = np.random.default_rng(2).integers(0, 256, (32, 32, 3), dtype=np.uint8)
        req = urllib.request.Request(f"{base}/restore?deg=sr_averagepooling&input=gt",
                                     data=encode_png(img))
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and decode_png(r.read()).shape == (32, 32, 3)
        proc.send_signal(signal.SIGHUP)
        wait_for("SIGHUP: reloaded")
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.load(r)["requests"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        reader.join(timeout=10)
        assert any("shutting down" in line for line in lines)
    finally:
        if proc.poll() is None:
            proc.kill()
