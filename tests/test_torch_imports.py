"""Guards of the port's import closure and of its no-fallback rule.

The machine with the card has torch, numpy, scipy and einops but no jax,
flax, yaml, PIL or tqdm, and the port must not reach the JAX package. A
missing card is an error for every entry point, never a silent CPU run."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "ddnm_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "ddnm_tpu", "yaml", "PIL", "tqdm")
EXPERIMENT = REPO / "tools" / "experiments" / "fused_gn_conv_torch.py"
PORT_FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "main_torch.py",
                                          REPO / "hq_main_torch.py", REPO / "evaluation_torch.py",
                                          REPO / "serve_torch.py",
                                          REPO / "hq_evaluation_torch.py", EXPERIMENT,
                                          REPO / "tools" / "time_runner_overlap.py",
                                          REPO / "tools" / "profile_torch_serve.py",
                                          REPO / "tools" / "time_serving.py",
                                          REPO / "tools" / "check_spatial_nccl.py",
                                          REPO / "tools" / "check_multicard_backward.py"]


# the port's tools (the trainers and the ported experiments): no JAX
# package and no optax either
PORT_TOOLS = sorted((REPO / "tools").glob("*_torch.py")) + sorted(
    (REPO / "tools" / "experiments").glob("*_torch.py"))
TOOLS_BLOCKED = BLOCKED + ("optax",)


def _blocked(name: str, blocked=BLOCKED) -> bool:
    return name.split(".")[0] in blocked


def test_port_imports_with_foreign_packages_blocked():
    """Every module of the port (the server, utils.observability, the
    parallel package, serving, sampling.threefry, ops.library and the
    WebP decoder among them), main_torch, hq_main_torch, evaluation_torch, serve_torch,
    hq_evaluation_torch, chip_smoke and the ported experiment import in a
    process where the blocked packages cannot be found, and leave lmdb
    unimported (the LSUN datasets import it when opened); importing runs
    nothing (no output, no build directory)."""
    script = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        BLOCKED = {BLOCKED!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(REPO)!r})
        import ddnm_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(ddnm_tpu_torch.__path__,
                                                       "ddnm_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert set(("ddnm_tpu_torch.parallel.mesh", "ddnm_tpu_torch.parallel.multihost",
                    "ddnm_tpu_torch.parallel.spatial", "ddnm_tpu_torch.serving",
                    "ddnm_tpu_torch.sampling.threefry",
                    "ddnm_tpu_torch.ops.library", "ddnm_tpu_torch.data.webp",
                    "ddnm_tpu_torch.data.webp_tables")).issubset(names), names
        import chip_smoke, evaluation_torch, hq_evaluation_torch, hq_main_torch
        import main_torch, serve_torch
        spec = importlib.util.spec_from_file_location("fused_gn_conv_torch",
                                                      {str(EXPERIMENT)!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("lmdb",))
        assert not leaked, leaked
        print("IMPORTED", len(names))
    """)
    build_dir = PKG / "_build"
    before = set(build_dir.iterdir()) if build_dir.exists() else set()
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO.parent))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("IMPORTED") and proc.stdout.strip().split()[-1] != "0"
    after = set(build_dir.iterdir()) if build_dir.exists() else set()
    assert after == before


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_names_no_foreign_module(path):
    _check_source(path, BLOCKED)


@pytest.mark.parametrize("path", PORT_TOOLS, ids=lambda p: str(p.relative_to(REPO)))
def test_port_tools_name_no_foreign_module(path):
    """tools/*_torch.py and tools/experiments/*_torch.py (the trainers and
    the quality experiments among them) name none of the blocked
    packages, nor optax."""
    _check_source(path, TOOLS_BLOCKED)


def test_port_tools_import_with_foreign_packages_blocked():
    """Every port tool imports in a process where the blocked packages and
    optax cannot be found, and importing runs nothing (no output)."""
    assert len(PORT_TOOLS) >= 13
    script = textwrap.dedent(f"""
        import importlib.util, sys
        BLOCKED = {TOOLS_BLOCKED!r}
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Block())
        for sub in ("", "/tools", "/tools/experiments"):
            sys.path.insert(0, {str(REPO)!r} + sub)
        for path in {[str(p) for p in PORT_TOOLS]!r}:
            name = path.rsplit("/", 1)[1][:-3]
            spec = importlib.util.spec_from_file_location(name, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO.parent))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout == ""


def _check_source(path, blocked):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__", "find_spec")):
            names = [node.args[0].value]
        else:
            continue
        bad = [n for n in names if _blocked(n, blocked)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def _no_cuda_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a host that has one
    return env


def test_chip_smoke_fails_fast_without_a_card():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120, env=_no_cuda_env())
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stdout + proc.stderr
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone_without_the_program(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_main_torch_without_device_cpu_raises_without_a_card(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, str(REPO / "main_torch.py"), "--config", "configs/toy32.yml",
         "--deg", "sr_averagepooling", "--simplified", "--random_init", "-i", str(out),
         "--ni"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=_no_cuda_env())
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not out.exists()


def test_hq_evaluation_torch_without_device_cpu_raises_without_a_card(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, str(REPO / "hq_evaluation_torch.py"), "--face_sweep", "--dry-run",
         "--random-init", "-i", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=_no_cuda_env())
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "hq_main_torch.py" not in proc.stdout and not out.exists()


def test_runner_and_resolve_device_raise_without_a_card(monkeypatch):
    import torch

    from ddnm_tpu_torch import resolve_device
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.runner import RunArgs, Runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(REPO / "configs" / "toy32.yml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner(RunArgs(config="configs/toy32.yml", random_init=True), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
