#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ddnm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card and the repository around it; without either it exits
non-zero and prints no result. Each phase prints a line when it starts and
one with its seconds when it ends (flushed), so a run that is cut shows how
far it got. A failure in any phase raises.

  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: the CUDA kernels of ddnm_tpu_torch/csrc with nvcc;
  3. kernels against their plain versions, at every (shape, dtype) that the
     UNet forwards of phases 4 and 5 give them: the GroupNorm stats pair
     (sums + finalize) and apply kernel each against its own plain version,
     the whole GroupNorm against the plain GroupNorm, attention against the
     plain attention; max abs error, kernel ms, plain ms, the library
     call's ms where one call computes the same function (F.group_norm for
     the whole GroupNorm, F.scaled_dot_product_attention; timed as a
     yardstick, never used by the port) and the least time the card could
     take (bound);
  4. full-width fp32 parity: the 114M DDPM UNet with the trained weights of
     tests/fixtures/flag_ddpm256.pt, zero noise, x_T from RandomState(42),
     2 images of exp/datasets/natural256, 25 steps, 4x average-pooling SR;
     once through the kernels, once through the plain versions, both held
     against the JAX package's golden (tests/fixtures/flag_simplified_*);
  5. the main path through the entry point: main_torch on configs/celeba_hq.yml,
     flag_ddpm256.pt, exp/datasets/celeba_hq, bf16 torso, batch 8, 100 steps;
     images/s and PSNR, with the kernels' launch counts;
  6. full-width fp32 parity of SVD mode: the protocol of phase 4 with
     sample_svd. 25% Walsh-Hadamard compressed sensing, noise-free and noisy
     (sigma_y 0.1), runs once through the kernels and once through the plain
     versions, both held against the JAX package's golden
     (tests/fixtures/flag_svd_*); sr_bicubic 4x, sr_averagepooling 4x
     (noise-free and noisy), colorization and inpainting run through the
     kernels, each held to its JAX PSNR in tests/fixtures/flag_golden_psnr.json;
  7. the SVD main path through main_torch: phase 5's set-up without
     --simplified, on cs_walshhadamard at ratio 0.25.

Phase 3 also holds the Walsh-Hadamard kernel against its plain version at
the SVD path's shapes. Each of phases 4-7 sets the launch counts to 0 just
before its run and checks them exactly just after.

The line before the last is the JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}. Outputs go to a temporary directory.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F

REPO = Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from ddnm_tpu_torch import ops  # noqa: E402
from ddnm_tpu_torch.ops import _build  # noqa: E402
from ddnm_tpu_torch.ops.attention import _kernel_attention, _torch_attention  # noqa: E402
from ddnm_tpu_torch.ops.fwht import (  # noqa: E402
    _factor,
    _kernel_fwht,
    _torch_fwht,
    hadamard_matrix,
)
from ddnm_tpu_torch.ops.groupnorm import (  # noqa: E402
    _apply,
    _kernel_group_norm,
    _stats_affine,
    _torch_apply,
    _torch_group_norm,
    _torch_stats_affine,
)

FLAG_PT = REPO / "tests" / "fixtures" / "flag_ddpm256.pt"
GOLDEN_JSON = REPO / "tests" / "fixtures" / "flag_simplified_golden.json"
GOLDEN_POOL8 = REPO / "tests" / "fixtures" / "flag_simplified_pool8.npy"
SVD_GOLDEN_JSON = REPO / "tests" / "fixtures" / "flag_svd_golden.json"
SVD_GOLDEN_POOL8 = REPO / "tests" / "fixtures" / "flag_svd_pool8.npy"
FLAG_PSNR_JSON = REPO / "tests" / "fixtures" / "flag_golden_psnr.json"

# H100 SXM published peaks (dense): HBM bytes/s; fp32 on the CUDA cores and
# bf16 on the tensor cores, flop/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# kernel-vs-plain gates, relative to max(1, max |plain|):
#  - GroupNorm stats (a, b in fp32, from fp32 sums of the same values):
#    the sums run in another order (partials per 256 pixels);
#  - GroupNorm apply and the pair, fp32: one FMA against a multiply and an
#    add, and (pair) the plain version normalises then scales;
#  - GroupNorm apply and the pair, bf16: the fp32 values agree to ~1e-6 and
#    rounding to bf16 may then land one ulp (<= 2^-7 relative) apart;
#  - attention fp32: 512-term fp32 dot products in another order, then exp;
#  - attention bf16: the plain version (as the JAX XLA path) rounds the
#    scores to bf16 before the softmax, the kernel (as the Pallas kernel)
#    keeps them fp32: ~1% noise on each probability, averaged over T keys;
#  - fwht fp32: sums of 65536 +-x terms in another order (butterfly against
#    the plain einsum).
TOL = {
    ("groupnorm_stats", torch.float32): 1e-4,
    ("groupnorm_stats", torch.bfloat16): 1e-4,
    ("groupnorm_apply", torch.float32): 1e-5,
    ("groupnorm_apply", torch.bfloat16): 1e-2,
    ("groupnorm", torch.float32): 1e-4,
    ("groupnorm", torch.bfloat16): 1e-2,
    ("attention", torch.float32): 1e-4,
    ("attention", torch.bfloat16): 3e-2,
    ("fwht", torch.float32): 1e-4,
}
# the kernels of the JSON summary: source, and the Pallas function replaced
SOURCES = {
    "groupnorm_stats": ("ddnm_tpu_torch/csrc/groupnorm.cu", "ddnm_tpu/ops/groupnorm.py:91"),
    "groupnorm_apply": ("ddnm_tpu_torch/csrc/groupnorm.cu", "ddnm_tpu/ops/groupnorm.py:73"),
    "attention": ("ddnm_tpu_torch/csrc/attention.cu",
                  "ddnm_tpu/ops/attention.py:57"),
    "fwht": ("ddnm_tpu_torch/csrc/fwht.cu", "ddnm_tpu/ops/fwht.py:63"),
}
# the Walsh-Hadamard transform's shapes on the SVD paths: 3 planes of 65536
# per image, batch 2 (phase 6) and 8 (phase 7)
FWHT_SHAPES = ((2, 3, 65536), (8, 3, 65536))


@contextlib.contextmanager
def phase(n: int, name: str):
    print(f"== phase {n}: {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {n}: {name} done in {time.perf_counter() - t0:.2f} s", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 3


def op_shapes(model, x_nhwc) -> dict:
    """{("groupnorm"|"attention", shape, dtype): calls per forward} of one
    UNet forward on x_nhwc (forward pre-hooks; the calls run the kernels)."""
    from ddnm_tpu_torch.models.nn import GroupNormF32
    from ddnm_tpu_torch.models.unet_ddpm import AttnBlock

    seen: dict = {}

    def gn_hook(_m, args):
        b, c, h, w = args[0].shape
        key = ("groupnorm", (b, h, w, c), args[0].dtype)
        seen[key] = seen.get(key, 0) + 1

    def attn_hook(_m, args):
        b, c, h, w = args[0].shape
        key = ("attention", (b, h * w, c), args[0].dtype)
        seen[key] = seen.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(gn_hook if isinstance(m, GroupNormF32)
                                           else attn_hook)
               for m in model.modules() if isinstance(m, (GroupNormF32, AttnBlock))]
    with torch.no_grad():
        model(x_nhwc, torch.full((x_nhwc.shape[0],), 500.0, device=x_nhwc.device))
    for h in handles:
        h.remove()
    return seen


def check_kernel(kind: str, shape: tuple, dtype: torch.dtype, gen: torch.Generator):
    """Kernel vs plain (vs library, where one call computes the same
    function) at one shape; returns a result dict. Kinds: groupnorm_stats,
    groupnorm_apply, groupnorm (the pair, against F.group_norm), attention,
    fwht (against the einsum H_a X H_b in fp32, TF32 off)."""
    dev = "cuda"
    library = None
    if kind.startswith("groupnorm"):
        B, H, W, C = shape
        x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(dtype)
        g = torch.randn(C, device=dev, generator=gen)
        b = torch.randn(C, device=dev, generator=gen)
        peak = PEAK_FLOPS[torch.float32]  # elementwise fp32 on the CUDA cores
        affine_bytes = 2 * B * C * 4
        if kind == "groupnorm_stats":
            kern = lambda: _stats_affine(x, g, b, 32, 1e-6, None, None)
            plain = lambda: _torch_stats_affine(x, g, b, 32, 1e-6)
            nbytes = x.numel() * x.element_size() + affine_bytes
            flops = 3 * x.numel()
        elif kind == "groupnorm_apply":
            a_p, b_p = _torch_stats_affine(x, g, b, 32, 1e-6)
            kern = lambda: _apply(x, a_p, b_p, False)
            plain = lambda: _torch_apply(x, a_p, b_p, False)
            nbytes = 2 * x.numel() * x.element_size() + affine_bytes
            flops = 2 * x.numel()
        else:
            kern = lambda: _kernel_group_norm(x, g, b, 32, 1e-6, False)
            plain = lambda: _torch_group_norm(x, g, b, 32, 1e-6, False)
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last memory: the same bytes
            g_l, b_l = g.to(dtype), b.to(dtype)
            library = lambda: F.group_norm(x_nchw, 32, g_l, b_l, 1e-6)
            nbytes = 2 * x.numel() * x.element_size()
            flops = 5 * x.numel()
    elif kind == "fwht":
        x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        norm = float(shape[-1]) ** 0.5
        kern = lambda: _kernel_fwht(x, norm)
        plain = lambda: _torch_fwht(x, norm)
        a, b = _factor(shape[-1])
        ha, hb = (torch.from_numpy(hadamard_matrix(m)).to(dev) for m in (a, b))
        x3 = x.reshape(-1, a, b)
        library = lambda: torch.einsum("ij,njk,kl->nil", ha, x3, hb)
        nbytes = 2 * x.numel() * x.element_size()
        flops = x.numel() * int(math.log2(shape[-1]))  # one add per element per stage
        peak = PEAK_FLOPS[torch.float32]
    else:
        B, T, C = shape
        q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype) for _ in range(3))
        scale = C ** -0.5
        kern = lambda: _kernel_attention(q, k, v, scale)
        plain = lambda: _torch_attention(q, k, v, scale)
        q4, k4, v4 = (t[:, None] for t in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        nbytes = 4 * q.numel() * q.element_size()
        flops = 4 * B * T * T * C
        peak = PEAK_FLOPS[dtype]
    as_list = lambda out: list(out) if isinstance(out, tuple) else [out]
    refs = [t.float() for t in as_list(plain())]
    err = max(float((k.float() - r).abs().max()) for k, r in zip(as_list(kern()), refs))
    torch.cuda.synchronize()
    tol = TOL[(kind, dtype)] * max(1.0, max(float(r.abs().max()) for r in refs))
    if not err <= tol:
        raise AssertionError(f"{kind} {shape} {dtype}: kernel vs plain max abs "
                             f"{err:.3e} > {tol:.3e}")
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    lib_ms = cuda_ms(library) if library is not None else None
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return {"kind": kind, "shape": shape, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "tol": tol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# ------------------------------------------------------------------ phase 4


def parity_fp32(model, n_gn: int, n_attn: int) -> dict:
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.sampling import build_schedule, sample_simplified
    from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators

    golden = json.loads(GOLDEN_JSON.read_text())
    proto = golden["protocol"]
    n, res, steps = proto["n_images"], proto["res"], proto["t_sampling"]
    paths = sorted((REPO / proto["eval_dir"]).glob("*.png"))[:n]
    gt = torch.from_numpy(np.stack([load_image(p) for p in paths]) * 2.0 - 1.0).cuda()
    xt = np.random.RandomState(proto["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1))).cuda()
    op = build_functional_operator(proto["deg"], image_size=res,
                                   deg_scale=proto["deg_scale"], device="cuda")
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    sched = build_schedule(betas=betas, t_sampling=steps)
    zero = lambda gens, shape: torch.zeros(shape, device="cuda")
    y = op.A(gt)

    runs = {}
    for mode in ("kernel", "torch"):
        set_op_force(model, None if mode == "kernel" else "torch")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        x, _ = sample_simplified(model, xt, y, op, sched,
                                 image_generators(0, range(n), STREAM_SAMPLE, "cuda"),
                                 noise_fn=zero)
        torch.cuda.synchronize()
        runs[mode] = (x, time.perf_counter() - t0, ops.launch_counts())
    set_op_force(model, None)

    to01 = lambda a: torch.clamp((a + 1) / 2, 0, 1)
    gt01 = to01(gt)
    ref_pool = np.load(GOLDEN_POOL8)
    out = {}
    for mode, (x, secs, counts) in runs.items():
        psnrs = [float(10 * torch.log10(1 / ((to01(x[i]) - gt01[i]) ** 2).mean()))
                 for i in range(n)]
        pool = F.avg_pool2d(x.permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1).cpu().numpy()
        out[mode] = {"psnr": psnrs, "seconds": secs, "launches": counts,
                     "pool8_max_abs_vs_golden": float(np.abs(pool - ref_pool).max())}
        for p, g in zip(psnrs, golden["per_image_psnr"]):
            if not abs(p - g) <= 0.1:
                raise AssertionError(f"{mode}: PSNR {p:.4f} vs golden {g:.4f}")
        if not out[mode]["pool8_max_abs_vs_golden"] <= POOL8_TOL:
            raise AssertionError(f"{mode}: pooled output vs golden "
                                 f"{out[mode]['pool8_max_abs_vs_golden']:.3e}")
    out["kernel_vs_torch_max_abs"] = float((runs["kernel"][0] - runs["torch"][0]).abs().max())
    if not out["kernel_vs_torch_max_abs"] <= 1e-3:
        raise AssertionError(f"kernel vs plain trajectories differ by "
                             f"{out['kernel_vs_torch_max_abs']:.3e}")
    want = {"groupnorm_stats": n_gn * steps, "groupnorm_apply": n_gn * steps,
            "attention": n_attn * steps, "fwht": 0}
    if runs["kernel"][2] != want:
        raise AssertionError(f"launch counts {runs['kernel'][2]} != {want}")
    if any(runs["torch"][2].values()):
        raise AssertionError(f"plain run launched kernels: {runs['torch'][2]}")
    return out


# fp32 on the card against the JAX package's fp32 on the CPU, after 25 steps
# through the 114M UNet, averaged over 8x8 pixels (tests/fixtures golden)
POOL8_TOL = 1e-2


# ------------------------------------------------------------------ phase 6

# (name, deg, deg_scale, sigma_y): the 256 px golden tasks of
# tests/_golden.py TASKS that the port can rebuild (deblur_gauss is left
# out: its golden used the torch oracle's sort permutation). The first two
# run the Walsh-Hadamard kernel and have a pooled golden of their own.
SVD_TASKS = [
    ("cs_wh_025", "cs_walshhadamard", 0.25, 0.0),
    ("cs_wh_noisy", "cs_walshhadamard", 0.25, 0.1),
    ("sr_bicubic_4x", "sr_bicubic", 4.0, 0.0),
    ("sr_ap_4x", "sr_averagepooling", 4.0, 0.0),
    ("colorization", "colorization", 4.0, 0.0),
    ("inpainting", "inpainting", 4.0, 0.0),
    ("sr_ap_4x_noisy", "sr_averagepooling", 4.0, 0.1),
]


def golden_perm(res: int) -> np.ndarray:
    """The golden protocol's cs_walshhadamard pixel permutation (a copy of
    tests/_golden.py toy_perm; tests/test_torch_svd_sampling.py holds them
    equal)."""
    return np.random.default_rng(7).permutation(res * res)


def golden_mask(res: int) -> np.ndarray:
    """The golden protocol's inpainting keep-mask, a centre hole (a copy of
    tests/_golden.py toy_mask)."""
    m = np.ones((res, res), np.int64)
    m[res * 10 // 32:res * 22 // 32, res * 8 // 32:res * 26 // 32] = 0
    return m


def fwht_launches(deg: str, sigma_y: float, steps: int) -> int:
    """Walsh-Hadamard launches of one sample_svd run after y = A(x): A's Vt
    (1), prepare_measurement (A_pinv's V, then the spectrum: 2), and per
    step range_correction (2) or, noisy, noisy_update (3)."""
    if deg != "cs_walshhadamard":
        return 0
    return 1 + 2 + steps * (3 if sigma_y else 2)


def parity_svd(model, n_gn: int, n_attn: int) -> dict:
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force
    from ddnm_tpu_torch.operators import build_svd_operator
    from ddnm_tpu_torch.sampling import build_schedule, sample_svd
    from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec
    from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators

    golden = json.loads(SVD_GOLDEN_JSON.read_text())
    flag_psnr = json.loads(FLAG_PSNR_JSON.read_text())
    ref_pool = dict(zip(golden["tasks"], np.load(SVD_GOLDEN_POOL8)))
    proto = golden["protocol"]
    n, res, steps = proto["n_images"], proto["res"], proto["t_sampling"]
    paths = sorted((REPO / proto["eval_dir"]).glob("*.png"))[:n]
    gt = torch.from_numpy(np.stack([load_image(p) for p in paths]) * 2.0 - 1.0).cuda()
    xt = np.random.RandomState(proto["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1))).cuda()
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    sched = build_schedule(betas=betas, t_sampling=steps)
    zero = lambda gens, shape: torch.zeros(shape, device="cuda")
    to01 = lambda a: torch.clamp((a + 1) / 2, 0, 1)
    gt01 = to01(gt)

    out = {}
    for name, deg, deg_scale, sigma_y in SVD_TASKS:
        op = build_svd_operator(deg, channels=3, image_size=res, deg_scale=deg_scale,
                                mask=golden_mask(res), perm=golden_perm(res), device="cuda")
        routes = ("kernel", "torch") if name in golden["tasks"] else ("kernel",)
        finals = {}
        for mode in routes:
            force = None if mode == "kernel" else "torch"
            set_op_force(model, force)
            op.force = force
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            y = op.A(_nhwc_to_vec(gt))
            x, _ = sample_svd(model, xt, y, op, sched,
                              image_generators(0, range(n), STREAM_SAMPLE, "cuda"),
                              eta=proto["eta"], sigma_y=sigma_y, noise_fn=zero)
            torch.cuda.synchronize()
            secs, counts = time.perf_counter() - t0, ops.launch_counts()
            finals[mode] = x
            psnr = float(10 * torch.log10(1 / ((to01(x) - gt01) ** 2).mean()))
            r = {"psnr": psnr, "golden_psnr": flag_psnr[name]["ours_psnr"],
                 "seconds": secs, "launches": counts}
            if not abs(psnr - r["golden_psnr"]) <= 0.1:
                raise AssertionError(f"{name} {mode}: batch PSNR {psnr:.4f} vs JAX "
                                     f"{r['golden_psnr']:.4f}")
            if name in ref_pool:
                pool = F.avg_pool2d(x.permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1)
                r["pool8_max_abs_vs_golden"] = float(
                    np.abs(pool.cpu().numpy() - ref_pool[name]).max())
                if not r["pool8_max_abs_vs_golden"] <= POOL8_TOL:
                    raise AssertionError(f"{name} {mode}: pooled output vs golden "
                                         f"{r['pool8_max_abs_vs_golden']:.3e}")
            want = ({"groupnorm_stats": n_gn * steps, "groupnorm_apply": n_gn * steps,
                     "attention": n_attn * steps,
                     "fwht": fwht_launches(deg, sigma_y, steps)}
                    if mode == "kernel" else dict.fromkeys(counts, 0))
            if counts != want:
                raise AssertionError(f"{name} {mode}: launch counts {counts} != {want}")
            out[f"{name}/{mode}"] = r
            print(f"{name:15s} {mode:6s}: batch PSNR {psnr:.4f} (JAX {r['golden_psnr']:.4f})"
                  + (f" pool8 max abs vs golden {r['pool8_max_abs_vs_golden']:.3e}"
                     if name in ref_pool else "")
                  + f" {secs:.2f} s launches {counts}", flush=True)
        if "torch" in finals:
            diff = float((finals["kernel"] - finals["torch"]).abs().max())
            out[f"{name}/kernel_vs_torch_max_abs"] = diff
            print(f"{name}: kernel vs plain final images max abs {diff:.3e}", flush=True)
            if not diff <= 1e-3:
                raise AssertionError(f"{name}: kernel vs plain trajectories differ by "
                                     f"{diff:.3e}")
    set_op_force(model, None)
    return out


# ------------------------------------------------------------ phases 5 and 7


def main_path(deg: str, deg_scale: str, simplified: bool, n_gn: int, n_attn: int,
              want_fwht: int) -> tuple[dict, dict]:
    """main_torch on configs/celeba_hq.yml, flag_ddpm256.pt, the 8 images of
    exp/datasets/celeba_hq, bf16 torso, batch 8, 100 steps, sigma_y 0;
    checks 8 PNGs, PSNR > 14 dB and every kernel's launch count exactly.
    Returns (the run's stats, its launch counts)."""
    import main_torch

    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        stats = main_torch.main([
            "--config", str(REPO / "configs" / "celeba_hq.yml"),
            "--ckpt", str(FLAG_PT), "--exp", str(REPO / "exp"),
            "--path_y", "celeba_hq", "--deg", deg,
            "--deg_scale", deg_scale, "--sigma_y", "0",
            *(["--simplified"] if simplified else []),
            "--dtype", "bfloat16", "--batch_size", "8",
            "-i", str(Path(tmp) / "out"), "--ni", "--verbose", "warning"])
        launches = ops.launch_counts()
        n_png = len(list((Path(tmp) / "out").glob("*_0.png")))
    steps = 100
    print(f"main path ({'simplified' if simplified else 'SVD'} {deg}): "
          f"{stats['num_samples']} images, PSNR {stats['avg_psnr']:.4f}, "
          f"{stats['images_per_second']:.4f} images/s end to end "
          f"({stats['wall_seconds']:.2f} s), "
          f"{stats['num_samples'] / stats['sample_seconds']:.4f} images/s in the "
          f"sampler ({stats['sample_seconds']:.2f} s); launches {launches}",
          flush=True)
    if stats["num_samples"] != 8 or n_png != 8:
        raise AssertionError(f"expected 8 restored images, got {stats['num_samples']}"
                             f" ({n_png} PNGs)")
    if not (np.isfinite(stats["avg_psnr"]) and stats["avg_psnr"] > 14.0):
        raise AssertionError(f"main-path PSNR {stats['avg_psnr']} is not a restoration")
    want = {"groupnorm_stats": n_gn * steps, "groupnorm_apply": n_gn * steps,
            "attention": n_attn * steps, "fwht": want_fwht}
    if launches != want:
        raise AssertionError(f"main-path launch counts {launches} != {want}")
    return stats, launches


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False; "
                           "chip_smoke.py runs only on a card")
    from ddnm_tpu_torch.models import DDPMUNet, cast_torso
    from ddnm_tpu_torch.models.nn import GroupNormF32
    from ddnm_tpu_torch.models.unet_ddpm import AttnBlock
    from ddnm_tpu_torch.runner import load_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with phase(1, "environment"):
        smi = nvidia_smi_line()
        print(smi, flush=True)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
              f"(count {torch.cuda.device_count()})", flush=True)

    with phase(2, "build"):
        path, secs = _build.build()
        _build.load_library()
        print(f"built {path.name} with nvcc in {secs:.2f} s", flush=True)

    with phase(3, "kernels against plain versions"):
        model = DDPMUNet(resolution=256)
        load_checkpoint(model, FLAG_PT)
        model = model.cuda().eval()
        n_gn = sum(isinstance(m, GroupNormF32) for m in model.modules())
        n_attn = sum(isinstance(m, AttnBlock) for m in model.modules())
        shapes = op_shapes(model, torch.zeros(2, 256, 256, 3, device="cuda"))
        bf16 = cast_torso(DDPMUNet(resolution=256), torch.bfloat16)
        bf16.load_state_dict(model.state_dict())
        bf16 = bf16.cuda().eval()
        main_shapes = op_shapes(bf16, torch.zeros(8, 256, 256, 3, device="cuda"))
        del bf16
        gen = torch.Generator(device="cuda").manual_seed(0)
        # each GroupNorm shape checks both kernels and, as a yardstick against
        # F.group_norm, the pair
        kinds = {"groupnorm": ("groupnorm_stats", "groupnorm_apply", "groupnorm"),
                 "attention": ("attention",)}
        results = {}
        for op, shape, dtype in sorted(set(shapes) | set(main_shapes), key=str):
            for kind in kinds[op]:
                r = check_kernel(kind, shape, dtype, gen)
                results[(kind, shape, dtype)] = r
                lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
                print(f"{kind:15s} {str(shape):22s} {r['dtype']:8s} "
                      f"err {r['max_abs_err']:.2e} (tol {r['tol']:.1e}) "
                      f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
                      f"library {lib}  bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']})", flush=True)
        # per UNet forward of the main path (bf16, batch 8): each shape's time
        # times its calls per forward
        per_forward = {}
        for op, kind_list in kinds.items():
            for kind in kind_list:
                rows = [(results[(kind, s, d)], c) for (o, s, d), c in main_shapes.items()
                        if o == op]
                per_forward[kind] = {
                    f: (None if rows[0][0][f] is None else sum(r[f] * c for r, c in rows))
                    for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
                per_forward[kind]["max_abs_err"] = max(
                    r["max_abs_err"] for k, r in results.items() if k[0] == kind)
                per_forward[kind]["bound_by"] = rows[0][0]["bound_by"]
                print(f"{kind}: per bf16 batch-8 forward ({sum(c for _, c in rows)} "
                      "calls): " + json.dumps(per_forward[kind]), flush=True)
        fwht_rows = [check_kernel("fwht", shape, torch.float32, gen) for shape in FWHT_SHAPES]
        for r in fwht_rows:
            print(f"{'fwht':15s} {str(r['shape']):22s} {r['dtype']:8s} "
                  f"err {r['max_abs_err']:.2e} (tol {r['tol']:.1e}) "
                  f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
                  f"library {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})", flush=True)
        # per call at the SVD main path's shape (batch 8)
        per_forward["fwht"] = {f: fwht_rows[-1][f] for f in
                               ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        per_forward["fwht"]["max_abs_err"] = max(r["max_abs_err"] for r in fwht_rows)
        print("fwht: per (8, 3, 65536) call: " + json.dumps(per_forward["fwht"]), flush=True)
        print("kernels: " + json.dumps(sorted(SOURCES)), flush=True)

    with phase(4, "full-width fp32 parity with the JAX golden"):
        par = parity_fp32(model, n_gn, n_attn)
        for mode in ("kernel", "torch"):
            r = par[mode]
            print(f"{mode:6s}: PSNR {['%.4f' % p for p in r['psnr']]} "
                  f"pool8 max abs vs golden {r['pool8_max_abs_vs_golden']:.3e} "
                  f"{r['seconds']:.2f} s launches {r['launches']}", flush=True)
        print(f"kernel vs plain final images: max abs {par['kernel_vs_torch_max_abs']:.3e}",
              flush=True)

    with phase(5, "main path through main_torch (bf16, batch 8, 100 steps)"):
        _, launches_simplified = main_path("sr_averagepooling", "4", True, n_gn, n_attn, 0)

    with phase(6, "full-width fp32 SVD-mode parity with the JAX golden"):
        parity_svd(model, n_gn, n_attn)
        del model
        torch.cuda.empty_cache()

    with phase(7, "SVD main path through main_torch (cs_walshhadamard 0.25, bf16, "
                  "batch 8, 100 steps)"):
        # the runner's A+y preview (1) on top of A(x), the set-up and the steps
        _, launches = main_path("cs_walshhadamard", "0.25", False, n_gn, n_attn,
                                1 + fwht_launches("cs_walshhadamard", 0.0, 100))

    # launches: the SVD main path's (phase 7, which runs all four kernels);
    # launches_by_path adds the simplified main path's (phase 5)
    summary = {"kernels": [
        {"name": kind, "route": "cuda", "source": SOURCES[kind][0],
         "replaces": SOURCES[kind][1], "launches": launches[kind],
         "launches_by_path": {"simplified": launches_simplified[kind],
                              "svd": launches[kind]},
         "max_abs_err": per_forward[kind]["max_abs_err"], "ms": per_forward[kind]["ms"],
         "plain_ms": per_forward[kind]["plain_ms"],
         "bound_ms": per_forward[kind]["bound_ms"],
         "bound_by": per_forward[kind]["bound_by"],
         "library_ms": per_forward[kind]["library_ms"]}
        for kind in SOURCES]}
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
