#!/usr/bin/env python3
"""The fused GN+SiLU+conv experiment on PyTorch/CUDA (ddnm_tpu_torch).

Port of the JAX experiment (fused_gn_conv.py, fused_gn_conv_ablations.py,
fused_gn_conv_trace.py beside this file). It asks whether one kernel that
applies the GroupNorm affine and SiLU while loading the input of a 3x3
convolution beats the unfused chain. It is an experiment, not a route of
the UNet.

    python3 tools/experiments/fused_gn_conv_torch.py              # (a)
    python3 tools/experiments/fused_gn_conv_torch.py --ablations  # (b)
    python3 tools/experiments/fused_gn_conv_torch.py --trace kernel_full  # (c)
    python3 tools/experiments/fused_gn_conv_torch.py --unet       # (d)
    python3 tools/experiments/fused_gn_conv_torch.py --device cpu --shape 2,32,32,64

  (a) max |diff| of the fused kernel route against the plain chain
      (`fused_gn_conv(force="torch")`, fp32 conv, TF32 off), then ms per
      iteration of the unfused chain (the port's GroupNorm kernels, F.silu,
      F.conv2d in bf16: the counterpart of the XLA chain) and of the fused
      route, each looped n_iter times with its output fed back, the median
      of 5 loops timed with CUDA events, and the conv's TFLOP/s;
  (b) the experiment's seven ablation variants the same way (the port pads
      nothing, so "stats + pad" is the stats kernel alone);
  (c) device-busy ms per iteration of one variant from torch.profiler;
  (d) the fused route and the conv alone against the unfused chain and
      F.conv2d at the DDPM UNet's Cin = Cout 3x3 shapes at batch 8
      (configs/celeba_hq.yml, eps 1e-6).

Data as in the experiment, from a seeded torch.Generator: x ~ N(0, 1), w ~
0.05 N(0, 1) (HWIO), both bf16; gamma 1, beta 0; 32 groups, eps 1e-5. The
default shape is the experiment's (8, 256, 256, 128). `--device` is cuda
unless the CPU is asked for, where the plain routes run and nothing is
timed. Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.nn import functional as F

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from ddnm_tpu_torch import ops  # noqa: E402
from ddnm_tpu_torch.ops import groupnorm  # noqa: E402
from ddnm_tpu_torch.runtime import resolve_device  # noqa: E402

GROUPS = 32
SHAPE = (8, 256, 256, 128)
# the DDPM UNet's Cin = Cout 3x3 convolutions (ResnetBlock conv2) at batch 8:
# ch 128, ch_mult 1,1,2,2,4,4 over 256 px (configs/celeba_hq.yml:8-9)
UNET_SHAPES = ((8, 256, 256, 128), (8, 128, 128, 128), (8, 64, 64, 256),
               (8, 32, 32, 256), (8, 16, 16, 512), (8, 8, 8, 512))
# variant: (the JAX experiment's line, kernel launches per iteration on a card)
VARIANTS = {
    "chain": ("XLA GN+SiLU+conv", {"groupnorm_stats": 1, "groupnorm_apply": 1}),
    "conv": ("XLA conv only", {}),
    "stats": ("stats only", {"groupnorm_stats": 1}),
    "kernel_conv": ("prologue + kernel(conv only, no act)", {"fused_gn_conv": 1}),
    "kernel_act": ("prologue + kernel(act only, no dot)",
                   {"groupnorm_stats": 1, "fused_gn_conv": 1}),
    "kernel_full": ("prologue + kernel(full)", {"groupnorm_stats": 1, "fused_gn_conv": 1}),
}
DEFAULT_VARIANTS = ("chain", "kernel_full")
REPS = 5  # timed loops per variant (median), as the JAX experiment


def make_inputs(shape, device):
    B, H, W, C = shape
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(shape, device=device, generator=gen).bfloat16()
    w = (torch.randn((3, 3, C, C), device=device, generator=gen) * 0.05).bfloat16()
    return x, w, torch.ones(C, device=device), torch.zeros(C, device=device)


def variant_fns(w, gamma, beta, eps):
    """{variant: z -> z}: each takes and returns NHWC bf16 (the stats kernel
    returns its input; eager PyTorch neither hoists nor drops a call)."""
    w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)  # OIHW

    def conv(z):  # channels_last: cuDNN reads and writes NHWC memory
        return F.conv2d(z.permute(0, 3, 1, 2), w_cl, padding=1).permute(0, 2, 3, 1).contiguous()

    def chain(z):
        return conv(F.silu(ops.group_norm(z, gamma, beta, num_groups=GROUPS, eps=eps)))

    def stats(z):
        pair = groupnorm._stats_affine if z.is_cuda else groupnorm._torch_stats_affine
        pair(z, gamma, beta, GROUPS, eps, None, None)
        return z

    def kernel(mode):
        return lambda z: ops.fused_gn_conv(z, w, gamma, beta, num_groups=GROUPS, eps=eps,
                                           mode=mode)

    return {"chain": chain, "conv": conv, "stats": stats, "kernel_conv": kernel("conv"),
            "kernel_act": kernel("act"), "kernel_full": kernel("full")}


def run_loop(fn, z, n_iter):
    for _ in range(n_iter):
        z = fn(z)
    return z


def measure(name, fn, x, n_iter):
    """One counted loop (warm-up; launches checked), then on a card the
    median ms per iteration of REPS event-timed loops."""
    ops.reset_launch_counts()
    out = run_loop(fn, x, n_iter)
    cuda = x.is_cuda
    if cuda:
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    want = {k: (n_iter * VARIANTS[name][1].get(k, 0) if cuda else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} != {want}")
    res = {"ms": None, "launches": launches, "finite": bool(torch.isfinite(out.float()).all())}
    if cuda:
        ts = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run_loop(fn, x, n_iter)
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end) / n_iter)
        res["ms"] = statistics.median(ts)
    return res


def conv_flops(shape):
    B, H, W, C = shape
    return 2 * B * H * W * 9 * C * C


def trace(name, fn, x, n_iter):
    """Device-busy ms per iteration over one profiled loop, and the top 4
    kernels by device time (the counterpart of fused_gn_conv_trace.py)."""
    from torch.profiler import ProfilerActivity, profile

    run_loop(fn, x, n_iter)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_loop(fn, x, n_iter)
        torch.cuda.synchronize()
    by_kernel: dict[str, float] = {}
    for ev in prof.events():  # device-side events: one per kernel run
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
    print(f"== {name}: busy per iter over {n_iter} iters ==", flush=True)
    for kname, ms in top:
        print(f"{ms / n_iter:9.4f} ms/iter  {kname[:100]}", flush=True)
    busy = sum(by_kernel.values()) / n_iter
    print(f"device busy {busy:.4f} ms/iter", flush=True)
    return {"variant": name, "busy_ms_per_iter": busy,
            "top": [[k, ms / n_iter] for k, ms in top]}


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def print_row(label, shape, r):
    if r["ms"] is None:
        print(f"{label:40s}: not measured (CPU run); launches {r['launches']}", flush=True)
        return
    tf = f" ({conv_flops(shape) / r['ms'] / 1e9:.1f} TFLOP/s)" if "tflops" in r else ""
    print(f"{label:40s}: {r['ms']:8.4f} ms/iter{tf}", flush=True)


def unet_table(device, n_iter):
    """Fused route and conv alone against the unfused chain and F.conv2d at
    the UNet's 3x3 Cin = Cout shapes, eps 1e-6 (timing only)."""
    rows = []
    for shape in UNET_SHAPES:
        x, w, g, b = make_inputs(shape, device)
        fns = variant_fns(w, g, b, 1e-6)
        row = {"shape": list(shape)}
        for name in ("chain", "kernel_full", "conv", "kernel_conv"):
            row[name] = measure(name, fns[name], x, n_iter)["ms"]
        rows.append(row)
        print(f"unet {str(shape):22s} chain {row['chain']:.4f}  full {row['kernel_full']:.4f}"
              f"  F.conv2d {row['conv']:.4f}  kernel conv {row['kernel_conv']:.4f} ms/iter",
              flush=True)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a "
                    "card) or cpu (plain routes, nothing timed)")
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)), help="B,H,W,C")
    ap.add_argument("--n_iter", type=int, default=50, help="iterations per timed loop")
    ap.add_argument("--ablations", action="store_true", help="all seven variants")
    ap.add_argument("--trace", choices=sorted(VARIANTS), help="device-busy ms of a variant")
    ap.add_argument("--unet", action="store_true", help="the UNet-shape table at batch 8")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if args.trace and not cuda:
        raise SystemExit("--trace reads device time: it needs a card (--device cuda)")
    shape = tuple(int(v) for v in args.shape.split(","))
    if cuda:
        torch.backends.cudnn.allow_tf32 = False  # the plain route's fp32 conv is the reference
        torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": torch.cuda.get_device_name(device) if cuda else "cpu",
              "nvidia_smi": nvidia_smi_line() if cuda else None, "shape": list(shape),
              "n_iter": args.n_iter, "conv_flops": conv_flops(shape)}
    if result["nvidia_smi"]:
        print(result["nvidia_smi"], flush=True)

    x, w, g, b = make_inputs(shape, device)
    fns = variant_fns(w, g, b, 1e-5)
    if args.trace:
        result["trace"] = trace(args.trace, fns[args.trace], x, args.n_iter)
    else:
        out = ops.fused_gn_conv(x, w, g, b, num_groups=GROUPS)
        ref = ops.fused_gn_conv(x, w, g, b, num_groups=GROUPS, force="torch")
        result["max_abs_diff"] = float((out.float() - ref.float()).abs().max())
        result["max_abs_plain"] = float(ref.float().abs().max())
        print(f"max |diff| of the fused route vs the plain chain: "
              f"{result['max_abs_diff']:.5f} (max |plain| {result['max_abs_plain']:.3f})",
              flush=True)
        names = list(VARIANTS) if args.ablations else list(DEFAULT_VARIANTS)
        result["variants"] = {}
        for name in names:
            r = measure(name, fns[name], x, args.n_iter)
            if name in ("chain", "conv", "kernel_conv", "kernel_full") and r["ms"]:
                r["tflops"] = conv_flops(shape) / r["ms"] / 1e9
            result["variants"][name] = r
            print_row(VARIANTS[name][0], shape, r)
            if name == "stats" and args.ablations:
                print(f"{'stats + pad':40s}: = stats only (the port pads nothing)", flush=True)
    if args.unet:
        if not cuda:
            raise SystemExit("--unet times the card: it needs --device cuda")
        result["unet"] = unet_table(device, args.n_iter)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
