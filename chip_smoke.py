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
     UNet forwards of phases 4 and 5 give them: the GroupNorm stats kernel
     (one launch: cluster sums folded into the affine; the same bits on a
     second call) and apply kernel each against its own plain version,
     the whole GroupNorm against the plain GroupNorm, attention against the
     plain attention; max abs error, kernel ms, plain ms, the library
     call's ms where one call computes the same function (F.group_norm for
     the whole GroupNorm, F.scaled_dot_product_attention; timed as a
     yardstick, never used by the port) and the least time the card could
     take (bound); the apply kernel with and without its SiLU epilogue, as
     the forward calls it (norm1, norm2 and norm_out end in the SiLU). Kernel and library ms are timed back to back (the host's
     launch cost included); device ms queue the calls behind a sleep kernel
     (the card's time alone). Then the edge shapes no UNet forward of phases 4-7
     gives: attention at T = 1, T = 17, C = 32, both sides of the
     whole-row softmax limit and the ADM heads (C = 64 at T = 64, 256 and
     1024; C = 32 at T = 1024) in bf16 and fp32, the stats kernel with
     FiLM at (8, 16, 16, 768), and the apply kernel's 1-channel path (an
     unaligned view, C = 36) with and without SiLU in fp32 and bf16;
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
     --simplified, on cs_walshhadamard at ratio 0.25;
  8. the fused GN+SiLU+conv experiment through its ported driver
     (tools/experiments/fused_gn_conv_torch.py, in process): the default
     run and the ablations at the experiment's (8, 256, 256, 128), each
     variant's launch counts checked exactly, and the fused route and the
     conv alone timed against the unfused chain and F.conv2d at the DDPM
     UNet's 3x3 Cin = Cout shapes at batch 8;
  9. hq parity on the toy32 ADM UNet (tests/fixtures/toy_adm32.pt): the six
     unguided hq golden tasks through sample_posterior in fp32 through the
     kernels, each within 0.01 dB of the JAX package's PSNR
     (tests/fixtures/toy_adm32_psnr.json), the first also through the plain
     versions; the bf16 PSNRs printed beside the bf16 goldens (not gated);
     Mask-Shift on a 48 x 48 canvas (tile 32, stride 16, 2 x 2 tiles) in
     the sequential fresh, wavefront and carry orders, the wavefront equal to
     the sequential fresh order bit for bit;
 10. the hq main path through hq_main_torch: the full-width ADM UNet of
     configs/hq/inet256.yml (classifier_scale 0, random weights from the
     seed, bf16 torso), 4x average-pooling SR with --resize_y of a 96 x 96
     PNG made from exp/datasets/imagenet: a 384 x 384 canvas, 2 x 2 tiles of
     280 model calls; wall seconds, seconds per tile, model calls per second,
     the kernels' launches per model call and max |A(final) - y|;
 11. main-runner parity on the toy32 ADM UNet (tests/fixtures/toy_adm32.pt):
     the six ImageNet rows of evaluation.py (SVD mode) through the model,
     operator and dataset that the port's Runner builds from the golden's
     config, fp32, zero noise, x_T from RandomState(42), 20 steps; each once
     through the kernels and once through the plain versions, every image
     within 0.01 dB of the JAX package's PSNR
     (tests/fixtures/toy_adm32_main_golden.json), kernel against plain;
 12. the ImageNet rows through evaluation_torch: configs/imagenet_256.yml
     (the 552.8M ADM UNet, unconditional), random weights from seed 1234,
     bf16 torso, the 8 PNGs of exp/datasets/imagenet, batch 8, 100 steps,
     exp/inp_masks/mask.npy for inpainting, one row at a time; images/s in
     the sampler and end to end, launches per step, max |A(x) - y| of the
     sampler's output on the SR and inpainting rows; then the two noisy
     CelebA rows (--add_noise, sigma_y 0.2) on flag_ddpm256.pt at 25 steps,
     each with a finite PSNR;
 13. guided parity on the toy32 ADM guided by the toy32 classifier
     (tests/fixtures/toy_adm32.pt, toy_clf32.pt): the guided hq golden
     (tests/fixtures/toy_adm32_guided_golden.json) through sample_posterior
     with classifier_guidance_fn, fp32 through the kernels (the classifier's
     backward through the backward kernels) within 0.01 dB of the JAX
     package's PSNR, per-image max |delta| against the JAX output, launch
     counts exact; the same through the plain versions, kernel against
     plain; one guidance gradient through the kernels against force="torch";
     bf16 printed beside JAX's bf16 PSNR (not gated; ROADMAP's watch item);
 14. the guided configurations at full width, bf16, random weights from
     seed 1234: one 256 px tile of configs/hq/inet256.yml (classifier_scale
     1.0: the 553.8M ADM and the 54,096,360-parameter classifier, 280 model
     calls) through hq_main_torch, and the configs/imagenet_256_cc.yml row
     through main_torch (SVD 4x average-pooling SR, batch 8, 100 steps,
     --random_init); s per tile, images/s, launches per model call of
     every forward and backward kernel against the module counts, max
     |A(x) - y|; per guidance call at batch 1 and 8, its ms, launches and
     gradient norm (finite, non-zero), and its gradient with every layer of
     the classifier drawn (so that each GroupNorm and attention backward
     gets a non-zero dy, counted) against the same weights in fp32 with
     force="torch": the kernels in fp32, and in bf16 beside the bf16 plain
     route's own distance.

Phase 3 also holds the four backward kernels (gn_bwd_reduce, gn_bwd_dx,
attn_bwd_dq, attn_bwd_dkdv; no TPU counterpart) against their plain
versions, and each pair against autograd through the plain forward, in
fp32 and bf16 at every shape of three classifier forwards (the toy32
classifier at batch 2; the 256 px classifier at batch 1 and 8), timed
beside the library's autograd backward (F.group_norm, SDPA), and sums
their times per guidance call.
Phase 3 also holds the GroupNorm (with FiLM) and attention kernels against
their plain versions at every shape of phase 10's ADM forward (one tile,
bf16) and of phase 12's (batch 8, 256 px, bf16) and sums their times per
such forward.
Phase 2 prints the -Xptxas -v registers and spills of the conv, apply and
Walsh-Hadamard kernels. Phase 3 also holds the Walsh-Hadamard kernel
against its plain version at the SVD paths' shapes and at edge shapes (one
slab, a ragged slab count, every tier's P, P = 1 and 2, 100 MB), each with
the same bits on a second call and on a strided view, one wrapper call and
one CUDA launch a call (torch.profiler), and its share of the bound on the
device; and the fused GN+SiLU+conv kernel in its
three modes (full, conv, act) at the experiment's shape, a small one and a
ragged one (the conv kernel's bits equal on two calls), back to back and
on the device beside F.conv2d and the unfused chain.
Each of phases 4-14 sets the launch counts to 0 just before each run it
drives and checks them exactly just after.

The line before the last is the JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}. Outputs go to a temporary directory.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import re
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
from ddnm_tpu_torch.ops.attention import (  # noqa: E402
    WHOLE_ROW_MAX_T,
    _attn_bwd_dkdv,
    _attn_bwd_dq,
    _kernel_attention,
    _torch_attention,
    _torch_attention_backward,
    _torch_attn_bwd_dkdv,
    _torch_attn_bwd_dq,
)
from ddnm_tpu_torch.ops.fused_gn_conv import (  # noqa: E402
    _kernel_fused_gn_conv,
    _torch_fused_gn_conv,
)
from ddnm_tpu_torch.ops.fwht import (  # noqa: E402
    _factor,
    _kernel_fwht,
    _torch_fwht,
    hadamard_matrix,
)
from ddnm_tpu_torch.ops.groupnorm import (  # noqa: E402
    _apply,
    _bwd_dx,
    _bwd_reduce,
    _kernel_group_norm,
    _stats_affine,
    _torch_apply,
    _torch_bwd_dx,
    _torch_bwd_reduce,
    _torch_group_norm,
    _torch_group_norm_backward,
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
#    the sums run in another order (per thread, pixel lane, block, cluster);
#  - GroupNorm apply and the pair, fp32: one FMA against a multiply and an
#    add, and (pair) the plain version normalises then scales;
#  - GroupNorm apply and the pair, bf16: the fp32 values agree to ~1e-6 and
#    rounding to bf16 may then land one ulp (<= 2^-7 relative) apart;
#  - attention fp32: 512-term fp32 dot products in another order, then exp;
#  - attention bf16: the plain version (as the JAX XLA path) rounds the
#    scores to bf16 before the softmax, the kernel (as the Pallas kernel)
#    keeps them fp32: ~1% noise on each probability, averaged over T keys;
#  - fwht fp32: sums of 65536 +-x terms in another order (butterfly against
#    the plain einsum);
#  - fused_gn_conv bf16: both sides sum the same bf16 products in fp32 (in
#    another order; the plain conv with TF32 off) and round once to bf16, so
#    they may land one bf16 ulp (<= 2^-7 relative) apart.
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
    ("fused_gn_conv", torch.bfloat16): 1e-2,
    # the backward kernels (new in the port; no TPU counterpart) against
    # their plain versions, both in fp32 arithmetic on the same inputs:
    #  - gn_bwd_reduce: (3, B, C) fp32 coefficients from fp32 sums taken in
    #    another order (as the stats kernel);
    #  - gn_bwd_dx: one FMA chain against the plain version's; bf16 output
    #    may land one ulp (<= 2^-7 relative) apart;
    #  - attn_bwd_dq / attn_bwd_dkdv: T-term fp32 sums in another order,
    #    exp against torch.exp; bf16 outputs one ulp apart;
    #  - gn_bwd / attn_bwd (each pair, whole backward) against autograd
    #    through the plain forward: fp32 the same function by another
    #    formula; bf16 autograd rounds the forward's scores (attention) and
    #    norm to bf16 and back-propagates through them, the kernels keep fp32
    ("gn_bwd_reduce", torch.float32): 1e-4,
    ("gn_bwd_reduce", torch.bfloat16): 1e-4,
    ("gn_bwd_dx", torch.float32): 1e-5,
    ("gn_bwd_dx", torch.bfloat16): 1e-2,
    ("attn_bwd_dq", torch.float32): 1e-4,
    ("attn_bwd_dq", torch.bfloat16): 1e-2,
    ("attn_bwd_dkdv", torch.float32): 1e-4,
    ("attn_bwd_dkdv", torch.bfloat16): 1e-2,
    ("gn_bwd", torch.float32): 1e-4,
    ("gn_bwd", torch.bfloat16): 3e-2,
    ("attn_bwd", torch.float32): 1e-4,
    ("attn_bwd", torch.bfloat16): 5e-2,
}
# the kernels of the JSON summary: source, and the pl.pallas_call it replaces
SOURCES = {
    "groupnorm_stats": ("ddnm_tpu_torch/csrc/groupnorm.cu", "ddnm_tpu/ops/groupnorm.py:95"),
    "groupnorm_apply": ("ddnm_tpu_torch/csrc/groupnorm.cu", "ddnm_tpu/ops/groupnorm.py:77"),
    "attention": ("ddnm_tpu_torch/csrc/attention.cu",
                  "ddnm_tpu/ops/attention.py:63"),
    "fwht": ("ddnm_tpu_torch/csrc/fwht.cu", "ddnm_tpu/ops/fwht.py:71"),
    "fused_gn_conv": ("ddnm_tpu_torch/csrc/fused_gn_conv.cu",
                      "tools/experiments/fused_gn_conv.py:114 + "
                      "tools/experiments/fused_gn_conv_ablations.py:132"),
    # the backward kernels replace no pl.pallas_call: the JAX package takes
    # the guidance gradient with jax.grad through its XLA GroupNorm and
    # attention
    "gn_bwd_reduce": ("ddnm_tpu_torch/csrc/groupnorm.cu",
                      "ddnm_tpu/models/unet_adm.py:556 (jax.grad through XLA)"),
    "gn_bwd_dx": ("ddnm_tpu_torch/csrc/groupnorm.cu",
                  "ddnm_tpu/models/unet_adm.py:556 (jax.grad through XLA)"),
    "attn_bwd_dq": ("ddnm_tpu_torch/csrc/attention.cu",
                    "ddnm_tpu/models/unet_adm.py:556 (jax.grad through XLA)"),
    "attn_bwd_dkdv": ("ddnm_tpu_torch/csrc/attention.cu",
                      "ddnm_tpu/models/unet_adm.py:556 (jax.grad through XLA)"),
}
BACKWARD = ("gn_bwd_reduce", "gn_bwd_dx", "attn_bwd_dq", "attn_bwd_dkdv")
# attention shapes beyond the UNet forwards': T = 1, T = 17, C = 32, both
# sides of the whole-row softmax limit (the last runs the online softmax),
# the ADM heads of configs/imagenet_256.yml (64 channels; 1024, 256 and 64
# tokens at its 32, 16 and 8 px grids; batch 8 x 8 or 16 heads) and of
# configs/hq/adm128.yml (32 channels, 1024 tokens at 32 px)
EDGE_ATTENTION_SHAPES = ((4, 1, 512), (3, 17, 512), (5, 33, 32),
                         (2, WHOLE_ROW_MAX_T, 512), (2, WHOLE_ROW_MAX_T + 1, 512),
                         (64, 1024, 64), (128, 256, 64), (128, 64, 64), (24, 1024, 32))
# the Walsh-Hadamard transform's shapes: on the SVD paths, 3 planes of 65536
# per image, batch 2 (phase 6) and 8 (phase 7, the per-call entry of the
# summary); one slab (one cluster); a ragged slab count; the toy32, mid64
# and 128 px tiers' P; P = 1 and 2 (ragged 16-byte tails); and 100 MB, more
# than the 50 MB L2, which keeps the share of the HBM bound honest
FWHT_SHAPES = ((2, 3, 65536), (8, 3, 65536), (1, 1, 65536), (25, 65536), (8, 3, 1024),
               (8, 3, 4096), (8, 3, 16384), (7, 1), (5, 3, 2), (64, 3, 65536))
FWHT_MAIN_SHAPE = (8, 3, 65536)
# the fused GN+SiLU+conv kernel: the experiment's shape, the CPU test's, a
# ragged one (H, W not multiples of the tile, C = 96 = 3 x 32)
FUSED_SHAPES = ((8, 256, 256, 128), (2, 32, 32, 64), (3, 20, 36, 96))
EXPERIMENT = REPO / "tools" / "experiments" / "fused_gn_conv_torch.py"


def expected_launches(n_gn: int = 0, n_attn: int = 0, n_gn_bwd: int = 0, n_attn_bwd: int = 0,
                      **others) -> dict:
    """Every kernel wrapper's launch count as a run should leave it: `n_gn`
    GroupNorms forward (stats and apply), `n_attn` attentions forward,
    `n_gn_bwd` and `n_attn_bwd` of each backward (both kernels), `others`
    by name, 0 for the rest."""
    return dict(dict.fromkeys(ops.launch_counts(), 0), groupnorm_stats=n_gn,
                groupnorm_apply=n_gn, gn_bwd_reduce=n_gn_bwd, gn_bwd_dx=n_gn_bwd,
                attention=n_attn, attn_bwd_dq=n_attn_bwd, attn_bwd_dkdv=n_attn_bwd, **others)


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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() with the host's launch cost hidden: a
    sleep kernel holds the stream while the `iters` calls are queued behind
    it, so the events time the card's work alone. `cuda_ms` times calls back
    to back, where a call whose kernel is shorter than its host side shows
    the host side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's 1.98 GHz, > the queueing
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 2


def ptxas_summary(lines: list[str]) -> list[str]:
    """One line per kernel of a `-Xptxas -v` report: registers, stack and
    spills, and any note that ptxas serialised its wgmma instructions."""
    def short(text):
        found = re.search(r"\d((?:fgc|gn|fwht)_[a-z_]*kernel)(I\w*?E)?E", text)
        return found.group(1) + (found.group(2) or "") if found else text

    out, name = [], None
    for line in lines:
        if "Compiling entry function" in line or "Function properties for" in line:
            name = short(line)
        elif "spill" in line or "Used" in line:
            out.append(f"ptxas {name}: {line.split(':')[-1].strip()}")
        elif "wgmma" in line:
            out.append(f"ptxas {short(line)}: {line.split(':', 1)[-1].split(' for the')[0].strip()}")
    return out


# ------------------------------------------------------------------ phase 3


def forward_ops(model, x_nhwc, *args) -> list:
    """The GroupNorm and attention calls of one forward of `model` (the
    DDPM UNet, the ADM UNet or the classifier, with its `args`, e.g. the
    labels) on x_nhwc, in order (forward pre-hooks, under no_grad; the calls
    run the kernels): ("gn", NHWC shape, dtype, swish, film) and ("attn",
    kernel shape (B * heads, T, C / heads), dtype)."""
    from ddnm_tpu_torch.models.nn import GroupNormF32
    from ddnm_tpu_torch.models.unet_adm import AttentionBlock, AttentionPool2d
    from ddnm_tpu_torch.models.unet_ddpm import AttnBlock

    ops: list = []

    def gn_hook(m, a):
        b, c, h, w = a[0].shape
        ops.append(("gn", (b, h, w, c), a[0].dtype, m.swish, len(a) > 1 and a[1] is not None))

    def attn_hook(m, a):
        b, c, h, w = a[0].shape
        heads = getattr(m, "num_heads", 1)
        t = h * w + isinstance(m, AttentionPool2d)  # the pool's mean token
        ops.append(("attn", (b * heads, t, c // heads), a[0].dtype))

    handles = [m.register_forward_pre_hook(gn_hook if isinstance(m, GroupNormF32)
                                           else attn_hook)
               for m in model.modules()
               if isinstance(m, (GroupNormF32, AttnBlock, AttentionBlock, AttentionPool2d))]
    with torch.no_grad():
        model(x_nhwc, torch.full((x_nhwc.shape[0],), 500.0, device=x_nhwc.device), *args)
    for h in handles:
        h.remove()
    return ops


def op_shapes(model, x_nhwc, *args) -> dict:
    """{("groupnorm"|"attention", shape, dtype): calls per forward} of one
    `forward_ops` forward; ("groupnorm_swish", shape, dtype) counts the
    GroupNorm calls among them that end in the SiLU epilogue,
    ("groupnorm_film", shape, dtype) those that take the ADM ResBlock's FiLM
    scale and shift."""
    seen: dict = {}

    def count(key):
        seen[key] = seen.get(key, 0) + 1

    for op in forward_ops(model, x_nhwc, *args):
        if op[0] == "gn":
            _, shape, dtype, swish, film = op
            count(("groupnorm", shape, dtype))
            if swish:
                count(("groupnorm_swish", shape, dtype))
            if film:
                count(("groupnorm_film", shape, dtype))
        else:
            count(("attention",) + op[1:])
    return seen


def check_kernel(kind: str, shape: tuple, dtype: torch.dtype, gen: torch.Generator,
                 film: bool = False, swish: bool = False, offset: int = 0, groups: int = 32):
    """Kernel vs plain (vs library, where one call computes the same
    function) at one shape; returns a result dict. Kinds: groupnorm_stats
    (with FiLM if `film`; two kernel calls must give the same bits),
    groupnorm_apply (with the SiLU epilogue if `swish`), groupnorm (the
    pair, against F.group_norm), attention, fwht (against the einsum H_a X
    H_b in fp32, TF32 off). GroupNorm kinds: x starts `offset` elements
    into its buffer (1: not on 16 bytes), `groups` groups."""
    dev = "cuda"
    library = None
    if kind.startswith("groupnorm"):
        B, H, W, C = shape
        n = math.prod(shape)
        buf = (torch.randn(n + offset, device=dev, generator=gen) * 2 + 0.5).to(dtype)
        x = buf[offset:].view(shape)
        g = torch.randn(C, device=dev, generator=gen)
        b = torch.randn(C, device=dev, generator=gen)
        peak = PEAK_FLOPS[torch.float32]  # elementwise fp32 on the CUDA cores
        affine_bytes = 2 * B * C * 4
        if kind == "groupnorm_stats":
            fs, ft = ((torch.randn(B, C, device=dev, generator=gen) * 0.3 for _ in range(2))
                      if film else (None, None))
            kern = lambda: _stats_affine(x, g, b, groups, 1e-6, fs, ft)
            plain = lambda: _torch_stats_affine(x, g, b, groups, 1e-6, fs, ft)
            first, second = kern(), kern()
            if not all(torch.equal(u, w) for u, w in zip(first, second)):
                raise AssertionError(f"groupnorm_stats {shape} {dtype}: two calls differ")
            nbytes = x.numel() * x.element_size() + affine_bytes * (2 if film else 1)
            flops = 3 * x.numel()
        elif kind == "groupnorm_apply":
            a_p, b_p = _torch_stats_affine(x, g, b, groups, 1e-6)
            kern = lambda: _apply(x, a_p, b_p, swish)
            plain = lambda: _torch_apply(x, a_p, b_p, swish)
            nbytes = 2 * x.numel() * x.element_size() + affine_bytes
            flops = 2 * x.numel()
        else:
            kern = lambda: _kernel_group_norm(x, g, b, groups, 1e-6, False)
            plain = lambda: _torch_group_norm(x, g, b, groups, 1e-6, False)
            x_nchw = x.permute(0, 3, 1, 2)  # channels_last memory: the same bytes
            g_l, b_l = g.to(dtype), b.to(dtype)
            library = lambda: F.group_norm(x_nchw, groups, g_l, b_l, 1e-6)
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
            "swish": swish, "offset": offset,
            "max_abs_err": err, "tol": tol, "ms": ms, "device_ms": device_ms(kern),
            "library_device_ms": device_ms(library) if library is not None else None,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def cuda_launches(fn, calls: int = 4, tries: int = 3) -> tuple[float, list[str]]:
    """CUDA kernel launches per call of fn(), counted from torch.profiler's
    host-side launch calls (cudaLaunchKernel*) over `calls` calls after one
    warm-up, and the names of the kernels the card ran (device events; the
    profiler may miss one of those, so they are not counted). A window in
    which the profiler recorded no device event at all (seen once on a
    4 us kernel) is profiled again, up to `tries` windows; the last
    window's counts are returned."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        names = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
    launches = sum(e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith("cudaLaunchKernel") for e in events)
    if not launches:
        raise AssertionError("the profiler recorded no cudaLaunchKernel* call: " + str(sorted(
            {e.name for e in events if "aunch" in e.name})))
    return launches / calls, sorted(names)


def check_fwht(shape: tuple, gen: torch.Generator) -> dict:
    """The Walsh-Hadamard kernel at one shape: check_kernel's comparison and
    times, then the same bits on a second call and on a strided view, one
    wrapper call counted a call, and one CUDA launch a call (profiler)."""
    r = check_kernel("fwht", shape, torch.float32, gen)
    x = torch.randn(shape, device="cuda", generator=gen)
    norm = float(shape[-1]) ** 0.5
    ops.reset_launch_counts()
    out = _kernel_fwht(x, norm)
    if ops.launch_counts()["fwht"] != 1:
        raise AssertionError(f"fwht {shape}: {ops.launch_counts()['fwht']} wrapper calls counted")
    view = x.transpose(0, 1).contiguous().transpose(0, 1)
    if not (torch.equal(out, _kernel_fwht(x, norm)) and torch.equal(out, _kernel_fwht(view, norm))):
        raise AssertionError(f"fwht {shape}: two calls, or a view, give other bits")
    per_call, names = cuda_launches(lambda: _kernel_fwht(x, norm))
    if per_call != 1 or not names or not all("fwht_kernel" in n for n in names):
        raise AssertionError(f"fwht {shape}: {per_call} CUDA launches a call ({names})")
    return dict(r, cuda_launches_per_call=per_call, kernel_names=names,
                device_share_of_bound=r["bound_ms"] / r["device_ms"])


def check_fused(mode: str, shape: tuple, gen: torch.Generator) -> dict:
    """The fused GN+SiLU+conv kernel against its plain version in one mode:
    x with a non-zero mean and random gamma, beta (an unmasked border would
    show), eps 1e-5. Times the kernel route (stats kernel included), the plain
    route, F.conv2d in bf16 on the same inputs (`library_ms`, conv mode) and
    the unfused chain (the GroupNorm kernels, F.silu and, in full mode,
    F.conv2d: `chain_ms`, full and act), back to back and on the device
    (`*device_ms`); two kernel calls must give the same bits. The bound
    counts the conv's flops
    at the bf16 tensor-core peak (the elementwise work, ~0.008 ms at the
    experiment's shape, is left out) against x and y moved once (and w)."""
    dev = "cuda"
    B, H, W, C = shape
    x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).bfloat16()
    w = (torch.randn(3, 3, C, C, device=dev, generator=gen) * 0.05).bfloat16()
    g = 1 + 0.1 * torch.randn(C, device=dev, generator=gen)
    b = 0.1 * torch.randn(C, device=dev, generator=gen)
    kern = lambda: _kernel_fused_gn_conv(x, w, g, b, 32, 1e-5, mode)
    plain = lambda: _torch_fused_gn_conv(x, w, g, b, 32, 1e-5, mode)
    ref = plain().float()
    first = kern()
    err = float((first.float() - ref).abs().max())
    torch.cuda.synchronize()
    tol = TOL[("fused_gn_conv", torch.bfloat16)] * max(1.0, float(ref.abs().max()))
    if not err <= tol:
        raise AssertionError(f"fused_gn_conv {mode} {shape}: kernel vs plain max abs "
                             f"{err:.3e} > {tol:.3e}")
    if not torch.equal(first, kern()):
        raise AssertionError(f"fused_gn_conv {mode} {shape}: two calls differ")
    w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    conv = lambda z: F.conv2d(z, w_cl, padding=1)
    act = lambda: F.silu(_kernel_group_norm(x, g, b, 32, 1e-5, False)).permute(0, 3, 1, 2)
    library = (lambda: conv(x.permute(0, 3, 1, 2))) if mode == "conv" else None
    chain = {"full": lambda: conv(act()), "act": act}.get(mode)
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    nbytes = 2 * x.numel() * 2 + (w.numel() * 2 if mode != "act" else 0)
    if mode == "act":
        flops, peak = 9 * x.numel(), PEAK_FLOPS[torch.float32]
    else:
        flops, peak = 2 * B * H * W * 9 * C * C, PEAK_FLOPS[torch.bfloat16]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return {"kind": f"fused_gn_conv/{mode}", "shape": shape, "dtype": "bfloat16",
            "max_abs_err": err, "tol": tol, "ms": ms, "device_ms": device_ms(kern),
            "plain_ms": plain_ms,
            "library_ms": cuda_ms(library) if library else None,
            "library_device_ms": device_ms(library) if library else None,
            "chain_ms": cuda_ms(chain) if chain else None,
            "chain_device_ms": device_ms(chain) if chain else None,
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
    want = expected_launches(n_gn * steps, n_attn * steps)
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
            want = (expected_launches(n_gn * steps, n_attn * steps,
                                      fwht=fwht_launches(deg, sigma_y, steps))
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


# ------------------------------------------------------------------ phase 8


def experiment() -> dict:
    """The ported fused GN+SiLU+conv experiment in process: its default run,
    then the ablations with the UNet-shape table. Every variant's launch
    counts are set to 0 before its counted loop and checked exactly after
    it (also inside the driver); the fused route must agree with the plain
    chain."""
    spec = importlib.util.spec_from_file_location("fused_gn_conv_torch", EXPERIMENT)
    exp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exp)
    default = exp.main([])
    ablations = exp.main(["--ablations", "--unet"])
    tol = TOL[("fused_gn_conv", torch.bfloat16)] * max(1.0, default["max_abs_plain"])
    if not default["max_abs_diff"] <= tol:
        raise AssertionError(f"experiment: fused vs plain chain {default['max_abs_diff']:.3e}"
                             f" > {tol:.3e}")
    for run in (default, ablations):
        for name, r in run["variants"].items():
            want = {k: run["n_iter"] * exp.VARIANTS[name][1].get(k, 0) for k in r["launches"]}
            if r["launches"] != want or not r["finite"]:
                raise AssertionError(f"experiment {name}: launches {r['launches']} != "
                                     f"{want} or non-finite output")
    return {"default": default, "ablations": ablations}


# ------------------------------------------------------------ phases 9 and 10

TOY_ADM_PT = REPO / "tests" / "fixtures" / "toy_adm32.pt"
TOY_ADM_JSON = REPO / "tests" / "fixtures" / "toy_adm32.json"
TOY_ADM_PSNR = REPO / "tests" / "fixtures" / "toy_adm32_psnr.json"
TOY_ADM_PSNR_BF16 = REPO / "tests" / "fixtures" / "toy_adm32_psnr_bf16.json"
INET256 = REPO / "configs" / "hq" / "inet256.yml"
# (name, deg, scale, sigma_y): the unguided hq task matrix at toy scale (a
# copy of tests/_golden_adm.py TASKS_HQ without the guided row), its
# protocol: 2 images of exp/datasets/toy32, x_T from RandomState(7), zero
# noise, respacing "25" and the jump schedule below
TASKS_HQ = [
    ("hq_sr_ap_4x", "sr_averagepooling", 4, 0.0),
    ("hq_colorization", "colorization", 0, 0.0),
    ("hq_inpainting", "inpainting", 0, 0.0),
    ("hq_mask_color_sr", "mask_color_sr", 2, 0.0),
    ("hq_sr_color", "sr_color", 2, 0.0),
    ("hq_sr_ap_4x_noisy", "sr_averagepooling", 4, 0.25),
]
HQ_RESPACING = "25"
HQ_JUMP = dict(t_T=25, n_sample=1, jump_length=10, jump_n_sample=2)
HQ_PSNR_TOL = 0.01  # dB, fp32 on the card against the JAX package's fp32


def toy_adm(device, dtype=torch.float32):
    """The toy32 ADM UNet of tests/fixtures/toy_adm32.pt."""
    from ddnm_tpu_torch.models import ADMUNet, cast_torso
    from ddnm_tpu_torch.runner import load_checkpoint

    model = ADMUNet(**json.loads(TOY_ADM_JSON.read_text())["adm_kw"])
    load_checkpoint(model, TOY_ADM_PT)
    model = model.to(device).eval()
    return cast_torso(model, dtype) if dtype != torch.float32 else model


def hq_adm():
    """The full-width ADM UNet of configs/hq/inet256.yml on the card, bf16
    torso, random weights from seed 1234 (as hq_main_torch --random_init)."""
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.models import cast_torso
    from ddnm_tpu_torch.models.unet_adm import init_like_flax
    from hq_main_torch import build_adm_from_hq

    model = init_like_flax(build_adm_from_hq(load_hq_config(INET256), "cuda"), 1234)
    return cast_torso(model.eval(), torch.bfloat16)


def hq_golden_run(model, device, task) -> tuple[float, torch.Tensor, float]:
    """One unguided hq golden task through the port's sample_posterior
    under the golden protocol (tests/_golden_adm.py run_hq_task): returns
    (PSNR of the 2-image batch against the ground truth, final images,
    seconds)."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, sample_posterior

    _, deg, scale, sigma_y = task
    paths = sorted((REPO / "exp" / "datasets" / "toy32").glob("*.png"))[:2]
    gt = torch.from_numpy(np.stack([load_image(p) for p in paths]) * 2.0 - 1.0).to(device)
    xt = np.random.RandomState(7).randn(2, 3, 32, 32).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1))).to(device)
    kw = ({"mask": golden_mask(32).astype(np.float32)}
          if deg in ("inpainting", "mask_color_sr") else {})
    op = build_functional_operator(deg, image_size=32, deg_scale=float(scale or 1),
                                   device=device, **kw)
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=HQ_RESPACING, sigma_y=sigma_y, schedule_jump_params=HQ_JUMP)
    zero = lambda gens, shape: torch.zeros(shape, device=device)
    t0 = time.perf_counter()
    x, _ = sample_posterior(lambda z, t: model(z, t), xt, op.Ap(op.A(gt)), op, tables,
                            [None, None], noise_fn=zero)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    to01 = lambda a: torch.clamp((a + 1) / 2, 0, 1)
    mse = float(((to01(x) - to01(gt)) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-12)), x, secs


def hq_parity(n_gn: int, n_attn: int) -> dict:
    """Phase 9: the six unguided toy32 hq goldens in fp32 through the
    kernels (TF32 off), each within HQ_PSNR_TOL of the JAX package's
    ours_psnr, launch counts exact; the first also through the plain
    versions; the bf16 PSNRs beside the bf16 goldens (not gated); then
    Mask-Shift on a 48 x 48 canvas, tile 32, stride 16 (2 x 2 tiles):
    the wavefront order equal to the sequential fresh order bit for bit."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, n_model_calls
    from ddnm_tpu_torch.tiling import mask_shift_sample

    golden = json.loads(TOY_ADM_PSNR.read_text())
    golden_bf16 = json.loads(TOY_ADM_PSNR_BF16.read_text())
    model = toy_adm("cuda")
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=HQ_RESPACING, schedule_jump_params=HQ_JUMP)
    calls = n_model_calls(tables)
    out = {"tasks": {}}
    for task in TASKS_HQ:
        name = task[0]
        ops.reset_launch_counts()
        psnr, x, secs = hq_golden_run(model, "cuda", task)
        counts = ops.launch_counts()
        r = {"psnr": psnr, "golden": golden[name]["ours_psnr"], "seconds": secs,
             "launches": counts}
        print(f"{name:18s} fp32 kernels: PSNR {psnr:.4f} (JAX {r['golden']:.4f}) "
              f"{secs:.2f} s launches {counts}", flush=True)
        if not abs(psnr - r["golden"]) <= HQ_PSNR_TOL:
            raise AssertionError(f"{name}: PSNR {psnr:.4f} vs JAX {r['golden']:.4f}")
        want = expected_launches(n_gn * calls, n_attn * calls)
        if counts != want:
            raise AssertionError(f"{name}: launch counts {counts} != {want}")
        if name == TASKS_HQ[0][0]:
            set_op_force(model, "torch")
            ops.reset_launch_counts()
            plain_psnr, x_plain, _ = hq_golden_run(model, "cuda", task)
            set_op_force(model, None)
            if any(ops.launch_counts().values()):
                raise AssertionError(f"plain run launched kernels: {ops.launch_counts()}")
            r["plain_psnr"] = plain_psnr
            r["kernel_vs_plain_max_abs"] = float((x - x_plain).abs().max())
            print(f"{name:18s} fp32 plain  : PSNR {plain_psnr:.4f}; kernel vs plain final "
                  f"max abs {r['kernel_vs_plain_max_abs']:.3e}", flush=True)
            if not r["kernel_vs_plain_max_abs"] <= 1e-3:
                raise AssertionError(f"{name}: kernel vs plain {r['kernel_vs_plain_max_abs']}")
        out["tasks"][name] = r
    bf16 = toy_adm("cuda", torch.bfloat16)
    for task in TASKS_HQ:
        name = task[0]
        psnr, _, _ = hq_golden_run(bf16, "cuda", task)
        out["tasks"][name]["bf16_psnr"] = psnr
        print(f"{name:18s} bf16 kernels: PSNR {psnr:.4f} (JAX bf16 "
              f"{golden_bf16[name]['ours_psnr']:.4f}, difference "
              f"{psnr - golden_bf16[name]['ours_psnr']:+.4f} dB; not gated)", flush=True)
    del bf16

    # Mask-Shift at toy scale: 4x SR of a 48 x 48 crop of a natural64 image
    img = load_image(sorted((REPO / "exp" / "datasets" / "natural64").glob("*.png"))[0])
    gt = (img[:48, :48] * 2.0 - 1.0)[None]
    zero = lambda gens, shape: torch.zeros(shape, device="cuda")
    runs = {}
    for label, kw in (("sequential fresh", dict(tile_init="fresh")),
                      ("wavefront", dict(parallel=True)),
                      ("sequential carry", dict(tile_init="carry"))):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = mask_shift_sample(lambda z, t: model(z, t), gt, "sr_averagepooling", tables, 0,
                                scale=4, noise_fn=zero, tile=32, stride=16, device="cuda",
                                **kw)
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        runs[label] = res["final"]
        err = float(np.abs(res["final"].reshape(1, 12, 4, 12, 4, 3).mean(axis=(2, 4))
                           - res["y"]).max())
        print(f"mask-shift 48x48 {label:16s}: {secs:.2f} s, max |A(final) - y| {err:.2e}, "
              f"launches {counts}", flush=True)
        if not (np.isfinite(res["final"]).all() and err <= 1e-4):
            raise AssertionError(f"mask-shift {label}: range-space error {err}")
        if counts["attention"] != 4 * n_attn * calls:
            raise AssertionError(f"mask-shift {label}: launch counts {counts}")
    if not np.array_equal(runs["wavefront"], runs["sequential fresh"]):
        raise AssertionError("mask-shift: wavefront and sequential fresh differ")
    print("mask-shift 48x48: wavefront == sequential fresh, bit for bit", flush=True)
    out["mask_shift_bit_equal"] = True
    return out


def hq_main_path(n_gn: int, n_attn: int) -> tuple[dict, dict]:
    """Phase 10: hq_main_torch on configs/hq/inet256.yml with
    classifier_scale 0 (the unguided configuration), random weights from
    seed 1234, bf16 torso, 4x average-pooling SR of a 96 x 96 PNG (the 4x
    mean pool of a 384 x 384 mosaic of the 192 x 192 centres of
    exp/datasets/imagenet/0000[0-3].png) with --resize_y: a 384 x 384
    canvas, 2 x 2 tiles of 280 model calls, in the reference's sequential
    carry order. Checks the output PNGs, the range-space error and every
    kernel's launch count exactly. Returns (stats, launches)."""
    import hq_main_torch
    from ddnm_tpu_torch.data.io import load_image, save_image

    quads = [load_image(REPO / "exp" / "datasets" / "imagenet" / f"0000{i}.png")[32:224, 32:224]
             for i in range(4)]
    mosaic = np.concatenate([np.concatenate(quads[:2], axis=1),
                             np.concatenate(quads[2:], axis=1)], axis=0)
    small = mosaic.reshape(96, 4, 96, 4, 3).mean(axis=(1, 3))
    conf = INET256.read_text()
    if conf.count("classifier_scale: 1.0") != 1:
        raise AssertionError("configs/hq/inet256.yml: expected one classifier_scale: 1.0")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "inet256_unguided.yml").write_text(
            conf.replace("classifier_scale: 1.0", "classifier_scale: 0.0"))
        save_image(small, tmp / "y96.png")
        ops.reset_launch_counts()
        out = hq_main_torch.main([
            "--config", str(tmp / "inet256_unguided.yml"), "--path_y", str(tmp / "y96.png"),
            "--deg", "sr_averagepooling", "--scale", "4", "--resize_y", "--class", "0",
            "--random_init", "--seed", "1234", "--dtype", "bfloat16",
            "-i", str(tmp / "out")])
        launches = ops.launch_counts()
        pngs = sorted(p.name for p in (tmp / "out").glob("*.png"))
        tiles = sorted(p.name for p in (tmp / "out" / "tiles").glob("*.png"))
    stats = dict(out["stats"])
    final, y = out["final"], out["y"]
    stats["range_space_max_abs"] = float(np.abs(
        final.reshape(1, 96, 4, 96, 4, 3).mean(axis=(2, 4)) - y).max())
    calls = stats["model_calls"]
    per_call = {k: v / calls for k, v in launches.items()}
    print(f"hq main path (inet256 ADM, bf16, 384 x 384, 4 tiles): "
          f"{stats['wall_seconds']:.2f} s wall, {stats['seconds_per_tile']:.2f} s per tile, "
          f"{stats['model_calls_per_second']:.2f} model calls/s ({calls} calls); launches "
          f"{launches}, per model call {per_call}; max |A(final) - y| "
          f"{stats['range_space_max_abs']:.3e}", flush=True)
    if pngs != ["Apy.png", "final.png", "y.png"] or len(tiles) != 4:
        raise AssertionError(f"hq outputs: {pngs}, tiles {tiles}")
    if final.shape != (1, 384, 384, 3) or not np.isfinite(final).all():
        raise AssertionError(f"hq final: shape {final.shape} or non-finite values")
    if not stats["range_space_max_abs"] <= 1e-4:
        raise AssertionError(f"hq range-space error {stats['range_space_max_abs']:.3e}")
    want = expected_launches(n_gn * calls, n_attn * calls)
    if calls != 4 * 280 or launches != want:
        raise AssertionError(f"hq launch counts {launches} != {want} ({calls} calls)")
    return stats, launches


# ------------------------------------------------------------ phases 11 and 12

TOY_ADM_MAIN_GOLDEN = REPO / "tests" / "fixtures" / "toy_adm32_main_golden.json"
IMAGENET_CONFIG = REPO / "configs" / "imagenet_256.yml"
MAIN_PSNR_TOL = 0.01  # dB per image, fp32 on the card against the JAX package's fp32
RANGE_SPACE_TOL = 1e-3  # max |A(x) - y| of the sampler's output, noise-free rows


def main_golden_runner(proto: dict, task, device):
    """The port's Runner for one task of the main-runner golden
    (tools/emit_toy_adm32_main_golden.py): the golden's config and seed,
    its image folder and fixture."""
    import copy

    from ddnm_tpu_torch.config import Config
    from ddnm_tpu_torch.runner import RunArgs, Runner

    _, deg, deg_scale = task
    args = RunArgs(deg=deg, deg_scale=deg_scale, sigma_y=proto["sigma_y"], eta=proto["eta"],
                   seed=proto["seed"], exp=str(REPO / "exp"),
                   path_y=str(REPO / proto["eval_dir"]), ckpt=str(REPO / proto["fixture"]),
                   device=device)
    return Runner(args, Config.from_dict(copy.deepcopy(proto["config"])))


def main_golden_run(model, runner, proto: dict, force=None):
    """One task of the main-runner golden through the model, operator and
    dataset the Runner builds, SVD mode, zero noise, the golden's shared
    x_T; `force` "torch" runs the plain versions. Returns (per-image PSNRs,
    final images, seconds)."""
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force
    from ddnm_tpu_torch.sampling import sample_svd
    from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec

    dev = runner.device
    n, res = proto["n_images"], proto["res"]
    dataset = runner.build_dataset()
    gt01 = torch.from_numpy(np.stack([dataset[i][0] for i in range(n)])).to(dev)
    xt = np.random.RandomState(proto["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1))).to(dev)
    op = runner.build_operator()
    op.force = force
    set_op_force(model, force)
    zero = lambda gens, shape: torch.zeros(shape, device=dev)
    t0 = time.perf_counter()
    y = op.A(_nhwc_to_vec(gt01 * 2.0 - 1.0))
    x, _ = sample_svd(runner.model_fn(model), xt, y, op, runner.sched, [None] * n,
                      eta=proto["eta"], sigma_y=proto["sigma_y"], noise_fn=zero)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    set_op_force(model, None)
    mse = ((torch.clamp((x + 1) / 2, 0, 1) - gt01) ** 2).reshape(n, -1).mean(dim=1)
    return [float(10 * torch.log10(1 / m)) for m in mse], x, secs


def main_runner_parity(n_gn: int, n_attn: int) -> dict:
    """Phase 11: the six ImageNet rows on the toy32 ADM under the golden's
    protocol, through the kernels and through the plain versions, every
    image within MAIN_PSNR_TOL of the JAX package's PSNR, kernel against
    plain within 1e-3, launch counts exact."""
    golden = json.loads(TOY_ADM_MAIN_GOLDEN.read_text())
    proto = golden["protocol"]
    model, out = None, {}
    for task in proto["tasks"]:
        name, deg = task[0], task[1]
        runner = main_golden_runner(proto, task, "cuda")
        model = model if model is not None else runner.build_model()
        steps = int((~runner.sched.is_travel).sum())
        want_psnr = golden["tasks"][name]["per_image_psnr"]
        finals = {}
        for route, force in (("kernel", None), ("plain", "torch")):
            ops.reset_launch_counts()
            psnrs, finals[route], secs = main_golden_run(model, runner, proto, force)
            counts = ops.launch_counts()
            print(f"{name:23s} fp32 {route:6s}: PSNR {['%.4f' % v for v in psnrs]} (JAX "
                  f"{['%.4f' % v for v in want_psnr]}) {secs:.2f} s launches {counts}",
                  flush=True)
            if not all(abs(a - b) <= MAIN_PSNR_TOL for a, b in zip(psnrs, want_psnr)):
                raise AssertionError(f"{name} {route}: PSNR {psnrs} vs JAX {want_psnr}")
            want = (expected_launches(n_gn * steps, n_attn * steps,
                                      fwht=fwht_launches(deg, 0.0, steps))
                    if force is None else dict.fromkeys(counts, 0))
            if counts != want:
                raise AssertionError(f"{name} {route}: launch counts {counts} != {want}")
            out[f"{name}/{route}"] = {"psnr": psnrs, "seconds": secs}
        diff = float((finals["kernel"] - finals["plain"]).abs().max())
        out[f"{name}/kernel_vs_plain_max_abs"] = diff
        print(f"{name}: kernel vs plain final images max abs {diff:.3e}", flush=True)
        if not diff <= 1e-3:
            raise AssertionError(f"{name}: kernel vs plain trajectories differ by {diff:.3e}")
    return out


def imagenet_adm():
    """The full-width ADM UNet of configs/imagenet_256.yml on the card, bf16
    torso, random weights from seed 1234 (as the Runner under --random_init)."""
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.models import ADMUNet, cast_torso
    from ddnm_tpu_torch.models.unet_adm import init_like_flax

    with torch.device("cuda"):
        model = ADMUNet.from_config(load_config(IMAGENET_CONFIG))
    return cast_torso(init_like_flax(model, 1234).eval(), torch.bfloat16)


def sweep_row(name: str, argv: list[str], out_dir: Path) -> tuple[dict, dict]:
    """One row of evaluation_torch's table, alone, with the launch counts set
    to 0 just before it and read just after; returns (stats, launches)."""
    import evaluation_torch

    ops.reset_launch_counts()
    report = evaluation_torch.main(["--tasks", name, "--exp", str(REPO / "exp"),
                                    "-i", str(out_dir), "--dtype", "bfloat16",
                                    "--device", "cuda", *argv])
    launches = ops.launch_counts()
    if list(report) != [name]:
        raise AssertionError(f"sweep row {name}: the report holds {list(report)}")
    return report[name], launches


def imagenet_rows(n_gn: int, n_attn: int, n_gn_ddpm: int, n_attn_ddpm: int,
                  ) -> tuple[dict, dict]:
    """Phase 12: the six ImageNet rows of evaluation_torch on the 552.8M ADM
    (bf16, random weights, batch 8, 100 steps), then its two noisy CelebA
    rows on flag_ddpm256.pt at 25 steps. Checks 8 restored images and a
    finite PSNR per row, launch counts exactly, and max |A(x) - y| of the
    sampler's output <= RANGE_SPACE_TOL on the SR and inpainting rows.
    Returns ({row: stats}, the six ImageNet rows' launches summed)."""
    import evaluation_torch

    rows, summed = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for name, _, deg, _, sigma_y, _, _ in (evaluation_torch.IMAGENET_RUNS
                                               + evaluation_torch.CELEBA_RUNS[-2:]):
            imagenet = name.startswith("imagenet")
            steps = 100 if imagenet else 25
            argv = (["--datasets", "imagenet", "--random-init"] if imagenet else
                    ["--datasets", "celeba", "--ckpt-celeba", str(FLAG_PT),
                     "--t-sampling", str(steps)])
            stats, launches = sweep_row(name, argv, Path(tmp) / "eval")
            gn, attn = (n_gn, n_attn) if imagenet else (n_gn_ddpm, n_attn_ddpm)
            # the runner's A+y preview and its range-space check (one each)
            # on top of sample_svd's
            fwht = 2 + fwht_launches(deg, 2 * sigma_y, steps) if deg == "cs_walshhadamard" else 0
            want = expected_launches(gn * steps, attn * steps, fwht=fwht)
            per_step = {k: v / steps for k, v in launches.items()}
            stats = dict(stats, launches=launches, launches_per_step=per_step,
                         sampler_images_per_second=stats["num_samples"] / stats["sample_seconds"])
            rows[name] = stats
            print(f"{name:23s}: {stats['num_samples']} images, PSNR {stats['avg_psnr']:.4f}, "
                  f"{stats['sampler_images_per_second']:.4f} images/s in the sampler "
                  f"({stats['sample_seconds']:.2f} s), {stats['images_per_second']:.4f} "
                  f"end to end ({stats['wall_seconds']:.2f} s); max |A(x) - y| "
                  f"{stats['range_space_max_abs']:.3e}; launches per step {per_step}",
                  flush=True)
            if stats["num_samples"] != 8 or not np.isfinite(stats["avg_psnr"]):
                raise AssertionError(f"{name}: {stats['num_samples']} images, PSNR "
                                     f"{stats['avg_psnr']}")
            if launches != want:
                raise AssertionError(f"{name}: launch counts {launches} != {want}")
            if deg in ("sr_averagepooling", "inpainting") and imagenet and not (
                    stats["range_space_max_abs"] <= RANGE_SPACE_TOL):
                raise AssertionError(f"{name}: max |A(x) - y| {stats['range_space_max_abs']}")
            if imagenet:
                summed = launches if summed is None else {k: summed[k] + v
                                                          for k, v in launches.items()}
    return rows, summed


# ------------------------------------------- phase 3 (backward), 13 and 14

TOY_CLF_PT = REPO / "tests" / "fixtures" / "toy_clf32.pt"
TOY_CLF_JSON = REPO / "tests" / "fixtures" / "toy_clf32.json"
GUIDED_GOLDEN = REPO / "tests" / "fixtures" / "toy_adm32_guided_golden.json"
IMAGENET_CC_CONFIG = REPO / "configs" / "imagenet_256_cc.yml"
# ROADMAP's "bf16 hq runs" watch item: the port's bf16 hq runs land up to
# 0.26 dB from JAX's bf16 (it folds FiLM into the norm and rounds once)
BF16_HQ_WATCH_DB = 0.26


def grad_shapes(model, x_nhwc, *args) -> dict:
    """{("gn", shape, swish, film) | ("attn", shape): calls} of one
    `forward_ops` forward: what its backward gives the backward kernels."""
    seen: dict = {}
    for op in forward_ops(model, x_nhwc, *args):
        key = op[:2] + op[3:]  # without the dtype
        seen[key] = seen.get(key, 0) + 1
    return seen


def check_backward(kind: str, shape: tuple, dtype: torch.dtype, gen: torch.Generator,
                   swish: bool = False, film: bool = False) -> dict:
    """A backward kernel (gn_bwd_reduce, gn_bwd_dx, attn_bwd_dq,
    attn_bwd_dkdv) or a pair (gn_bwd: reduce then dx; attn_bwd: dq then
    dkdv) against its plain version at one shape, with the forward's
    saved tensors made by the forward kernels; a pair also against
    autograd through the plain forward and timed beside the library's
    autograd backward (F.group_norm, without FiLM or SiLU; SDPA), with the
    graph built once and only the backward timed. gn_bwd_reduce must give
    the same bits on a second call. Returns a result dict as check_kernel's."""
    dev = "cuda"
    library = autograd_ref = None
    elem = torch.empty((), dtype=dtype).element_size()
    if kind.startswith("gn"):
        B, H, W, C = shape
        n = math.prod(shape)
        x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.5).to(dtype)
        dy = torch.randn(shape, device=dev, generator=gen).to(dtype)
        g, b = (torch.randn(C, device=dev, generator=gen) for _ in range(2))
        fs = ft = None
        if film:
            fs, ft = (torch.randn(B, C, device=dev, generator=gen) * 0.3 for _ in range(2))
        a_, b_ = _stats_affine(x, g, b, 32, 1e-5, fs, ft)  # as the Function saves them
        peak = PEAK_FLOPS[torch.float32]
        silu = 12 if swish else 0
        if kind == "gn_bwd_reduce":
            kern = lambda: _bwd_reduce(x, dy, g, 32, 1e-5, swish, a_, b_, fs)
            plain = lambda: _torch_bwd_reduce(x, dy, g, 32, 1e-5, swish, a_, b_, fs)
            if not torch.equal(kern(), kern()):
                raise AssertionError(f"gn_bwd_reduce {shape} {dtype}: two calls differ")
            nbytes, flops = 2 * n * elem + 3 * B * C * 4, (6 + silu) * n
        elif kind == "gn_bwd_dx":
            coef = _torch_bwd_reduce(x, dy, g, 32, 1e-5, swish, a_, b_, fs)
            kern = lambda: _bwd_dx(x, dy, coef, swish, a_, b_)
            plain = lambda: _torch_bwd_dx(x, dy, coef, swish, a_, b_)
            nbytes, flops = 3 * n * elem + 3 * B * C * 4, (4 + silu) * n
        else:
            kern = lambda: _bwd_dx(x, dy, _bwd_reduce(x, dy, g, 32, 1e-5, swish, a_, b_, fs),
                                   swish, a_, b_)
            plain = lambda: _torch_group_norm_backward(x, dy, g, b, 32, 1e-5, swish, fs, ft)
            xr = x.clone().requires_grad_(True)
            autograd_ref = torch.autograd.grad(
                _torch_group_norm(xr, g, b, 32, 1e-5, swish, fs, ft), xr, dy)[0]
            xl = x.permute(0, 3, 1, 2).detach().requires_grad_(True)  # channels_last bytes
            yl = F.group_norm(xl, 32, g.to(dtype), b.to(dtype), 1e-5)
            dyl = dy.permute(0, 3, 1, 2)
            library = lambda: torch.autograd.grad(yl, xl, dyl, retain_graph=True)
            nbytes, flops = 3 * n * elem, (10 + 2 * silu) * n
    else:
        B, T, C = shape
        q, k, v, do = (torch.randn(shape, device=dev, generator=gen).to(dtype) for _ in range(4))
        scale = C ** -0.25  # the ADM heads' q and k scale, here on the product
        o = _kernel_attention(q, k, v, scale)
        peak = PEAK_FLOPS[dtype]
        rows = 2 * B * T * 4  # LSE and D
        if kind == "attn_bwd_dq":
            kern = lambda: _attn_bwd_dq(q, k, v, o, do, scale)
            plain = lambda: _torch_attn_bwd_dq(q, k, v, o, do, scale)
            nbytes, flops = 6 * q.numel() * elem + rows, 6 * B * T * T * C
        elif kind == "attn_bwd_dkdv":
            _, lse, dsum = _torch_attn_bwd_dq(q, k, v, o, do, scale)
            kern = lambda: _attn_bwd_dkdv(q, k, v, do, lse, dsum, scale)
            plain = lambda: _torch_attn_bwd_dkdv(q, k, v, do, lse, dsum, scale)
            nbytes, flops = 6 * q.numel() * elem + rows, 8 * B * T * T * C
        else:
            def kern():
                dq, lse, dsum = _attn_bwd_dq(q, k, v, o, do, scale)
                return (dq, *_attn_bwd_dkdv(q, k, v, do, lse, dsum, scale))

            plain = lambda: _torch_attention_backward(q, k, v, o, do, scale)
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            autograd_ref = torch.autograd.grad(_torch_attention(*ins, scale), ins, do)
            lin = [t[:, None].detach().requires_grad_(True) for t in (q, k, v)]
            lout = F.scaled_dot_product_attention(*lin, scale=scale)
            library = lambda: torch.autograd.grad(lout, lin, do[:, None], retain_graph=True)
            nbytes, flops = 8 * q.numel() * elem, 10 * B * T * T * C
    as_list = lambda out: list(out) if isinstance(out, (tuple, list)) else [out]
    refs = [t.float() for t in as_list(plain())]
    got = as_list(kern())
    err = max(float((k.float() - r).abs().max()) for k, r in zip(got, refs))
    torch.cuda.synchronize()
    tol = TOL[(kind, dtype)] * max(1.0, max(float(r.abs().max()) for r in refs))
    if not err <= tol:
        raise AssertionError(f"{kind} {shape} {dtype} swish={swish} film={film}: kernel vs "
                             f"plain max abs {err:.3e} > {tol:.3e}")
    out = {"kind": kind, "shape": shape, "dtype": str(dtype).replace("torch.", ""),
           "swish": swish, "film": film, "max_abs_err": err, "tol": tol}
    if autograd_ref is not None:
        ref = [t.float() for t in as_list(autograd_ref)]
        a_err = max(float((k.float() - r).abs().max()) for k, r in zip(got, ref))
        a_tol = TOL[(kind, dtype)] * max(1.0, max(float(r.abs().max()) for r in ref))
        if not a_err <= a_tol:
            raise AssertionError(f"{kind} {shape} {dtype} swish={swish} film={film}: kernels "
                                 f"vs autograd through the plain forward {a_err:.3e} > "
                                 f"{a_tol:.3e}")
        out.update(autograd_err=a_err, autograd_tol=a_tol)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    out.update(ms=cuda_ms(kern, iters=10), device_ms=device_ms(kern, iters=10),
               plain_ms=cuda_ms(plain, iters=5, warmup=1),
               library_ms=cuda_ms(library, iters=10) if library else None,
               library_device_ms=device_ms(library, iters=10) if library else None,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return out


def toy_classifier(device, dtype=torch.float32):
    """The trained toy32 classifier of tests/fixtures/toy_clf32.pt."""
    from ddnm_tpu_torch.models import ADMClassifier, cast_torso
    from ddnm_tpu_torch.runner import load_checkpoint

    clf = ADMClassifier(**json.loads(TOY_CLF_JSON.read_text())["clf_kw"])
    load_checkpoint(clf, TOY_CLF_PT)
    clf = clf.to(device).eval()
    return cast_torso(clf, dtype) if dtype != torch.float32 else clf


def cc_classifier(device="cuda", dtype=torch.bfloat16):
    """The 54,096,360-parameter classifier of configs/imagenet_256_cc.yml
    (and configs/hq/inet256.yml) in `dtype`, random weights from seed 1234
    drawn as init_like_flax draws them, the zero-initialised layers (each
    ResBlock's out conv, each attention's proj_out) drawn too: with those
    zero, as --random_init builds it, only the out norm's and the pool's
    backward would get a non-zero gradient."""
    from ddnm_tpu_torch.config import load_config
    from ddnm_tpu_torch.models import ADMClassifier, cast_torso
    from ddnm_tpu_torch.models.unet_adm import init_like_flax

    with torch.device(device):
        clf = ADMClassifier.from_config(load_config(IMAGENET_CC_CONFIG).classifier, 256)
    clf.zero_init = ()
    return cast_torso(init_like_flax(clf, 1234).eval(), dtype)


def decode_f32(d: dict) -> np.ndarray:
    """A float32 array of the guided golden (shape and little-endian bytes
    in base64; tools/emit_toy_adm32_guided_golden.py `encode`)."""
    import base64

    return np.frombuffer(base64.b64decode(d["f32_b64"]), dtype="<f4").reshape(d["shape"])


def guided_golden_run(model, classifier, device, tier: str = "toy32"):
    """The guided hq golden protocol (tests/fixtures/toy_adm32_guided_golden.json)
    through the port's sample_posterior with `classifier_guidance_fn`:
    the golden's ground truth, x_T from RandomState(11), zero noise, 4x
    average-pooling SR, respacing 25 with the jump schedule, class 2, scale
    2.0. Returns (batch PSNR, final images, per-image max |final - JAX
    output|, seconds)."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.models import classifier_guidance_fn
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, sample_posterior

    golden = json.loads(GUIDED_GOLDEN.read_text())
    proto, t = golden["protocol"], golden["tiers"][tier]
    n, res = proto["n_images"], t["res"]
    gt = torch.from_numpy(decode_f32(t["gt"]).copy()).to(device)
    xt = np.random.RandomState(proto["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1))).to(device)
    op = build_functional_operator(proto["deg"], image_size=res,
                                   deg_scale=float(proto["scale"]), device=device)
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=proto["timestep_respacing"],
        schedule_jump_params=proto["schedule_jump_params"])
    guidance = classifier_guidance_fn(classifier, proto["guided_class"],
                                      proto["classifier_scale"])
    zero = lambda gens, shape: torch.zeros(shape, device=device)
    t0 = time.perf_counter()
    x, _ = sample_posterior(lambda z, s: model(z, s), xt, op.Ap(op.A(gt)), op, tables,
                            [None] * n, noise_fn=zero, guidance_fn=guidance)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    to01 = lambda a: torch.clamp((a + 1) / 2, 0, 1)
    mse = float(((to01(x) - to01(gt)) ** 2).mean())
    jax_x = decode_f32(t["jax_output"])
    per_image = [float(np.abs(x[i].cpu().numpy() - jax_x[i]).max()) for i in range(n)]
    return 10.0 * math.log10(1.0 / max(mse, 1e-12)), x, per_image, secs


def module_counts(model) -> tuple[int, int]:
    """(GroupNorms, attentions) of a model: each one launch of its kernels
    a forward, and of its backward kernels a backward."""
    from ddnm_tpu_torch.models.nn import GroupNormF32
    from ddnm_tpu_torch.models.unet_adm import AttentionBlock, AttentionPool2d
    from ddnm_tpu_torch.models.unet_ddpm import AttnBlock

    return (sum(isinstance(m, GroupNormF32) for m in model.modules()),
            sum(isinstance(m, (AttentionBlock, AttentionPool2d, AttnBlock))
                for m in model.modules()))


def guided_parity() -> dict:
    """Phase 13: the toy32 guided golden (toy_adm32.pt guided by
    toy_clf32.pt) in fp32 through the kernels, within HQ_PSNR_TOL of
    the JAX package's PSNR, per-image max |delta| against the JAX output,
    launch counts exact (the classifier's forward and backward kernels
    once per GroupNorm / attention a model call); the same through the
    plain versions (no launches), kernel against plain; the guidance
    gradient through the kernels against the same classifier with
    force="torch"; then bf16, reported beside JAX's bf16 PSNR."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.models import classifier_guidance_fn
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, n_model_calls

    golden = json.loads(GUIDED_GOLDEN.read_text())
    want = golden["tiers"]["toy32"]["recorded_psnr"]
    want_bf16 = json.loads(TOY_ADM_PSNR_BF16.read_text())["hq_guided_sr"]["ours_psnr"]
    proto = golden["protocol"]
    calls = n_model_calls(build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=proto["timestep_respacing"],
        schedule_jump_params=proto["schedule_jump_params"]))
    model, clf = toy_adm("cuda"), toy_classifier("cuda")
    (n_gn, n_attn), (n_gn_c, n_attn_c) = module_counts(model), module_counts(clf)
    out = {}
    finals = {}
    for route, force in (("kernel", None), ("plain", "torch")):
        set_op_force(model, force)
        set_op_force(clf, force)
        ops.reset_launch_counts()
        psnr, finals[route], per_image, secs = guided_golden_run(model, clf, "cuda")
        counts = ops.launch_counts()
        print(f"guided toy32 fp32 {route:6s}: PSNR {psnr:.4f} (JAX {want:.4f}, difference "
              f"{psnr - want:+.4f} dB); per-image max |x - JAX| "
              f"{['%.2e' % e for e in per_image]}; {secs:.2f} s ({calls} model calls); "
              f"launches {counts}", flush=True)
        if not abs(psnr - want) <= HQ_PSNR_TOL:
            raise AssertionError(f"guided toy32 {route}: PSNR {psnr:.4f} vs JAX {want:.4f}")
        expect = (expected_launches((n_gn + n_gn_c) * calls, (n_attn + n_attn_c) * calls,
                                    n_gn_c * calls, n_attn_c * calls)
                  if force is None else dict.fromkeys(counts, 0))
        if counts != expect:
            raise AssertionError(f"guided toy32 {route}: launch counts {counts} != {expect}")
        out[route] = {"psnr": psnr, "per_image_max_abs_vs_jax": per_image, "seconds": secs,
                      "launches": counts}
    set_op_force(model, None)
    out["kernel_vs_plain_max_abs"] = float((finals["kernel"] - finals["plain"]).abs().max())
    print(f"guided toy32: kernel vs plain final images max abs "
          f"{out['kernel_vs_plain_max_abs']:.3e}", flush=True)
    if not out["kernel_vs_plain_max_abs"] <= 1e-3:
        raise AssertionError(f"guided toy32: kernel vs plain {out['kernel_vs_plain_max_abs']}")
    # one guidance gradient, through the kernels and with force="torch"
    x = torch.randn(2, 32, 32, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    tb = torch.tensor([120.0, 640.0], device="cuda")
    grads = {}
    for force in (None, "torch"):
        set_op_force(clf, force)
        grads[force] = classifier_guidance_fn(clf, 2, 2.0)(x, tb)
    set_op_force(clf, None)
    rel = float((grads[None] - grads["torch"]).abs().max() / grads["torch"].abs().max())
    out["guidance_kernel_vs_plain_rel"] = rel
    print(f"guided toy32: guidance gradient through the kernels vs force='torch': max "
          f"relative {rel:.2e} (norm {float(grads[None].norm()):.4f})", flush=True)
    if not (rel <= 1e-4 and torch.isfinite(grads[None]).all() and grads[None].abs().max() > 0):
        raise AssertionError(f"guided toy32: guidance gradient kernel vs plain {rel}")
    bf16, clf16 = toy_adm("cuda", torch.bfloat16), toy_classifier("cuda", torch.bfloat16)
    psnr, _, per_image, secs = guided_golden_run(bf16, clf16, "cuda")
    out["bf16_psnr"] = psnr
    print(f"guided toy32 bf16 kernels: PSNR {psnr:.4f} (JAX bf16 {want_bf16:.4f}, difference "
          f"{psnr - want_bf16:+.4f} dB; ROADMAP's bf16 hq watch: up to {BF16_HQ_WATCH_DB} dB; "
          f"not gated) {secs:.2f} s", flush=True)
    return out


# the 256 px guidance gradient through the kernels against the plain
# versions in fp32 (TF32 off), relative to max |plain|: the sums of the
# four backward kernels and of the forward stats run in other orders, then
# pass back through 46 norms and 8 attentions; 3.7e-6 to 4.2e-6 at batch 1
# and 3.1e-6 to 3.4e-6 at batch 8 measured in three calls (guidance_call,
# NVIDIA H100 80GB HBM3, 700 W)
GUIDANCE_FP32_TOL = 1e-5
# the bf16 gradient through the kernels may stand at most this many times
# as far from the fp32 plain gradient as the bf16 plain one does (the bf16
# rounding of both routes dominates: 0.0307 against 0.0284 at batch 1,
# 0.0297 against 0.0297 at batch 8, in every call)
GUIDANCE_BF16_FACTOR = 1.5


def backward_dy_census(fn) -> dict:
    """Run `fn` with GroupNormFunction's and AttentionFunction's backward
    wrapped: {"groupnorm" | "attention": [backward calls whose incoming
    gradient has a non-zero element, backward calls]}."""
    from ddnm_tpu_torch.ops.attention import AttentionFunction
    from ddnm_tpu_torch.ops.groupnorm import GroupNormFunction

    census = {"groupnorm": [0, 0], "attention": [0, 0]}
    real = {}
    for name, cls in (("groupnorm", GroupNormFunction), ("attention", AttentionFunction)):
        real[name] = cls.backward

        def backward(ctx, dy, _name=name, _real=cls.backward):
            census[_name][0] += bool((dy != 0).any())
            census[_name][1] += 1
            return _real(ctx, dy)

        cls.backward = staticmethod(backward)
    try:
        fn()
    finally:
        GroupNormFunction.backward = staticmethod(real["groupnorm"])
        AttentionFunction.backward = staticmethod(real["attention"])
    return census


def guidance_call(clf, clf32, batch: int) -> dict:
    """One guidance call of the 256 px classifier at `batch` (bf16,
    `cc_classifier`'s random weights): ms per call back to back (forward
    and backward of the classifier), launches per call against the module
    counts, the gradient's norm (finite, non-zero). Its gradient is held against the
    same weights in fp32 with force="torch": through the kernels in fp32
    within GUIDANCE_FP32_TOL, and in bf16 within GUIDANCE_BF16_FACTOR times
    the bf16 plain route's own distance; every backward call of the fp32
    run gets a non-zero incoming gradient."""
    from ddnm_tpu_torch.models import classifier_guidance_fn
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force

    g = torch.Generator("cuda").manual_seed(batch)
    x = torch.randn(batch, 256, 256, 3, device="cuda", generator=g)
    t = torch.full((batch,), 500.0, device="cuda")
    guide = classifier_guidance_fn(clf, 951, 1.0)
    ops.reset_launch_counts()
    grad = guide(x, t)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n_gn, n_attn = module_counts(clf)
    if counts != expected_launches(n_gn, n_attn, n_gn, n_attn):
        raise AssertionError(f"guidance at batch {batch}: launches {counts}")
    norm = float(grad.norm())
    if not (math.isfinite(norm) and norm > 0 and grad.dtype == torch.float32):
        raise AssertionError(f"guidance at batch {batch}: norm {norm}, dtype {grad.dtype}")
    ms = cuda_ms(lambda: guide(x, t), iters=5, warmup=1)
    grads = {"bf16 kernels": grad}
    set_op_force(clf, "torch")
    grads["bf16 plain"] = guide(x, t)
    set_op_force(clf, None)
    guide32 = classifier_guidance_fn(clf32, 951, 1.0)
    census = backward_dy_census(lambda: grads.__setitem__("fp32 kernels", guide32(x, t)))
    set_op_force(clf32, "torch")
    ref = guide32(x, t)
    set_op_force(clf32, None)
    scale = float(ref.abs().max())
    err = {k: float((v - ref).abs().max()) / scale for k, v in grads.items()}
    err["bf16 kernels vs bf16 plain"] = (float((grad - grads["bf16 plain"]).abs().max())
                                         / float(grads["bf16 plain"].abs().max()))
    if census != {"groupnorm": [n_gn, n_gn], "attention": [n_attn, n_attn]}:
        raise AssertionError(f"guidance at batch {batch}: non-zero dy in {census}")
    if not err["fp32 kernels"] <= GUIDANCE_FP32_TOL:
        raise AssertionError(f"guidance at batch {batch}: fp32 kernels vs plain {err}")
    if not err["bf16 kernels"] <= GUIDANCE_BF16_FACTOR * err["bf16 plain"]:
        raise AssertionError(f"guidance at batch {batch}: bf16 kernels vs fp32 plain {err}")
    return {"ms": ms, "launches": counts, "grad_norm": norm, "relative_to_fp32_plain": err,
            "nonzero_dy": census}


def guided_full_width(n_gn_hq: int, n_attn_hq: int, n_gn_inet: int, n_attn_inet: int
                      ) -> tuple[dict, dict, dict]:
    """Phase 14: the guided configurations at full width, bf16, random
    weights from seed 1234: one 256 px tile of configs/hq/inet256.yml
    (classifier_scale 1.0, the 553.8M ADM and the 54,096,360-parameter
    classifier) through hq_main_torch, 280 model calls, 4x SR of a 64 x 64
    PNG with --resize_y; and the configs/imagenet_256_cc.yml row through
    main_torch (SVD sr_averagepooling 4x, batch 8, 100 steps,
    --random_init): s per tile, images/s, launches per model call of every
    forward and backward kernel against the module counts, max |A(x) - y|,
    and per guidance call (the classifier's forward and backward) at
    batch 1 and 8 its ms, launches and gradient norm. Returns (stats,
    hq launches, cc launches)."""
    import hq_main_torch
    import main_torch
    from ddnm_tpu_torch.data.io import load_image, save_image

    clf, clf32 = (cc_classifier(dtype=d) for d in (torch.bfloat16, torch.float32))
    n_gn_c, n_attn_c = module_counts(clf)
    calls_of = {b: guidance_call(clf, clf32, b) for b in (1, 8)}
    del clf, clf32
    torch.cuda.empty_cache()
    for b, r in calls_of.items():
        rel = ", ".join(f"{k} {v:.3e}" for k, v in r["relative_to_fp32_plain"].items())
        print(f"guidance call (256 px classifier, bf16, batch {b}): {r['ms']:.2f} ms, "
              f"gradient norm {r['grad_norm']:.4e}; max |grad - fp32 plain| / max |fp32 "
              f"plain|: {rel} (fp32 tol {GUIDANCE_FP32_TOL:.0e}, bf16 kernels within "
              f"{GUIDANCE_BF16_FACTOR}x bf16 plain); backward calls with non-zero dy "
              f"{r['nonzero_dy']}; launches {r['launches']}", flush=True)
    img = load_image(REPO / "exp" / "datasets" / "imagenet" / "00000.png")
    small = img[:256, :256].reshape(64, 4, 64, 4, 3).mean(axis=(1, 3))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_image(small, tmp / "y64.png")
        ops.reset_launch_counts()
        out = hq_main_torch.main([
            "--config", str(INET256), "--path_y", str(tmp / "y64.png"),
            "--deg", "sr_averagepooling", "--scale", "4", "--resize_y", "--class", "951",
            "--random_init", "--seed", "1234", "--dtype", "bfloat16", "-i", str(tmp / "hq")])
        launches_hq = ops.launch_counts()
        ops.reset_launch_counts()
        cc = main_torch.main([
            "--config", str(IMAGENET_CC_CONFIG), "--random_init", "--exp", str(REPO / "exp"),
            "--path_y", "imagenet", "--deg", "sr_averagepooling", "--deg_scale", "4",
            "--sigma_y", "0", "--dtype", "bfloat16", "--batch_size", "8",
            "-i", str(tmp / "cc"), "--ni", "--verbose", "warning"])
        launches_cc = ops.launch_counts()
        n_png = len(list((tmp / "cc").glob("*_0.png")))
    hq = dict(out["stats"])
    hq["range_space_max_abs"] = float(np.abs(
        out["final"].reshape(1, 64, 4, 64, 4, 3).mean(axis=(2, 4)) - out["y"]).max())
    calls, steps = hq["model_calls"], 100
    hq_want = expected_launches((n_gn_hq + n_gn_c) * calls, (n_attn_hq + n_attn_c) * calls,
                                n_gn_c * calls, n_attn_c * calls)
    cc_want = expected_launches((n_gn_inet + n_gn_c) * steps, (n_attn_inet + n_attn_c) * steps,
                                n_gn_c * steps, n_attn_c * steps)
    hq["launches_per_call"] = {k: v / calls for k, v in launches_hq.items()}
    cc = dict(cc, launches_per_step={k: v / steps for k, v in launches_cc.items()},
              sampler_images_per_second=cc["num_samples"] / cc["sample_seconds"])
    print(f"guided hq tile (inet256 ADM + classifier, bf16, 256 x 256): "
          f"{hq['seconds_per_tile']:.2f} s per tile, {1 / hq['wall_seconds']:.4f} images/s, "
          f"{hq['model_calls_per_second']:.2f} model calls/s ({calls} calls); launches per "
          f"call {hq['launches_per_call']}; max |A(final) - y| "
          f"{hq['range_space_max_abs']:.3e}", flush=True)
    print(f"guided ImageNet-cc row (imagenet_256_cc, bf16, batch 8, 100 steps): "
          f"{cc['num_samples']} images, {cc['sampler_images_per_second']:.4f} images/s in the "
          f"sampler ({cc['sample_seconds']:.2f} s), {cc['images_per_second']:.4f} end to end; "
          f"max |A(x) - y| {cc['range_space_max_abs']:.3e}; launches per step "
          f"{cc['launches_per_step']}", flush=True)
    if (out["final"].shape != (1, 256, 256, 3) or not np.isfinite(out["final"]).all()
            or hq["tiles"] != 1 or calls != 280):
        raise AssertionError(f"guided hq: shape {out['final'].shape}, {hq['tiles']} tiles, "
                             f"{calls} calls")
    if launches_hq != hq_want:
        raise AssertionError(f"guided hq launch counts {launches_hq} != {hq_want}")
    if cc["num_samples"] != 8 or n_png != 8 or not np.isfinite(cc["avg_psnr"]):
        raise AssertionError(f"guided cc: {cc['num_samples']} images ({n_png} PNGs), "
                             f"PSNR {cc['avg_psnr']}")
    if launches_cc != cc_want:
        raise AssertionError(f"guided cc launch counts {launches_cc} != {cc_want}")
    for name, r in (("hq", hq), ("cc", cc)):
        if not r["range_space_max_abs"] <= RANGE_SPACE_TOL:
            raise AssertionError(f"guided {name}: max |A(x) - y| {r['range_space_max_abs']}")
    return ({"hq": hq, "cc": cc, "guidance_call": calls_of,
             "classifier_modules": {"groupnorm": n_gn_c, "attention": n_attn_c}},
            launches_hq, launches_cc)


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
    want = expected_launches(n_gn * steps, n_attn * steps, fwht=want_fwht)
    if launches != want:
        raise AssertionError(f"main-path launch counts {launches} != {want}")
    return stats, launches


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False; "
                           "chip_smoke.py runs only on a card")
    from ddnm_tpu_torch.models import DDPMUNet, cast_torso
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
        for line in ptxas_summary(_build.ptxas_report("fgc_conv_kernel", "gn_apply_kernel",
                                                      "fwht_kernel")):
            print(line, flush=True)

    with phase(3, "kernels against plain versions"):
        model = DDPMUNet(resolution=256)
        load_checkpoint(model, FLAG_PT)
        model = model.cuda().eval()
        n_gn, n_attn = module_counts(model)
        shapes = op_shapes(model, torch.zeros(2, 256, 256, 3, device="cuda"))
        bf16 = cast_torso(DDPMUNet(resolution=256), torch.bfloat16)
        bf16.load_state_dict(model.state_dict())
        bf16 = bf16.cuda().eval()
        main_shapes = op_shapes(bf16, torch.zeros(8, 256, 256, 3, device="cuda"))
        del bf16
        # the hq path's forward: the inet256 ADM UNet, bf16, one 256 px tile
        adm = hq_adm()
        n_gn_hq, n_attn_hq = module_counts(adm)
        hq_shapes = op_shapes(adm, torch.zeros(1, 256, 256, 3, device="cuda"),
                              torch.zeros(1, dtype=torch.long, device="cuda"))
        del adm
        # the ImageNet rows' forward: configs/imagenet_256.yml, bf16, batch 8
        adm = imagenet_adm()
        n_gn_inet, n_attn_inet = module_counts(adm)
        inet_shapes = op_shapes(adm, torch.zeros(8, 256, 256, 3, device="cuda"))
        del adm
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(0)
        # each GroupNorm shape checks both kernels and, as a yardstick against
        # F.group_norm, the pair; the apply kernel also with its SiLU epilogue
        # and the stats kernel also with FiLM where the forward calls them so
        kinds = {"groupnorm": ("groupnorm_stats", "groupnorm_apply", "groupnorm"),
                 "groupnorm_swish": ("groupnorm_apply",),
                 "groupnorm_film": ("groupnorm_stats",),
                 "attention": ("attention",)}
        results = {}
        for op, shape, dtype in sorted(set(shapes) | set(main_shapes) | set(hq_shapes)
                                       | set(inet_shapes), key=str):
            for kind in kinds[op]:
                r = check_kernel(kind, shape, dtype, gen, swish=op == "groupnorm_swish",
                                 film=op == "groupnorm_film")
                results[(op, kind, shape, dtype)] = r
                lib = ("-" if r["library_ms"] is None else
                       f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f})")
                tag = {"groupnorm_swish": " +silu", "groupnorm_film": " +film"}.get(op, "")
                print(f"{kind + tag:21s} {str(shape):22s} "
                      f"{r['dtype']:8s} err {r['max_abs_err']:.2e} (tol {r['tol']:.1e}) "
                      f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
                      f"plain {r['plain_ms']:.4f} ms  library {lib}  "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

        def forward_rows(kind, table):
            """(result, calls per forward) of one forward's shape table: the
            apply kernel's calls split by their SiLU epilogue, the stats
            kernel's by their FiLM."""
            if kind == "attention":
                return [(results[(o, kind, s, d)], c) for (o, s, d), c in table.items()
                        if o == "attention"]
            special = {"groupnorm_apply": "groupnorm_swish",
                       "groupnorm_stats": "groupnorm_film"}.get(kind)
            rows = []
            for (o, s, d), c in table.items():
                if o != "groupnorm":
                    continue
                n_sp = table.get((special, s, d), 0)
                rows += [(results[("groupnorm", kind, s, d)], c - n_sp)] if c > n_sp else []
                rows += [(results[(special, kind, s, d)], n_sp)] if n_sp else []
            return rows

        def per_call_sum(rows):
            out = {f: (None if rows[0][0][f] is None else sum(r[f] * c for r, c in rows))
                   for f in ("ms", "device_ms", "plain_ms", "library_ms",
                             "library_device_ms", "bound_ms")}
            out["calls"] = sum(c for _, c in rows)
            out["bound_by"] = rows[0][0]["bound_by"]
            return out

        # per UNet forward of the main path (bf16, batch 8), of the hq path
        # (the inet256 ADM, bf16, one tile) and of the ImageNet rows (the
        # imagenet_256 ADM, bf16, batch 8): each shape's time times its calls
        # per forward
        per_forward, hq_forward, inet_forward = {}, {}, {}
        for kind in ("groupnorm_stats", "groupnorm_apply", "groupnorm", "attention"):
            per_forward[kind] = per_call_sum(forward_rows(kind, main_shapes))
            per_forward[kind]["max_abs_err"] = max(
                r["max_abs_err"] for k, r in results.items() if k[1] == kind)
            print(f"{kind}: per bf16 batch-8 forward: " + json.dumps(per_forward[kind]),
                  flush=True)
            hq_forward[kind] = per_call_sum(forward_rows(kind, hq_shapes))
            print(f"{kind}: per hq ADM forward (bf16, one tile): "
                  + json.dumps(hq_forward[kind]), flush=True)
            inet_forward[kind] = per_call_sum(forward_rows(kind, inet_shapes))
            print(f"{kind}: per ImageNet ADM forward (bf16, batch 8): "
                  + json.dumps(inet_forward[kind]), flush=True)
        edge = [check_kernel("attention", shape, dtype, gen)
                for shape in EDGE_ATTENTION_SHAPES for dtype in (torch.bfloat16, torch.float32)]
        edge.append(check_kernel("groupnorm_stats", (8, 16, 16, 768), torch.float32, gen,
                                 film=True))
        # the apply kernel's 1-channel path: x off 16 bytes, C not a multiple
        # of the 16-byte width
        edge += [check_kernel("groupnorm_apply", shape, dtype, gen, swish=swish, **kw)
                 for shape, kw in (((2, 9, 9, 128), {"offset": 1}), ((2, 7, 5, 34), {"groups": 2}))
                 for dtype in (torch.float32, torch.bfloat16) for swish in (False, True)]
        for r in edge:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            tag = (" +silu" if r["swish"] else "") + (" off" if r["offset"] else "")
            print(f"edge {r['kind'] + tag:25s} {str(r['shape']):22s} {r['dtype']:8s} "
                  f"err {r['max_abs_err']:.2e} (tol {r['tol']:.1e}) "
                  f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
                  f"plain {r['plain_ms']:.4f} ms  library {lib} (device "
                  f"{r['library_device_ms'] if r['library_device_ms'] is None else round(r['library_device_ms'], 4)})  "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        for kind in per_forward:
            per_forward[kind]["max_abs_err"] = max(
                [per_forward[kind]["max_abs_err"]]
                + [r["max_abs_err"] for r in edge if r["kind"] == kind])
        fwht_rows = {shape: check_fwht(shape, gen) for shape in FWHT_SHAPES}
        for r in fwht_rows.values():
            print(f"{'fwht':15s} {str(r['shape']):22s} {r['dtype']:8s} "
                  f"err {r['max_abs_err']:.2e} (tol {r['tol']:.1e}) same bits twice and on a "
                  f"view, {r['cuda_launches_per_call']:g} CUDA launch a call  "
                  f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
                  f"{100 * r['device_share_of_bound']:.1f}% of the bound)  "
                  f"plain {r['plain_ms']:.4f} ms  library {r['library_ms']:.4f} ms (device "
                  f"{r['library_device_ms']:.4f})  bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']})", flush=True)
        # per call at the SVD main path's shape (batch 8)
        per_forward["fwht"] = {f: fwht_rows[FWHT_MAIN_SHAPE][f] for f in
                               ("ms", "device_ms", "plain_ms", "library_ms",
                                "library_device_ms", "bound_ms", "bound_by",
                                "device_share_of_bound", "cuda_launches_per_call")}
        per_forward["fwht"]["max_abs_err"] = max(r["max_abs_err"] for r in fwht_rows.values())
        print("fwht: per (8, 3, 65536) call: " + json.dumps(per_forward["fwht"]), flush=True)
        fused = {}
        for shape in FUSED_SHAPES:
            for mode in ("full", "conv", "act"):
                r = fused[(mode, shape)] = check_fused(mode, shape, gen)
                extra = "".join(f"  {k} {r[k + '_ms']:.4f} ms (device {r[k + '_device_ms']:.4f})"
                                for k in ("library", "chain") if r[k + "_ms"] is not None)
                print(f"{r['kind']:20s} {str(shape):22s} bfloat16 "
                      f"err {r['max_abs_err']:.2e} (tol {r['tol']:.1e}) same bits twice  "
                      f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
                      f"plain {r['plain_ms']:.4f} ms{extra}  "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        # per call at the experiment's shape; full mode heads the entry
        keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "chain_ms",
                "chain_device_ms", "bound_ms", "bound_by")
        by_mode = {mode: {k: fused[(mode, FUSED_SHAPES[0])][k] for k in keys}
                   for mode in ("full", "conv", "act")}
        per_forward["fused_gn_conv"] = dict(by_mode["full"], by_mode=by_mode, max_abs_err=max(
            r["max_abs_err"] for r in fused.values()))
        print("fused_gn_conv: per (8, 256, 256, 128) call: "
              + json.dumps(per_forward["fused_gn_conv"]), flush=True)
        # the backward kernels at every shape of three classifier forwards:
        # the toy32 classifier (batch 2, the guided golden's) and the 256 px
        # classifier of configs/imagenet_256_cc.yml at batch 1 (the hq tile)
        # and batch 8 (the ImageNet-cc row), each shape in bf16 and fp32
        clf = toy_classifier("cuda")
        clf_tables = {"toy32": grad_shapes(clf, torch.zeros(2, 32, 32, 3, device="cuda"))}
        clf = cc_classifier()
        for b in (1, 8):
            clf_tables[f"cc256_b{b}"] = grad_shapes(clf, torch.zeros(b, 256, 256, 3,
                                                                    device="cuda"))
        del clf
        torch.cuda.empty_cache()
        bwd_results = {}
        for key in sorted({k for t in clf_tables.values() for k in t}, key=str):
            for dtype in (torch.float32, torch.bfloat16):
                kinds = (("gn_bwd_reduce", "gn_bwd_dx", "gn_bwd") if key[0] == "gn"
                         else ("attn_bwd_dq", "attn_bwd_dkdv", "attn_bwd"))
                for kind in kinds:
                    extra = dict(swish=key[2], film=key[3]) if key[0] == "gn" else {}
                    r = bwd_results[(key, kind, dtype)] = check_backward(
                        kind, key[1], dtype, gen, **extra)
                    lib = ("-" if r["library_ms"] is None else
                           f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f})")
                    tag = "".join(f" +{k}" for k in ("swish", "film") if extra.get(k))
                    auto = (f" vs autograd {r['autograd_err']:.2e} (tol {r['autograd_tol']:.1e})"
                            if "autograd_err" in r else "")
                    print(f"{kind + tag:22s} {str(key[1]):22s} {r['dtype']:8s} "
                          f"err {r['max_abs_err']:.2e} (tol {r['tol']:.1e}){auto} "
                          f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
                          f"plain {r['plain_ms']:.4f} ms  library {lib}  "
                          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

        # per guidance call (one classifier forward's backward) of each table,
        # bf16 for the 256 px classifier (as the guided runs), fp32 for toy32
        bwd_per_call = {}
        for name, table in clf_tables.items():
            dtype = torch.float32 if name == "toy32" else torch.bfloat16
            for kind in BACKWARD + ("gn_bwd", "attn_bwd"):
                rows = [(bwd_results[(key, kind, dtype)], c) for key, c in table.items()
                        if (key, kind, dtype) in bwd_results]
                bwd_per_call[(name, kind)] = dict(per_call_sum(rows), max_abs_err=max(
                    r["max_abs_err"] for k, r in bwd_results.items() if k[1] == kind))
                print(f"{kind}: per {name} guidance call ({str(dtype)[6:]}): "
                      + json.dumps(bwd_per_call[(name, kind)]), flush=True)
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
        # the runner's A+y preview and its range-space check (1 each) on top
        # of A(x), the set-up and the steps
        _, launches = main_path("cs_walshhadamard", "0.25", False, n_gn, n_attn,
                                2 + fwht_launches("cs_walshhadamard", 0.0, 100))

    with phase(8, "fused GN+SiLU+conv experiment (default run, ablations, UNet shapes)"):
        exp_runs = experiment()
        # the default run's launches: its chain and fused loops
        launches_experiment = {k: sum(r["launches"][k] for r in
                                      exp_runs["default"]["variants"].values())
                               for k in launches}

    with phase(9, "hq parity on the toy32 ADM (fp32 goldens, bf16, Mask-Shift orders)"):
        toy = toy_adm("cpu")
        hq_parity(*module_counts(toy))
        del toy

    with phase(10, "hq main path through hq_main_torch (inet256 ADM, bf16, 2 x 2 tiles)"):
        hq_stats, launches_hq = hq_main_path(n_gn_hq, n_attn_hq)

    with phase(11, "main-runner parity on the toy32 ADM (six ImageNet rows, fp32 goldens)"):
        toy = toy_adm("cpu")
        main_runner_parity(*module_counts(toy))
        del toy

    with phase(12, "ImageNet rows through evaluation_torch (imagenet_256 ADM, bf16, batch 8, "
                   "100 steps) and the noisy CelebA rows"):
        inet_rows, launches_inet = imagenet_rows(n_gn_inet, n_attn_inet, n_gn, n_attn)

    with phase(13, "guided parity on the toy32 ADM and classifier (fp32 golden, bf16)"):
        guided_toy = guided_parity()

    with phase(14, "guided runs at full width (inet256 hq tile, imagenet_256_cc row; bf16)"):
        guided, launches_ghq, launches_gcc = guided_full_width(n_gn_hq, n_attn_hq,
                                                               n_gn_inet, n_attn_inet)

    # launches: the hq path's (phase 10) for the kernels it runs (GroupNorm
    # stats and apply, attention), the SVD main path's (phase 7) for the
    # FWHT and the experiment's default run (phase 8) for fused_gn_conv, the
    # only paths that run those two; launches_by_path has all four. ms and
    # the other numbers are per bf16 batch-8 DDPM forward (GroupNorm,
    # attention), as before; hq_forward has them per hq ADM forward.
    # The backward kernels: launches from the guided hq tile (phase 14),
    # ms and the other numbers per guidance call of the 256 px classifier at
    # batch 8, bf16 (the ImageNet-cc row's; the hq tile's at batch 1 and the
    # toy32 run's are under per_guidance_call).
    for kind in BACKWARD:
        per_forward[kind] = bwd_per_call[("cc256_b8", kind)]
    launches_of = {"groupnorm_stats": launches_hq, "groupnorm_apply": launches_hq,
                   "attention": launches_hq, "fwht": launches,
                   "fused_gn_conv": launches_experiment,
                   **dict.fromkeys(BACKWARD, launches_ghq)}
    summary = {"kernels": [
        {"name": kind, "route": "cuda", "source": SOURCES[kind][0],
         "replaces": SOURCES[kind][1],
         "launches": launches_of[kind][kind],
         "launches_by_path": {"simplified": launches_simplified[kind],
                              "svd": launches[kind],
                              "experiment": launches_experiment[kind],
                              "hq": launches_hq[kind],
                              "imagenet": launches_inet[kind],
                              "guided_toy32": guided_toy["kernel"]["launches"][kind],
                              "guided_hq": launches_ghq[kind],
                              "guided_imagenet_cc": launches_gcc[kind]},
         "max_abs_err": per_forward[kind]["max_abs_err"], "ms": per_forward[kind]["ms"],
         "device_ms": per_forward[kind].get("device_ms"),
         "plain_ms": per_forward[kind]["plain_ms"],
         "bound_ms": per_forward[kind]["bound_ms"],
         "bound_by": per_forward[kind]["bound_by"],
         "library_ms": per_forward[kind]["library_ms"],
         **({"hq_forward": hq_forward[kind]} if kind in hq_forward else {}),
         **({"imagenet_forward": inet_forward[kind]} if kind in inet_forward else {}),
         **({"by_mode": per_forward[kind]["by_mode"]} if kind == "fused_gn_conv" else {}),
         **({k: per_forward[kind][k] for k in ("device_share_of_bound", "cuda_launches_per_call")}
            if kind == "fwht" else {}),
         **({"per_guidance_call": {name: bwd_per_call[(name, kind)] for name in clf_tables},
             "pair": {name: bwd_per_call[(name, "gn_bwd" if kind.startswith("gn")
                                          else "attn_bwd")] for name in clf_tables}}
            if kind in BACKWARD else {})}
        for kind in SOURCES], "hq_main_path": hq_stats, "imagenet_rows": inet_rows,
        "guided_toy32": guided_toy, "guided": guided}
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
