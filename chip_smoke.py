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
     (sigma_y 0.1), runs through the kernels, held against the JAX package's
     golden (tests/fixtures/flag_svd_*), the noise-free task also through
     the plain versions (held to the golden and to the kernels' run);
     sr_bicubic 4x, colorization and inpainting run through the kernels,
     each held to its JAX PSNR in tests/fixtures/flag_golden_psnr.json;
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
     bf16 torso, the 8 PNGs of exp/datasets/imagenet, batch 8, 50 steps
     (IMAGENET_ROW_STEPS, cut from the configs' 100),
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
     through main_torch (SVD 4x average-pooling SR, batch 8, 50 steps,
     --random_init); s per tile, images/s, launches per model call of
     every forward and backward kernel against the module counts, max
     |A(x) - y|; per guidance call at batch 1 and 8, its ms, launches and
     gradient norm (finite, non-zero), and its gradient with every layer of
     the classifier drawn (so that each GroupNorm and attention backward
     gets a non-zero dy, counted) against the same weights in fp32 with
     force="torch": the kernels in fp32, and in bf16 beside the bf16 plain
     route's own distance;
 15. the multistep solver and the encoder cache against the JAX package in
     fp32 (tests/fixtures/toy_solver_golden.json,
     tools/emit_torch_solver_golden.py): on toy_ddpm32.pt simplified
     multistep at 6 and 10 steps, SVD multistep at 10 and the simplified
     encoder cache at interval 3 (uniform and end_dense keys, 25 steps);
     on toy_adm32.pt a 64 x 64 Mask-Shift canvas (tile 32, stride 16)
     with posterior multistep at 6 NFE and the posterior encoder cache at
     interval 3; each through the kernels and through the plain versions,
     every image within 0.01 dB of JAX, launch counts exact (a key step the
     full forward's GroupNorms and attentions, a decoder-only step the
     decoder half's); the encoder cache at interval 1 equal to the exact
     sampler bit for bit in both forms; flag_ddpm256.pt at 256 px, batch 2,
     simplified multistep at 10 steps against
     tests/fixtures/flag_multistep_golden.json as phase 4;
 16. the accelerators at full width, bf16, through the CLIs: main_torch on
     configs/celeba_hq.yml with flag_ddpm256.pt (batch 8) with --solver
     multistep --t_sampling 10, --encoder_cache 3 --encoder_cache_policy
     end_dense and the exact runs at 100 and 10 steps (PSNR, images/s, max
     |A(x) - y|);
     hq_main_torch on one unguided inet256 tile with --solver multistep on
     a respacing-10 config and --encoder_cache 3 on the 280-call schedule
     (s per tile, model calls/s, decoder-only calls counted through the
     launches); the guided configs/imagenet_256_cc.yml row with --solver
     multistep --t_sampling 10 (every GroupNorm and attention backward with
     a non-zero dy); a tile-granular resume round trip of the inet256 ADM
     (stopped after the first tile group, resumed, equal bit for bit).
 17. the served main path: serve_torch.build_service on the flag DDPM
     (bf16, max_batch 8, 100 steps) behind RestorationServer on 127.0.0.1:
     16 concurrent 4x SR and 4 RGBA inpainting requests, then 2
     cs_walshhadamard requests on a second service; every reply 200 and
     256 x 256 x 3, a coalesced reply and the last lane of a direct group
     of 8 byte-equal to the same request alone,
     mean_batch > 1, launches exact per served group; requests/s, latency,
     PSNR per task;
 18. the hq service: a guided, class-conditional service on the toy32 ADM
     and classifier (fp32) whose replies equal the direct sample_posterior
     call, the guidance gradient's bits with cudnn.deterministic off and
     on; serve_torch.build_hq_service on configs/hq/inet256.yml (random
     weights, bf16, guided, max_batch 2) with 2 ?class=N requests: s per
     served group, forward and backward launches exact;
 19. the data long tail: every committed JPEG fixture through the port's
     numpy decoder against PIL's committed decode (max |diff| <= 1 level,
     pixels that differ counted), the decode's ms per image at 256 x 256
     and 500 x 375 against the PNG reader's; every image-format fixture
     (exp/datasets/formats, exp/datasets/celeba_hq_mixed: WebP, progressive
     and CMYK JPEG, palette / 16-bit / low-bit / interlaced PNG, PPM, PGM,
     BMP) against PIL's committed decode and mode (byte-equal, JPEG within
     a level), ms per 256 px image by format; phase 5's main path on
     celeba_hq_mixed (its 8 images as WebP, progressive and CMYK JPEG,
     palette PNG and BMP), launches exact (7100 GroupNorm, 600 attention),
     images/s against phase 5's;
     hq_evaluation_torch.py --face_sweep on the face256 ADM at full width
     (random weights, bf16, a depth cut to 95 model calls a tile), 2 JPEG
     gts of 320 x 288 cropped to 256 by the pair loader, --sweep_batch 2:
     s per tile, max |A(x) - y| on the written images, launches exact;
 20. data parallelism (ddnm_tpu_torch/parallel), on a mesh of 2: two cards
     where the machine has them, else cuda:0 twice on two streams (the
     phase says which). The samplers run under "auto", the scan driver: a
     CUDA graph a shard, each shard's capture / instantiate seconds, graph
     count and pool bytes printed. (a) phase 5's main path through
     main_torch on the mesh, every output within 1 level of phase 5's and
     byte-equal to the same run under --loop host, images/s beside both,
     each shard's launches exact under both; (b) the same command as two processes
     (gloo rendezvous on 127.0.0.1), together images 0-7 once under their
     global names, each within 1 level of phase 5's, both ranks' wall
     times; (c) phase 17's service with --dp 2: 8 requests through
     RestorationServer (requests/s, p50, launches exact per shard), a
     coalesced reply and lane 7 of a direct group of 8 byte-equal to the
     same request alone, the group within 1 level of the --dp 1 service's
     and bit-equal to a --dp 2 --loop host service's; (d) the toy32 ADM
     Mask-Shift canvas of phase 9 in the wavefront order, fp32, and an 80 x
     128 canvas whose 4-tile wavefront shards 2 + 2, each within 0.01 dB of
     its unsharded run and bit-equal to the mesh run host-driven; (e) the
     256 px classifier's guidance gradient at batch 8 sharded 4 + 4 (the
     backward kernels on two streams at once; no trajectory, so no graph),
     bit-equal to its halves run alone;
 21. spatial partitioning at sp = 2 (ddnm_tpu_torch/parallel/spatial.py):
     (a) the stats kernel's partial mode, the finalize kernel and attention
     with Tq != Tk against their plain versions, bf16 and fp32, at every
     GroupNorm and attention shape of the face256 ADM forward with its rows
     halved: 2 shards' partial sums added and finalised against the
     one-launch stats kernel on the whole map, a shard's attention rows
     against the full kernel's; ms, device ms, bounds, SDPA for attention,
     totals per sharded forward; (b) the toy32 hq golden hq_sr_ap_4x in
     fp32 as two processes on cuda:0 (gloo), within 0.01 dB of the JAX
     package's PSNR, both ranks' final images bit-equal, launches and
     collectives exact; (c) hq_main_torch on configs/hq/face256.yml at full
     width (bf16, dense random weights, 10 model calls a tile): --sp 1 in
     process, --sp 2 as two processes on cuda:0; s per tile at each, the
     sp 2 final against sp 1's, the ranks bit-equal, each shard's launches
     (GroupNorm partial, finalize, apply, gathered attention) and
     collectives per model call exact. Two ranks on one card use gloo,
     which no CUDA graph can hold: (b) prints that "auto" resolved to
     "host" there and (c) that hq_main_torch --loop scan raised naming
     gloo (the NCCL scan runs on four cards: tools/check_spatial_nccl.py).
     The ranks are this script run as
     `chip_smoke.py --spatial-worker KIND OUT_JSON [ARGS]`;
 22. classifier guidance under spatial partitioning at sp = 2: (a) the
     backward kernels' spatial modes against their plain versions, bf16
     and fp32, at every GroupNorm and attention of the 256 px classifier's
     backward at batch 1 with its rows halved: gn_bwd_reduce's partial
     mode on each shard and gn_bwd_finalize on the shards' sums (added in
     rank order) against the one-launch gn_bwd_reduce on the whole map;
     attn_bwd_dq / attn_bwd_dkdv at Tq = T / 2 against every key, a
     shard's dq rows bit-equal to the full kernel's and the shards' dK / dV
     partials summed against its dK / dV; ms, device ms, bounds, SDPA's
     autograd backward as the pair's yardstick, totals per sharded guidance
     call; (b) the toy32 guided golden with the ADM and the classifier
     sharded, fp32, two processes on cuda:0 (gloo, "auto" resolved to
     "host" and "scan" refused, printed): within 0.01 dB of the JAX
     package's PSNR on both ranks, the ranks' finals bit-equal, launches
     and collectives (the backward's apart) exact; (c)
     hq_main_torch on configs/hq/inet256.yml guided at full width (bf16,
     random weights from seed 1234, the classifier dense, 10 model calls a
     tile): --sp 1 in process, --sp 2 as two processes on cuda:0; s per
     call at each, the guidance gradient at one input at sp 2 against sp 1,
     the ranks bit-equal, launches and collectives per call exact.
 23. serving (ddnm_tpu_torch/serving.py): each forward kernel's host
     microseconds per call through its ddnm:: custom op against the direct
     wrapper call, back to back; (a) the flag DDPM's simplified step
     (flag_ddpm256.pt, bf16, batch 8, 256 px, 4x average-pooling SR)
     exported with torch.export on the card, saved, loaded and run, against
     the eager step on the same inputs and threefry key (bit-equal
     expected, max abs printed), launches per step exact through both, ms
     per step of both; (b) the toy32 trajectories of
     tests/fixtures/toy_export_golden.json (tools/emit_torch_export_golden.py)
     in fp32 within 1e-3 of the JAX artifacts: the posterior one (toy_adm32.pt,
     paste + ctx) exported on the card, (c) the simplified one (toy_ddpm32.pt,
     a travel step) exported with CPU tensors, moved onto the card and
     held to its own CPU run within 1e-4; launches exact.
 24. the training path (ddnm_tpu_torch/training.py, tools/train_*_torch.py):
     (a) the GroupNorm backward finalize kernel with the parameter
     gradients (gn_bwd_param: dx's coefficients and the gradients of the
     scale, bias and FiLM, from the backward reduce kernel's partial sums)
     against its plain version at every distinct norm shape of the 114M
     flagship DDPM at batch 16 (fp32, with and without SiLU) and with FiLM
     at a toy ADM shape, the same bits twice; the training backward of a
     norm (sums, the finalize, dx) against its plain version and autograd,
     each of these outputs (A, Bx, Cx, dx, d scale, d bias, d film_scale,
     d film_shift) within 1e-4 of its own largest value; the fp32
     attention backward pair at C = 512 ((16, 256, 512), (16, 64, 512))
     and 256 ((16, 256, 256)) against its plain version and autograd
     within 1e-4 of the largest gradient; ms back to back and
     on the device beside F.group_norm's and SDPA's autograd backward;
     (b) 3 Adam steps of the toy32 DDPM, ADM and classifier from their
     committed weights (toy_ddpm32.pt, toy_adm32.pt, toy_clf32.pt) on the
     port's own draws from PRNGKey(1), fp32, TF32 off, cuDNN deterministic,
     against tests/fixtures/toy_train_golden.json (JAX and optax on the
     CPU, tools/emit_torch_train_golden.py): each loss within 1e-4
     relative, each leaf's gradient L2 norm at step 1 within 1e-3
     relative, each leaf's parameter sum after step 3 within 3 x 2 x lr x
     its size (Adam's first steps move a near-zero gradient by +-lr
     whatever its sign, so bits are not the gate), the first batch's
     checksum; (c) 5 steps of tools/train_flagship_golden_torch.py's loop
     on the 114M flagship DDPM at 256 px, batch 16, fp32 (TF32 allowed),
     freshly initialised, on the 50/50 blob and natural mix drawn on the
     card: s a step, one profiled step's device busy and idle share, peak
     memory, every kernel's launches a step exact (71 GroupNorms and 6
     attentions forward and back), each loss finite; the export read back
     through data/checkpoints.load_checkpoint into a fresh UNet, and one
     bf16 sampling step of it held to the trained module's own;
 25. the loop drivers (ddnm_tpu_torch/sampling/graphs.py): (a) five toy32
     fp32 paths (simplified with time travel, SVD cs_walshhadamard through
     the FWHT kernel, the multistep solver, the posterior sampler with
     op_ctx, paste mask and undo steps, the guided posterior with the
     toy32 classifier), cuDNN deterministic, each with per-image
     generators and with a KeyNoise: loop="scan" (a CUDA graph of the
     trajectory) bit-equal to loop="host" at the capturing call and at a
     replay on other inputs, launch counts and the noise source's state
     after the call equal; the hq and guided toy32 goldens under an
     explicit loop="scan"; (b) the main path at full width (the flag DDPM,
     bf16, batch 8, 100 steps, sr_averagepooling) through both drivers
     (tools/time_loop_drivers.py): ms a step, the first call's warm-up,
     capture and instantiate seconds, each driver's device busy time and
     idle share, the graph pool's bytes; bit-equal, launches equal.
Every sampler of phases 5-19 and 23-24 runs on the default loop, "auto",
which is the scan: each trajectory a CUDA graph, captured at the first
call of its key, replayed after; the graphs a phase captured are dropped
at its end. The fp32 parity runs at 256 px (phases 4 and 6, phase 15's
flag multistep) run loop="host" (FP32_FULL_WIDTH_LOOP); phases 20-22 run
meshes and --sp, which are host-driven.
Phases 5, 7, 16 and 19 also print each runner's images/s end to end against in
the sampler ("runner overlap" lines).

Phase 3 also holds the four backward kernels (gn_bwd_reduce, gn_bwd_dx,
attn_bwd_dq, attn_bwd_dkdv; no TPU counterpart) against their plain
versions, and each pair against autograd through the plain forward, in
fp32 and bf16 at every shape of three classifier forwards (the toy32
classifier at batch 2; the 256 px classifier at batch 1 and 8), the
reduce and attention kernels with the same bits on a second call, timed
beside the library's autograd backward (F.group_norm, SDPA), prints the
attention pair's device time against SDPA's at each head shape of the 256
px classifier, and sums their times per guidance call (with gn_bwd_reduce's
device share of its bound per 256 px guidance call at batch 1 and 8).
Phase 3 also holds the GroupNorm (with FiLM) and attention kernels against
their plain versions at every shape of phase 10's ADM forward (one tile,
bf16) and of phase 12's (batch 8, 256 px, bf16) and sums their times per
such forward.
Phase 2 prints the -Xptxas -v registers and spills of the conv, apply,
Walsh-Hadamard, GroupNorm backward reduce and parameter-gradient, and the
bf16 and fp32 attention backward kernels. Phase 3 also holds the
Walsh-Hadamard kernel against its plain version at the SVD paths' shapes and at edge shapes (one
slab, a ragged slab count, every tier's P, P = 1 and 2, 100 MB), each with
the same bits on a second call and on a strided view, one wrapper call and
one CUDA launch a call (torch.profiler), and its share of the bound on the
device; and the fused GN+SiLU+conv kernel in its
three modes (full, conv, act) at the experiment's shape, a small one and a
ragged one (the conv kernel's bits equal on two calls), back to back and
on the device beside F.conv2d and the unfused chain.
Each of phases 4-25 sets the launch counts to 0 just before each run it
drives and checks them exactly just after (the ranks of phases 21 and 22
each their own).

The line before the last is the JSON summary of the kernels (the stats
kernel's partial and finalize modes under its entry's "modes", attention
with Tq != Tk as "attention_gathered", the backward's spatial modes as
"gn_bwd_partial", "gn_bwd_finalize", "attn_bwd_dq_gathered" and
"attn_bwd_dkdv_gathered", and the training path's "gn_bwd_param" and
"attn_bwd_c512", with their launches from phase 24's flagship steps); the
last line is {"ok": true,
"device": {...}}. Outputs go to a temporary directory.
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
    _bwd_finalize,
    _bwd_reduce,
    _bwd_sums,
    _kernel_group_norm,
    _stats_affine,
    _torch_apply,
    _torch_bwd_dx,
    _torch_bwd_finalize,
    _torch_bwd_partial,
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
    #    exp against torch.exp; bf16 outputs one ulp apart; in bf16 the
    #    tensor-core kernels also round P and dS to bf16 as mma operands
    #    (tests/test_torch_attn_bwd_rounding.py holds that rounding model
    #    within these gates on the CPU);
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
    # training: the parameter-gradient fold on the same sums (fp32 folds
    # in another order), and the whole training backward of a norm against
    # the plain one (sums of B H W terms in another order); their outputs
    # span six orders of magnitude (d scale sums B H W terms, Bx and Cx are
    # ~1e-3), so each output is held to 1e-4 of its own largest value
    # (OWN_SCALE), where the other kinds share one scale
    ("gn_param", torch.float32): 1e-4,
    ("gn_train", torch.float32): 1e-4,
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
# the backward kinds whose every output has a tolerance of its own scale,
# and the names of those outputs (gn_param's coefficients split by row)
OWN_SCALE = {"gn_param": ("A", "Bx", "Cx", "d_scale", "d_bias", "d_film_scale",
                          "d_film_shift"),
             "gn_train": ("dx", "d_scale", "d_bias", "d_film_scale", "d_film_shift")}
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
    """Print the phase's start and its seconds at its end; drop the CUDA
    graphs it captured (the samplers' scan driver keeps up to 8, each with
    the model it reads and a memory pool)."""
    from ddnm_tpu_torch.sampling import graphs

    print(f"== phase {n}: {name}", flush=True)
    t0 = time.perf_counter()
    yield
    graphs.clear_graphs()
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


def overlap_gap_line(name: str, stats: dict) -> str:
    """One line of a runner's images/s end to end against in the sampler
    (the runner's host overlap: decode ahead, drain behind)."""
    e2e = stats["images_per_second"]
    smp = stats["num_samples"] / stats["sample_seconds"]
    return (f"runner overlap {name}: {e2e:.4f} images/s end to end, {smp:.4f} in the "
            f"sampler, end to end / sampler {e2e / smp:.3f} "
            f"({stats['wall_seconds'] - stats['sample_seconds']:.2f} s outside the sampler)")


# ------------------------------------------------------------------ phase 2


def ptxas_summary(lines: list[str]) -> list[str]:
    """One line per kernel of a `-Xptxas -v` report: registers, stack and
    spills, and any note that ptxas serialised its wgmma instructions."""
    def short(text):
        found = re.search(r"\d((?:fgc|gn|fwht|attn)_[a-z_]*kernel)(I\w*?E)?E", text)
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

# The fp32 parity protocols at 256 px (phases 4 and 6, and phase 15's flag
# multistep) run the host loop: with TF32 off, cuDNN's engines take a
# workspace of ~18 GB there, and a CUDA graph of phase 4's 25 steps took
# 25.1 s to capture and 23.5 s to instantiate (an 18.2 GB pool) against
# 13.4 s for the eager run (on an H100 80GB HBM3 at 700 W). Phase 25 holds the
# scan driver in fp32 at toy32, and the bf16 paths run it at full width.
FP32_FULL_WIDTH_LOOP = "host"


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
                                 noise_fn=zero, loop=FP32_FULL_WIDTH_LOOP)
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
# sr_ap_4x and sr_ap_4x_noisy left to make room for phase 23:
# the SVD average-pooling operator keeps its fp32 parity on the toy32 ADM
# (phase 11's imagenet_sr_ap_4x) and runs at full width in bf16 (phase
# 12); the noisy update keeps cs_wh_noisy's pooled golden.
SVD_TASKS = [
    ("cs_wh_025", "cs_walshhadamard", 0.25, 0.0),
    ("cs_wh_noisy", "cs_walshhadamard", 0.25, 0.1),
    ("sr_bicubic_4x", "sr_bicubic", 4.0, 0.0),
    ("colorization", "colorization", 4.0, 0.0),
    ("inpainting", "inpainting", 4.0, 0.0),
]


# the SVD tasks that also run through the plain versions (the kernel
# route of every task is held to the JAX golden; the plain route of one,
# the Walsh-Hadamard noise-free task, holds the kernels to their plain
# versions over a whole trajectory)
SVD_PLAIN_TASKS = ("cs_wh_025",)


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
        routes = ("kernel", "torch") if name in SVD_PLAIN_TASKS else ("kernel",)
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
                              eta=proto["eta"], sigma_y=sigma_y, noise_fn=zero,
                              loop=FP32_FULL_WIDTH_LOOP)
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


def hq_golden_run(model, device, task, sample=None) -> tuple[float, torch.Tensor, float]:
    """One unguided hq golden task through the port's sample_posterior (or
    `sample`, e.g. parallel.grid_sampler of it) under the golden protocol
    (tests/_golden_adm.py run_hq_task): returns (PSNR of the 2-image batch
    against the ground truth, final images, seconds)."""
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
    x, _ = (sample or sample_posterior)(lambda z, t: model(z, t), xt, op.Ap(op.A(gt)), op,
                                        tables, [None, None], noise_fn=zero)
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


# the depth of the ImageNet rows (phase 12) and of the guided ImageNet-cc
# row (phase 14), cut from the configs' 100 steps: under the
# scan driver each row's one batch pays its graph's capture and
# instantiate (~1.6x the host loop), and the whole script stays under
# 1000 s of its 1200
IMAGENET_ROW_STEPS = 50


def imagenet_rows(n_gn: int, n_attn: int, n_gn_ddpm: int, n_attn_ddpm: int,
                  ) -> tuple[dict, dict]:
    """Phase 12: the six ImageNet rows of evaluation_torch on the 552.8M ADM
    (bf16, random weights, batch 8, IMAGENET_ROW_STEPS steps), then its two noisy CelebA
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
            steps = IMAGENET_ROW_STEPS if imagenet else 25
            argv = (["--datasets", "imagenet", "--random-init"] if imagenet else
                    ["--datasets", "celeba", "--ckpt-celeba", str(FLAG_PT)]
                    ) + ["--t-sampling", str(steps)]
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
                   swish: bool = False, film: bool = False, timed: bool = True) -> dict:
    """A backward kernel (gn_bwd_reduce, gn_bwd_dx, attn_bwd_dq,
    attn_bwd_dkdv; in training gn_param: gn_bwd_finalize with the parameter
    gradients on the partial sums of the reduce kernel) or a pair (gn_bwd:
    reduce then dx; attn_bwd: dq then dkdv; gn_train: the training backward
    of a norm, sums, the finalize and dx, with the gradients of the scale,
    bias and FiLM) against its
    plain version at one shape, with the forward's saved tensors made by
    the forward kernels; a pair also against autograd through the plain
    forward and timed beside the library's autograd backward (F.group_norm,
    without FiLM or SiLU, with its weight and bias for gn_train; SDPA),
    with the graph built once and only the backward timed. gn_bwd_reduce,
    gn_param, attn_bwd_dq and attn_bwd_dkdv must give the same bits on a
    second call. Every output is held to TOL times the largest plain value
    of all outputs (at least 1), or, for the OWN_SCALE kinds, of its own;
    `err_over_tol` is the worst output's ratio. `timed` False: the checks
    alone. Returns a result dict as check_kernel's."""
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
        elif kind == "gn_param":
            sums = _bwd_sums(x, dy, 32, swish, a_, b_)
            drop = lambda out: [t for t in out if t is not None]  # noqa: E731
            split = lambda out: [*out[0].unbind(0), *drop(out[1:])]  # noqa: E731
            kern = lambda: split(_bwd_finalize(sums, H * W, g, 32, 1e-5, fs, b))
            plain = lambda: split(_torch_bwd_finalize(sums, H * W, g, 32, 1e-5, fs, b))
            if not all(torch.equal(u, v) for u, v in zip(kern(), kern())):
                raise AssertionError(f"gn_param {shape} {dtype}: two calls differ")
            cpg = C // 32
            film_floats = 3 * B * C if film else 0  # film_scale read, two gradients written
            nbytes = 4 * (4 * B * C + 2 * C + 3 * B * C + 2 * C + film_floats)
            flops = B * C * (4 * cpg + 24)
        elif kind == "gn_train":
            def kern():
                sums = _bwd_sums(x, dy, 32, swish, a_, b_)
                coef, *grads = _bwd_finalize(sums, H * W, g, 32, 1e-5, fs, b)
                return [_bwd_dx(x, dy, coef, swish, a_, b_)] + [t for t in grads
                                                                if t is not None]

            def plain():
                sums = _torch_bwd_partial(x, dy, swish, a_, b_)
                coef, *grads = _torch_bwd_finalize(sums, H * W, g, 32, 1e-5, fs, b)
                return [_torch_bwd_dx(x, dy, coef, swish, a_, b_)] + [t for t in grads
                                                                      if t is not None]

            leaves = [x.clone(), g.clone(), b.clone()] + ([fs.clone(), ft.clone()] if film
                                                          else [])
            leaves = [t.requires_grad_(True) for t in leaves]
            autograd_ref = torch.autograd.grad(
                _torch_group_norm(*leaves[:3], 32, 1e-5, swish, *leaves[3:]), leaves, dy)
            xl = x.permute(0, 3, 1, 2).detach().requires_grad_(True)  # channels_last bytes
            wl, bl = g.clone().requires_grad_(True), b.clone().requires_grad_(True)
            yl = F.group_norm(xl, 32, wl, bl, 1e-5)
            dyl = dy.permute(0, 3, 1, 2)
            library = lambda: torch.autograd.grad(yl, (xl, wl, bl), dyl, retain_graph=True)
            nbytes, flops = 3 * n * elem, (16 + 2 * silu) * n
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
        if kind != "attn_bwd" and not all(torch.equal(a, b) for a, b in zip(kern(), kern())):
            raise AssertionError(f"{kind} {shape} {dtype}: two calls differ")
    as_list = lambda out: list(out) if isinstance(out, (tuple, list)) else [out]
    refs = [t.float() for t in as_list(plain())]
    got = as_list(kern())
    torch.cuda.synchronize()
    names = OWN_SCALE.get(kind, ())
    if names and not film:
        names = tuple(n for n in names if "film" not in n)
    label = lambda i: names[i] if names else f"output {i}"  # noqa: E731

    def held(ref, against):
        """(name, error, tolerance, err / tol) of the worst output of `got`
        against `ref`, each output checked."""
        errs = [float((k.float() - r).abs().max()) for k, r in zip(got, ref)]
        if names:
            tols = [TOL[(kind, dtype)] * float(r.abs().max()) for r in ref]
        else:
            tols = [TOL[(kind, dtype)] * max(1.0, max(float(r.abs().max()) for r in ref))] \
                * len(ref)
        for i, (e, t) in enumerate(zip(errs, tols)):
            if not e <= t:
                raise AssertionError(f"{kind} {shape} {dtype} swish={swish} film={film}: "
                                     f"{label(i)}, kernel vs {against} max abs {e:.3e} > "
                                     f"{t:.3e}")
        ratios = [e / t if t > 0 else 0.0 for e, t in zip(errs, tols)]
        i = max(range(len(ratios)), key=ratios.__getitem__)
        return label(i), errs[i], tols[i], ratios[i]

    worst, _, tol, ratio = held(refs, "plain")
    out = {"kind": kind, "shape": shape, "dtype": str(dtype).replace("torch.", ""),
           "swish": swish, "film": film, "max_abs_err": max(float((k.float() - r).abs().max())
                                                            for k, r in zip(got, refs)),
           "tol": tol, "worst": worst, "err_over_tol": ratio}
    if autograd_ref is not None:
        a_worst, a_err, a_tol, a_ratio = held([t.float() for t in as_list(autograd_ref)],
                                              "autograd through the plain forward")
        out.update(autograd_err=a_err, autograd_tol=a_tol, autograd_worst=a_worst,
                   autograd_err_over_tol=a_ratio)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    if not timed:
        return out
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


def guided_golden_run(model, classifier, device, tier: str = "toy32", grid=None,
                      sample=None):
    """The guided hq golden protocol (tests/fixtures/toy_adm32_guided_golden.json)
    through the port's sample_posterior with `classifier_guidance_fn`:
    the golden's ground truth, x_T from RandomState(11), zero noise, 4x
    average-pooling SR, respacing 25 with the jump schedule, class 2, scale
    2.0. `grid`: the model and the classifier are sharded over its spatial
    group, and both callables go through Grid.wrap; `sample` replaces
    sample_posterior (e.g. parallel.grid_sampler of it). Returns (batch PSNR,
    final images, per-image max |final - JAX output|, seconds)."""
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
    model_fn = lambda z, s: model(z, s)
    if grid is not None:
        model_fn, _, _, guidance = grid.wrap(model_fn, model=model, guidance_fn=guidance,
                                             classifier=classifier)
    zero = lambda gens, shape: torch.zeros(shape, device=device)
    t0 = time.perf_counter()
    x, _ = (sample or sample_posterior)(model_fn, xt, op.Ap(op.A(gt)), op, tables,
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


GUIDED_CC_STEPS = IMAGENET_ROW_STEPS  # phase 14's ImageNet-cc row, as phase 12's


def guided_full_width(n_gn_hq: int, n_attn_hq: int, n_gn_inet: int, n_attn_inet: int
                      ) -> tuple[dict, dict, dict]:
    """Phase 14: the guided configurations at full width, bf16, random
    weights from seed 1234: one 256 px tile of configs/hq/inet256.yml
    (classifier_scale 1.0, the 553.8M ADM and the 54,096,360-parameter
    classifier) through hq_main_torch, 280 model calls, 4x SR of a 64 x 64
    PNG with --resize_y; and the configs/imagenet_256_cc.yml row through
    main_torch (SVD sr_averagepooling 4x, batch 8, GUIDED_CC_STEPS steps,
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
            "--t_sampling", str(GUIDED_CC_STEPS),
            "-i", str(tmp / "cc"), "--ni", "--verbose", "warning"])
        launches_cc = ops.launch_counts()
        n_png = len(list((tmp / "cc").glob("*_0.png")))
    hq = dict(out["stats"])
    hq["range_space_max_abs"] = float(np.abs(
        out["final"].reshape(1, 64, 4, 64, 4, 3).mean(axis=(2, 4)) - out["y"]).max())
    calls, steps = hq["model_calls"], GUIDED_CC_STEPS
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
    print(f"guided ImageNet-cc row (imagenet_256_cc, bf16, batch 8, {steps} steps): "
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


# ------------------------------------------------------------ phases 15 and 16

TOY_DDPM_PT = REPO / "tests" / "fixtures" / "toy_ddpm32.pt"
SOLVER_GOLDEN = REPO / "tests" / "fixtures" / "toy_solver_golden.json"
FLAG_MS_GOLDEN = REPO / "tests" / "fixtures" / "flag_multistep_golden.json"
FLAG_MS_POOL8 = REPO / "tests" / "fixtures" / "flag_multistep_pool8.npy"
SOLVER_PSNR_TOL = 0.01  # dB per image, fp32 on the card against the JAX package's fp32
# the toy runs' 8 x 8-pooled outputs against the JAX golden: 7e-7 on the
# CPU (tests/test_torch_accel.py); the gate leaves the card's other fp32
# summation order room to grow at the encoder cache's high-noise steps,
# where a cached eps does not follow x (the 9-tile chain's pixels differ by
# up to 2e-4 between the two frameworks on the CPU)
SOLVER_POOL8_TOL = 1e-3


def toy_ddpm(device, proto: dict):
    """The toy32 DDPM UNet of tests/fixtures/toy_ddpm32.pt, its arguments
    from the solver golden's protocol."""
    from ddnm_tpu_torch.models import DDPMUNet
    from ddnm_tpu_torch.runner import load_checkpoint

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in proto["ddpm_kw"].items()}
    model = DDPMUNet(**kw)
    load_checkpoint(model, TOY_DDPM_PT)
    return model.to(device).eval()


def decoder_counts(model) -> tuple[int, int]:
    """(GroupNorms, attentions) of a UNet's decoder half: what a cached step
    of the encoder cache launches (the DDPM's up path and output norm, the
    ADM's output blocks and head)."""
    from ddnm_tpu_torch.models import DDPMUNet

    parts = ((model.up, model.norm_out) if isinstance(model, DDPMUNet)
             else (model.output_blocks, model.out))
    counts = [module_counts(p) for p in parts]
    return sum(c[0] for c in counts), sum(c[1] for c in counts)


def key_step_counts(is_travel, interval: int, key_steps) -> tuple[int, int]:
    """(key steps, cached steps) of one encoder-cache trajectory, as the
    samplers place them (sampling/accel.py): a key step at every segment
    start (a jump drops the cache) and where the predicate says so."""
    from ddnm_tpu_torch.sampling.accel import _make_key_pred

    is_key = _make_key_pred(interval, key_steps)
    keys = cached = seg = glob = 0
    for travel in np.asarray(is_travel, bool).tolist():
        if travel:
            seg = 0
            continue
        if seg == 0 or is_key(seg, glob):
            keys += 1
        else:
            cached += 1
        seg += 1
        glob += 1
    return keys, cached


@contextlib.contextmanager
def tile_pattern_init(pattern: torch.Tensor):
    """Every fresh tile init of ddnm_tpu_torch.tiling drawn as `pattern`, as
    the solver golden's JAX run draws it (its tile init patched alike)."""
    from ddnm_tpu_torch import tiling

    real = tiling.default_noise
    tiling.default_noise = lambda gens, shape: pattern.expand(shape).clone()
    try:
        yield
    finally:
        tiling.default_noise = real


def solver_golden_run(name: str, models: dict, device) -> dict:
    """One run of the toy solver golden (tests/fixtures/toy_solver_golden.json,
    tools/emit_torch_solver_golden.py) through the port on `device`:
    models["ddpm"] (toy_ddpm32.pt) or models["adm"] (toy_adm32.pt), zero
    noise. Returns the per-image PSNRs, the 8 x 8-pooled final x, the final
    x, the seconds and the run's key and cached model calls."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
    from ddnm_tpu_torch.sampling import build_posterior_tables, build_schedule
    from ddnm_tpu_torch.sampling import sample_simplified, sample_svd
    from ddnm_tpu_torch.sampling.accel import (
        ddpm_split_fns,
        adm_split_fns,
        key_steps_for_policy,
        n_model_calls,
        sample_simplified_encoder_prop,
    )
    from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec
    from ddnm_tpu_torch.tiling import mask_shift_sample, tile_grid

    proto = json.loads(SOLVER_GOLDEN.read_text())["protocol"]
    run = proto["runs"][name]
    zero = lambda gens, shape: torch.zeros(shape, device=device)
    interval = run.get("encoder_cache", 1)
    t0 = time.perf_counter()
    if run["model"] == "ddpm":
        p, model = proto["ddpm"], models["ddpm"]
        n, res = p["n_images"], p["res"]
        paths = sorted((REPO / p["eval_dir"]).glob("*.png"))[:n]
        gt = torch.from_numpy(np.stack([load_image(q) for q in paths]) * 2.0 - 1.0).to(device)
        xt = np.random.RandomState(p["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
        xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1))).to(device)
        betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                      num_diffusion_timesteps=1000).astype(np.float32)
        sched = build_schedule(betas=betas, t_sampling=run["t_sampling"])
        calls = n_model_calls(sched)
        key_steps = None
        if run.get("mode") == "svd":
            op = build_svd_operator(p["deg"], channels=3, image_size=res,
                                    deg_scale=p["deg_scale"], device=device)
            x, _ = sample_svd(model, xt, op.A(_nhwc_to_vec(gt)), op, sched, [None] * n,
                              noise_fn=zero, solver=run["solver"])
        else:
            op = build_functional_operator(p["deg"], image_size=res, deg_scale=p["deg_scale"],
                                           device=device)
            if interval > 1:
                key_steps = key_steps_for_policy(calls, interval, run["policy"])
                x, _ = sample_simplified_encoder_prop(
                    *ddpm_split_fns(model), xt, op.A(gt), op, sched, [None] * n, eta=p["eta"],
                    interval=interval, key_steps=key_steps, noise_fn=zero)
            else:
                x, _ = sample_simplified(model, xt, op.A(gt), op, sched, [None] * n,
                                         noise_fn=zero, solver=run["solver"])
        keys, cached = key_step_counts(sched.is_travel, interval, key_steps)
    else:
        p, model = proto["adm"], models["adm"]
        img = load_image(sorted((REPO / "exp" / "datasets" / "natural64").glob("*.png"))[0])
        gt = torch.from_numpy(img * 2.0 - 1.0)[None].to(device)
        first = np.random.RandomState(p["first_init_seed"]).randn(1, 3, 32, 32).astype(np.float32)
        first = np.ascontiguousarray(first.transpose(0, 2, 3, 1))
        pattern = np.random.RandomState(p["tile_pattern_seed"]).randn(1, 32, 32, 3)
        tables = build_posterior_tables(
            betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
            timestep_respacing=run["timestep_respacing"],
            schedule_jump_params=run["schedule_jump_params"])
        kw = dict(solver=run["solver"]) if interval == 1 else dict(
            encoder_cache=interval, encoder_cache_policy=run["policy"],
            **dict(zip(("encode_fn", "decode_fn"), adm_split_fns(model))))
        with tile_pattern_init(torch.from_numpy(pattern.astype(np.float32)).to(device)):
            out = mask_shift_sample(lambda z, s: model(z, s), gt, p["deg"], tables, 0,
                                    scale=p["scale"], noise_fn=zero, tile_init=p["tile_init"],
                                    init_noise=first, tile=p["tile"], stride=p["stride"],
                                    device=device, **kw)
        x = torch.from_numpy(out["final"]).to(device)
        n_tiles = len(tile_grid(64, 64, p["tile"], p["stride"]))
        per_tile = key_step_counts(
            tables.is_travel, interval,
            key_steps_for_policy(n_model_calls(tables), interval, run.get("policy")))
        keys, cached = (n_tiles * c for c in per_tile)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    to01 = lambda a: torch.clamp((a + 1) / 2, 0, 1)
    psnrs = [float(10 * torch.log10(1 / ((to01(x[i]) - to01(gt[i])) ** 2).mean().clamp_min(1e-12)))
             for i in range(len(x))]
    pool = F.avg_pool2d(x.permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1).cpu().numpy()
    return {"psnr": psnrs, "pool8": pool, "x": x, "seconds": secs, "keys": keys,
            "cached": cached}


def solver_parity() -> dict:
    """Phase 15: every run of the toy solver golden in fp32 through the
    kernels and through the plain versions (force="torch"), each image
    within SOLVER_PSNR_TOL of the JAX package's PSNR and its pooled output
    within SOLVER_POOL8_TOL, launch counts exact (a key step the full
    forward's GroupNorms and attentions, a cached step the decoder half's);
    the encoder cache at interval 1 equal to the exact sampler bit for bit
    in the simplified and the posterior form (stochastic noise, time
    travel); the flag DDPM at 256 px, batch 2, simplified multistep at 10
    steps against tests/fixtures/flag_multistep_golden.json (as phase 4)."""
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force
    from ddnm_tpu_torch.sampling.accel import (
        adm_split_fns,
        ddpm_split_fns,
        sample_posterior_encoder_prop,
        sample_simplified_encoder_prop,
    )

    golden = json.loads(SOLVER_GOLDEN.read_text())
    models = {"ddpm": toy_ddpm("cuda", golden["protocol"]["ddpm"]), "adm": toy_adm("cuda")}
    full = {k: module_counts(m) for k, m in models.items()}
    dec = {k: decoder_counts(m) for k, m in models.items()}
    print(f"toy32 module counts (GroupNorm, attention): full forward {full}, decoder half "
          f"{dec}", flush=True)
    out = {"runs": {}, "module_counts": full, "decoder_counts": dec}
    for name, run in golden["protocol"]["runs"].items():
        ref = golden["runs"][name]
        model = models[run["model"]]
        res = {}
        for mode in ("kernel", "torch"):
            set_op_force(model, None if mode == "kernel" else "torch")
            ops.reset_launch_counts()
            r = solver_golden_run(name, models, "cuda")
            r["launches"] = ops.launch_counts()
            res[mode] = r
        set_op_force(model, None)
        r = res["kernel"]
        (gf, af), (gd, ad) = full[run["model"]], dec[run["model"]]
        want = expected_launches(gf * r["keys"] + gd * r["cached"],
                                 af * r["keys"] + ad * r["cached"])
        kvp = float((res["kernel"]["x"] - res["torch"]["x"]).abs().max())
        row = {"keys": r["keys"], "cached": r["cached"], "kernel_vs_plain_max_abs": kvp,
               "golden_psnr": ref["per_image_psnr"]}
        for mode, rr in res.items():
            pool_err = float(np.abs(rr["pool8"] - np.asarray(ref["pool8"], np.float32)).max())
            row[mode] = {"psnr": rr["psnr"], "pool8_max_abs_vs_golden": pool_err,
                         "seconds": rr["seconds"]}
            print(f"{name:17s} fp32 {mode:6s}: PSNR {['%.4f' % v for v in rr['psnr']]} (JAX "
                  f"{['%.4f' % v for v in ref['per_image_psnr']]}), pool8 vs golden "
                  f"{pool_err:.2e}, {rr['seconds']:.2f} s", flush=True)
            for got, exp in zip(rr["psnr"], ref["per_image_psnr"]):
                if not abs(got - exp) <= SOLVER_PSNR_TOL:
                    raise AssertionError(f"{name} {mode}: PSNR {got:.4f} vs JAX {exp:.4f}")
            if not pool_err <= SOLVER_POOL8_TOL:
                raise AssertionError(f"{name} {mode}: pooled output vs golden {pool_err:.3e}")
        print(f"{name:17s} key calls {r['keys']}, decoder-only calls {r['cached']}; kernel vs "
              f"plain max abs {kvp:.2e}; launches {r['launches']}", flush=True)
        if r["launches"] != want:
            raise AssertionError(f"{name}: launch counts {r['launches']} != {want}")
        if any(res["torch"]["launches"].values()):
            raise AssertionError(f"{name}: plain run launched kernels: "
                                 f"{res['torch']['launches']}")
        out["runs"][name] = row

    # interval 1 is the exact sampler, bit for bit, on the card
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.sampling import build_posterior_tables, build_schedule
    from ddnm_tpu_torch.sampling import sample_posterior, sample_simplified
    from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators

    gens = lambda: image_generators(5, [0, 1], STREAM_SAMPLE, "cuda")
    g = torch.Generator("cuda").manual_seed(3)
    xt = torch.randn(2, 32, 32, 3, device="cuda", generator=g)
    gt = torch.rand(2, 32, 32, 3, device="cuda", generator=g) * 2 - 1
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0,
                                   device="cuda")
    ddpm, adm = models["ddpm"], models["adm"]
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    sched = build_schedule(betas=betas, t_sampling=10, travel_length=2, travel_repeat=2)
    exact = sample_simplified(ddpm, xt, op.A(gt), op, sched, gens())
    cached = sample_simplified_encoder_prop(*ddpm_split_fns(ddpm), xt, op.A(gt), op, sched,
                                            gens(), interval=1)
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True), timestep_respacing="12",
        schedule_jump_params=dict(t_T=12, n_sample=1, jump_length=3, jump_n_sample=2))
    apy = op.Ap(op.A(gt))
    exact_p = sample_posterior(lambda z, s: adm(z, s), xt, apy, op, tables, gens())
    cached_p = sample_posterior_encoder_prop(*adm_split_fns(adm), xt, apy, op, tables, gens(),
                                             interval=1)
    same = {"simplified": all(torch.equal(a, b) for a, b in zip(exact, cached)),
            "posterior": all(torch.equal(a, b) for a, b in zip(exact_p, cached_p))}
    print(f"encoder cache at interval 1 == the exact sampler, bit for bit: {same}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"interval 1 differs from the exact sampler: {same}")
    out["interval_1_bit_equal"] = same
    del models, ddpm, adm
    out["flag"] = flag_multistep_parity()
    return out


def flag_multistep_parity() -> dict:
    """The flag DDPM (tests/fixtures/flag_ddpm256.pt), 2 images of
    exp/datasets/natural256, x_T from RandomState(42), zero noise, 4x
    average-pooling SR, simplified multistep at 10 steps, fp32, through the
    kernels and the plain versions, against the JAX package's golden
    (tests/fixtures/flag_multistep_golden.json): each image within
    SOLVER_PSNR_TOL, the pooled output within POOL8_TOL, kernel against
    plain within 1e-3, launches exact."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.models import DDPMUNet
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.runner import load_checkpoint
    from ddnm_tpu_torch.sampling import build_schedule, sample_simplified

    golden = json.loads(FLAG_MS_GOLDEN.read_text())
    proto = golden["protocol"]
    n, res, steps = proto["n_images"], proto["res"], proto["t_sampling"]
    model = DDPMUNet(resolution=res)
    load_checkpoint(model, FLAG_PT)
    model = model.cuda().eval()
    n_gn, n_attn = module_counts(model)
    paths = sorted((REPO / proto["eval_dir"]).glob("*.png"))[:n]
    gt = torch.from_numpy(np.stack([load_image(p) for p in paths]) * 2.0 - 1.0).cuda()
    xt = np.random.RandomState(proto["x_T_seed"]).randn(n, 3, res, res).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1))).cuda()
    op = build_functional_operator(proto["deg"], image_size=res, deg_scale=proto["deg_scale"],
                                   device="cuda")
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    sched = build_schedule(betas=betas, t_sampling=steps)
    zero = lambda gens, shape: torch.zeros(shape, device="cuda")
    ref_pool = np.load(FLAG_MS_POOL8)
    to01 = lambda a: torch.clamp((a + 1) / 2, 0, 1)
    out, xs = {}, {}
    for mode in ("kernel", "torch"):
        set_op_force(model, None if mode == "kernel" else "torch")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        x, _ = sample_simplified(model, xt, op.A(gt), op, sched, [None] * n, noise_fn=zero,
                                 solver="multistep", loop=FP32_FULL_WIDTH_LOOP)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        psnrs = [float(10 * torch.log10(1 / ((to01(x[i]) - to01(gt[i])) ** 2).mean()))
                 for i in range(n)]
        pool = F.avg_pool2d(x.permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1).cpu().numpy()
        pool_err = float(np.abs(pool - ref_pool).max())
        out[mode] = {"psnr": psnrs, "pool8_max_abs_vs_golden": pool_err, "seconds": secs,
                     "launches": counts}
        xs[mode] = x
        print(f"flag multistep 10 fp32 {mode:6s}: PSNR {['%.4f' % p for p in psnrs]} (JAX "
              f"{golden['per_image_psnr']}), pool8 vs golden {pool_err:.2e}, {secs:.2f} s, "
              f"launches {counts}", flush=True)
        for p, g in zip(psnrs, golden["per_image_psnr"]):
            if not abs(p - g) <= SOLVER_PSNR_TOL:
                raise AssertionError(f"flag multistep {mode}: PSNR {p:.4f} vs JAX {g:.4f}")
        if not pool_err <= POOL8_TOL:
            raise AssertionError(f"flag multistep {mode}: pooled output vs golden {pool_err}")
    set_op_force(model, None)
    out["kernel_vs_torch_max_abs"] = float((xs["kernel"] - xs["torch"]).abs().max())
    if not out["kernel_vs_torch_max_abs"] <= 1e-3:
        raise AssertionError(f"flag multistep: kernel vs plain {out['kernel_vs_torch_max_abs']}")
    if out["kernel"]["launches"] != expected_launches(n_gn * steps, n_attn * steps):
        raise AssertionError(f"flag multistep launch counts {out['kernel']['launches']}")
    if any(out["torch"]["launches"].values()):
        raise AssertionError(f"flag multistep: plain run launched {out['torch']['launches']}")
    return out


def _inet256_unguided(respacing10: bool = False) -> str:
    """configs/hq/inet256.yml with classifier_scale 0 (the unguided
    configuration), and with respacing10 the multistep budget: respacing 10
    and no undo jumps (10 model calls a tile)."""
    conf = INET256.read_text()
    swaps = [("classifier_scale: 1.0", "classifier_scale: 0.0")]
    if respacing10:
        swaps += [('timestep_respacing: "100"', 'timestep_respacing: "10"'),
                  ("t_T: 100\n  n_sample: 1\n  jump_length: 10\n  jump_n_sample: 3",
                   "t_T: 10\n  n_sample: 1\n  jump_length: 1\n  jump_n_sample: 1")]
    for old, new in swaps:
        if conf.count(old) != 1:
            raise AssertionError(f"configs/hq/inet256.yml: expected one {old!r}")
        conf = conf.replace(old, new)
    return conf


def accel_full_width(counts: dict) -> tuple[dict, dict]:
    """Phase 16: the accelerators at full width, bf16, through the CLIs.

    `counts`: the module counts (GroupNorm, attention) of the forwards:
    "ddpm", "ddpm_decoder", "hq", "hq_decoder", "inet", "classifier".

    (a) main_torch on configs/celeba_hq.yml with flag_ddpm256.pt, simplified
    4x SR of the 8 images of exp/datasets/celeba_hq at batch 8: --solver
    multistep --t_sampling 10, --encoder_cache 3 --encoder_cache_policy
    end_dense at 100 steps, and the exact runs at 100 and at 10 steps (the
    regime split); PSNR, images/s in the sampler and end to end, max
    |A(x) - y|, launches exact.
    (b) hq_main_torch on configs/hq/inet256.yml, unguided, random weights
    from seed 1234, one 256 px tile (4x SR of a 64 x 64 PNG with
    --resize_y): --solver multistep on a respacing-10 config (10 calls) and
    --encoder_cache 3 on the default 280-call schedule; s per tile, model
    calls/s, decoder-only calls counted through the launches.
    (c) main_torch on configs/imagenet_256_cc.yml --solver multistep
    --t_sampling 10 --random_init (guided SVD multistep, batch 8), the
    classifier's zero-initialised layers drawn too, so that every
    GroupNorm and attention backward gets a non-zero dy (counted).
    (d) a tile-granular --resume round trip of the inet256 ADM (bf16) on a
    384 x 256 canvas (2 tiles, respacing 10, carry, zero noise): stopped by
    a progress hook after the first tile group, then resumed; the canvas
    equals the uninterrupted run's bit for bit.
    Returns (stats, launches by run)."""
    import hq_main_torch
    import main_torch
    import ddnm_tpu_torch.runner as runner_mod
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.config import load_config, load_hq_config
    from ddnm_tpu_torch.data.io import load_image, save_image
    from ddnm_tpu_torch.models import ADMClassifier
    from ddnm_tpu_torch.sampling import build_posterior_tables, build_schedule
    from ddnm_tpu_torch.sampling.accel import key_steps_for_policy, n_model_calls
    from ddnm_tpu_torch.tiling import mask_shift_sample

    stats, launches = {}, {}

    def want(name, steps_or_keys, cached=0):
        (g, a), (gd, ad) = counts[name], counts[name + "_decoder"]
        return expected_launches(g * steps_or_keys + gd * cached, a * steps_or_keys + ad * cached)

    # (a) the flag DDPM main path
    cfg = load_config(REPO / "configs" / "celeba_hq.yml")
    d, tt = cfg.diffusion, cfg.time_travel
    betas = sch.get_beta_schedule(d.beta_schedule, beta_start=d.beta_start,
                                  beta_end=d.beta_end,
                                  num_diffusion_timesteps=d.num_diffusion_timesteps)
    sched = build_schedule(betas=betas, t_sampling=tt.T_sampling,
                           travel_length=tt.travel_length, travel_repeat=tt.travel_repeat)
    ec_keys, ec_cached = key_step_counts(
        sched.is_travel, 3, key_steps_for_policy(n_model_calls(sched), 3, "end_dense"))
    runs = {"multistep_10": (["--solver", "multistep", "--t_sampling", "10"], want("ddpm", 10)),
            "encoder_cache_3_end_dense": (["--encoder_cache", "3", "--encoder_cache_policy",
                                           "end_dense"], want("ddpm", ec_keys, ec_cached)),
            "exact_100": ([], want("ddpm", 100)),
            # the reference update at the multistep budget: the regime split
            "exact_10": (["--t_sampling", "10"], want("ddpm", 10))}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (flags, expect) in runs.items():
            ops.reset_launch_counts()
            r = main_torch.main([
                "--config", str(REPO / "configs" / "celeba_hq.yml"), "--ckpt", str(FLAG_PT),
                "--exp", str(REPO / "exp"), "--path_y", "celeba_hq", "--deg",
                "sr_averagepooling", "--deg_scale", "4", "--sigma_y", "0", "--simplified",
                "--dtype", "bfloat16", "--batch_size", "8", "-i", str(Path(tmp) / name), "--ni",
                "--verbose", "warning", *flags])
            launches[name] = ops.launch_counts()
            n_png = len(list((Path(tmp) / name).glob("*_0.png")))
            r = dict(r, sampler_images_per_second=r["num_samples"] / r["sample_seconds"])
            stats[name] = r
            print(f"flag main path {name:26s}: PSNR {r['avg_psnr']:.4f}, "
                  f"{r['sampler_images_per_second']:.4f} images/s in the sampler "
                  f"({r['sample_seconds']:.2f} s), {r['images_per_second']:.4f} end to end; "
                  f"max |A(x) - y| {r['range_space_max_abs']:.3e}; launches "
                  f"{launches[name]}", flush=True)
            print(overlap_gap_line(f"flag {name}", r), flush=True)
            if r["num_samples"] != 8 or n_png != 8 or not np.isfinite(r["avg_psnr"]):
                raise AssertionError(f"{name}: {r['num_samples']} images ({n_png} PNGs), "
                                     f"PSNR {r['avg_psnr']}")
            if not r["range_space_max_abs"] <= RANGE_SPACE_TOL:
                raise AssertionError(f"{name}: max |A(x) - y| {r['range_space_max_abs']}")
            if launches[name] != expect:
                raise AssertionError(f"{name}: launch counts {launches[name]} != {expect}")
    stats["encoder_cache_3_end_dense"].update(key_calls=ec_keys, decoder_only_calls=ec_cached)
    rate = {k: stats[k]["sampler_images_per_second"] for k in runs}
    print(f"flag main path, sampler images/s against the exact 100-step run: multistep 10 "
          f"{rate['multistep_10'] / rate['exact_100']:.2f}x, the encoder cache "
          f"{rate['encoder_cache_3_end_dense'] / rate['exact_100']:.2f}x ({ec_keys} full and "
          f"{ec_cached} decoder-only calls); PSNR multistep 10 "
          f"{stats['multistep_10']['avg_psnr'] - stats['exact_10']['avg_psnr']:+.2f} dB "
          f"against the reference update at 10 steps, "
          f"{stats['multistep_10']['avg_psnr'] - stats['exact_100']['avg_psnr']:+.2f} dB "
          f"against it at 100", flush=True)

    # (b) one inet256 hq tile
    img = load_image(REPO / "exp" / "datasets" / "imagenet" / "00000.png")
    small = img[:256, :256].reshape(64, 4, 64, 4, 3).mean(axis=(1, 3))
    hq_cfg = load_hq_config(INET256)
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=str(hq_cfg.timestep_respacing),
        schedule_jump_params=dict(hq_cfg.schedule_jump_params))
    hq_keys, hq_cached = key_step_counts(tables.is_travel, 3, None)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_image(small, tmp / "y64.png")
        (tmp / "unguided.yml").write_text(_inet256_unguided())
        (tmp / "unguided_r10.yml").write_text(_inet256_unguided(respacing10=True))
        hq_runs = {"hq_multistep_10": ("unguided_r10.yml", ["--solver", "multistep"],
                                       want("hq", 10), 10),
                   "hq_encoder_cache_3": ("unguided.yml", ["--encoder_cache", "3"],
                                          want("hq", hq_keys, hq_cached), hq_keys + hq_cached)}
        for name, (conf, flags, expect, calls) in hq_runs.items():
            ops.reset_launch_counts()
            out = hq_main_torch.main([
                "--config", str(tmp / conf), "--path_y", str(tmp / "y64.png"), "--deg",
                "sr_averagepooling", "--scale", "4", "--resize_y", "--class", "0",
                "--random_init", "--seed", "1234", "--dtype", "bfloat16",
                "-i", str(tmp / name), *flags])
            launches[name] = ops.launch_counts()
            s = dict(out["stats"])
            s["range_space_max_abs"] = float(np.abs(
                out["final"].reshape(1, 64, 4, 64, 4, 3).mean(axis=(2, 4)) - out["y"]).max())
            if name == "hq_encoder_cache_3":
                s.update(key_calls=hq_keys, decoder_only_calls=hq_cached)
            stats[name] = s
            print(f"{name:19s} (inet256 ADM, bf16, one 256 px tile): {s['seconds_per_tile']:.2f} "
                  f"s per tile, {s['model_calls_per_second']:.2f} model calls/s "
                  f"({s['model_calls']} calls"
                  + (f": {hq_keys} full, {hq_cached} decoder-only" if "encoder" in name else "")
                  + f"); max |A(final) - y| {s['range_space_max_abs']:.3e}; launches "
                  f"{launches[name]}", flush=True)
            if (out["final"].shape != (1, 256, 256, 3) or not np.isfinite(out["final"]).all()
                    or s["model_calls"] != calls):
                raise AssertionError(f"{name}: shape {out['final'].shape}, {s['model_calls']} "
                                     f"calls (expected {calls})")
            if not s["range_space_max_abs"] <= 1e-4:
                raise AssertionError(f"{name}: max |A(final) - y| {s['range_space_max_abs']}")
            if launches[name] != expect:
                raise AssertionError(f"{name}: launch counts {launches[name]} != {expect}")

    # (c) the guided ImageNet-cc row with the multistep solver
    real_init = runner_mod.init_like_flax

    def draw_every_layer(model, seed):
        if isinstance(model, ADMClassifier):
            model.zero_init = ()
        return real_init(model, seed)

    steps = 10
    (g_c, a_c) = counts["classifier"]
    (g_i, a_i) = counts["inet"]
    runner_mod.init_like_flax = draw_every_layer
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ops.reset_launch_counts()
            box = {}
            # the census reads each backward's dy on the host, which a CUDA
            # graph cannot hold: this run takes the host loop
            census = backward_dy_census(lambda: box.setdefault("r", main_torch.main([
                "--config", str(IMAGENET_CC_CONFIG), "--random_init", "--exp",
                str(REPO / "exp"), "--path_y", "imagenet", "--deg", "sr_averagepooling",
                "--deg_scale", "4", "--sigma_y", "0", "--dtype", "bfloat16", "--batch_size",
                "8", "--solver", "multistep", "--t_sampling", str(steps), "--loop", "host",
                "-i", str(Path(tmp) / "cc"), "--ni", "--verbose", "warning"])))
            launches["guided_cc_multistep_10"] = ops.launch_counts()
            n_png = len(list((Path(tmp) / "cc").glob("*_0.png")))
    finally:
        runner_mod.init_like_flax = real_init
    cc = dict(box["r"], sampler_images_per_second=box["r"]["num_samples"]
              / box["r"]["sample_seconds"], nonzero_dy=census)
    stats["guided_cc_multistep_10"] = cc
    cc_want = expected_launches((g_i + g_c) * steps, (a_i + a_c) * steps, g_c * steps,
                                a_c * steps)
    print(f"guided ImageNet-cc multistep 10 (imagenet_256_cc, bf16, batch 8): "
          f"{cc['num_samples']} images, {cc['sampler_images_per_second']:.4f} images/s in the "
          f"sampler ({cc['sample_seconds']:.2f} s), {cc['images_per_second']:.4f} end to end; "
          f"max |A(x) - y| {cc['range_space_max_abs']:.3e}; backward calls with non-zero dy "
          f"{census}; launches {launches['guided_cc_multistep_10']}", flush=True)
    if cc["num_samples"] != 8 or n_png != 8 or not np.isfinite(cc["avg_psnr"]):
        raise AssertionError(f"guided cc multistep: {cc['num_samples']} images ({n_png} PNGs)")
    if not cc["range_space_max_abs"] <= RANGE_SPACE_TOL:
        raise AssertionError(f"guided cc multistep: max |A(x) - y| {cc['range_space_max_abs']}")
    if launches["guided_cc_multistep_10"] != cc_want:
        raise AssertionError(f"guided cc multistep launches "
                             f"{launches['guided_cc_multistep_10']} != {cc_want}")
    if census != {"groupnorm": [g_c * steps] * 2, "attention": [a_c * steps] * 2}:
        raise AssertionError(f"guided cc multistep: non-zero dy in {census}")

    # (d) the hq resume round trip on the card
    quads = [load_image(REPO / "exp" / "datasets" / "imagenet" / f"0000{i}.png")[32:224]
             for i in range(2)]
    gt = (np.concatenate(quads, axis=0) * 2.0 - 1.0)[None]  # (1, 384, 256, 3)
    model = hq_adm()
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True), timestep_respacing="10",
        schedule_jump_params=dict(t_T=10, n_sample=1, jump_length=1, jump_n_sample=1))
    label = torch.zeros(1, dtype=torch.long, device="cuda")
    zero = lambda gens, shape: torch.zeros(shape, device="cuda")

    class Stop(Exception):
        pass

    def run(ckpt=None, resume=False, stop=False):
        seen = []

        def progress(t, x0):
            if stop and seen:
                raise Stop
            seen.append(t.index)

        out = mask_shift_sample(lambda z, s: model(z, s, label.expand(len(z))), gt,
                                "sr_averagepooling", tables, 1234, scale=4, noise_fn=zero,
                                tile_init="carry", device="cuda", checkpoint_dir=ckpt,
                                resume=resume, progress_fn=progress)
        return out, seen

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full, _ = run()
        try:
            run(ckpt=tmp, stop=True)
            raise AssertionError("resume round trip: the progress hook did not stop the run")
        except Stop:
            pass
        state = Path(tmp) / "mask_shift_state.npz"
        saved = state.exists()
        resumed, seen = run(ckpt=tmp, resume=True)
        left = state.exists()
        secs = time.perf_counter() - t0
    equal = bool(np.array_equal(resumed["final"], full["final"]))
    stats["hq_resume"] = {"state_written": saved, "tiles_after_resume": len(seen),
                          "bit_equal": equal, "state_left": left, "seconds": secs}
    print(f"hq resume round trip (inet256 ADM, bf16, 384 x 256, 2 tiles, carry): state "
          f"written {saved}, {len(seen)} tile(s) run after the resume, canvas equal to the "
          f"uninterrupted run bit for bit: {equal}; {secs:.2f} s", flush=True)
    if not (saved and seen == [(1, 0)] and equal and not left):
        raise AssertionError(f"hq resume round trip: {stats['hq_resume']}, tiles {seen}")
    del model
    torch.cuda.empty_cache()
    return stats, launches


# ------------------------------------------------------------ phases 17 and 18

SERVED_FLAGS = ["--config", str(REPO / "configs" / "celeba_hq.yml"), "--ckpt", str(FLAG_PT),
                "--dtype", "bfloat16", "--max_batch", "8", "--seed", "1234", "--device", "cuda"]


def http_post(url: str, body: bytes, timeout: float = 600.0) -> tuple[int, bytes, dict]:
    """(status, body, headers) of a POST, an HTTP error's included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers={"Content-Type": "image/png"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def http_json(url: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def concurrent_posts(calls: list, stagger: dict | None = None) -> list:
    """Send every (url, body) of `calls` from its own thread; `stagger`
    maps a call's index to seconds to wait before sending. Returns the
    replies in call order."""
    import threading

    out = [None] * len(calls)

    def send(i, url, body):
        time.sleep((stagger or {}).get(i, 0.0))
        out[i] = http_post(url, body)

    threads = [threading.Thread(target=send, args=(i, *c)) for i, c in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def to_u8(img01) -> np.ndarray:
    """[0, 1] floats -> uint8 as the server's replies quantise."""
    return np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) / 255 - b.astype(np.float64) / 255) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


def serve_load(service, calls: list, stagger: dict | None = None,
               max_wait_ms: float = 200.0) -> dict:
    """`calls` (url suffix, body) sent concurrently to a RestorationServer
    over `service` on 127.0.0.1, port 0; the launch counts set to 0 just
    before and read just after. Returns replies, wall seconds, /healthz,
    launches."""
    from ddnm_tpu_torch.server import RestorationServer

    server = RestorationServer(service, max_wait_ms=max_wait_ms, queue_size=64)
    server.start()
    host, port = server.address
    base = f"http://{host}:{port}"
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        replies = concurrent_posts([(base + u, b) for u, b in calls], stagger)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        health = http_json(base + "/healthz")
    finally:
        server.stop()
    return dict(replies=replies, wall=wall, health=health, launches=launches)


def served_main_path(n_gn: int, n_attn: int) -> tuple[dict, dict]:
    """Phase 17: the served main path at full width, through
    serve_torch.build_service and RestorationServer on 127.0.0.1: the flag
    DDPM of configs/celeba_hq.yml (flag_ddpm256.pt), bf16 torso, max_batch
    8, 100 steps. One service serves --degs sr_averagepooling,inpainting at
    --deg_scale 4 (inpainting with no --mask_path: every request uploads an
    RGBA keep-mask), a second --svd_degs cs_walshhadamard at --deg_scale
    0.25 (serve.py's one --deg_scale cannot serve 4x SR and 25% CS in one
    service: 4 makes CS divide by round(1/4) = 0, 0.25 pools by 0). 16
    concurrent 4x SR requests of the 8 images of exp/datasets/celeba_hq (each
    image twice), 4 RGBA inpainting requests half a second later, then 2
    cs_walshhadamard requests. Holds: every reply 200 and 256 x 256 x 3; one
    coalesced SR reply byte-equal to the same request restored alone, and
    the last lane of a direct group of 8 too (batch-composition invariance;
    cuDNN reduces that lane in other splits at some shapes, which the
    service's lane-pinned convolutions undo); mean_batch > 1; the GroupNorm,
    attention and Walsh-Hadamard launches exactly what the served groups
    give. Returns (stats, launches of both loads)."""
    import serve_torch
    from ddnm_tpu_torch.data.datasets import FolderDataset
    from ddnm_tpu_torch.data.io import decode_png, encode_png

    svc = serve_torch.build_service(serve_torch.parse_args(
        SERVED_FLAGS + ["--degs", "sr_averagepooling,inpainting", "--deg_scale", "4"]))
    svc_cs = serve_torch.build_service(serve_torch.parse_args(
        SERVED_FLAGS + ["--degs", "", "--svd_degs", "cs_walshhadamard", "--deg_scale", "0.25"]))
    if not (svc.requires_ctx("inpainting") and svc.ctx_tasks == ("inpainting",)):
        raise AssertionError("inpainting without --mask_path must require a per-request mask")
    t0 = time.perf_counter()
    svc.warmup()
    svc_cs.warmup()
    warm = time.perf_counter() - t0
    ds = FolderDataset(REPO / "exp" / "datasets" / "celeba_hq", 256)
    gts = [to_u8(ds[i][0]) for i in range(len(ds))]
    rng = np.random.default_rng(17)
    alphas = []
    for _ in range(4):  # a 64 x 96 hole at a random place in each keep-mask
        a = np.full((256, 256, 1), 255, np.uint8)
        r, c = (int(v) for v in rng.integers(32, 160, 2))
        a[r:r + 64, c:c + 96] = 0
        alphas.append(a)
    calls = [("/restore?deg=sr_averagepooling&input=gt", encode_png(gts[i % 8]))
             for i in range(16)]
    calls += [("/restore?deg=inpainting&input=gt",
               encode_png(np.concatenate([gts[k], alphas[k]], axis=-1))) for k in range(4)]
    load = serve_load(svc, calls, stagger={i: 0.5 for i in range(16, 20)})
    load_cs = serve_load(svc_cs, [("/restore?deg=cs_walshhadamard&input=gt",
                                   encode_png(gts[k])) for k in range(2)])
    replies = load["replies"] + load_cs["replies"]
    if [r[0] for r in replies] != [200] * 22:
        raise AssertionError(f"served replies: {[(r[0], r[1][:200]) for r in replies]}")
    outs = [decode_png(r[1]) for r in replies]
    if any(o.shape != (256, 256, 3) for o in outs):
        raise AssertionError(f"served shapes: {[o.shape for o in outs]}")
    tasks = {"sr_averagepooling": range(16), "inpainting": range(16, 20),
             "cs_walshhadamard": range(20, 22)}
    gt_of = [i % 8 for i in range(16)] + list(range(4)) + list(range(2))
    psnr = {t: float(np.mean([psnr_u8(outs[i], gts[gt_of[i]]) for i in idx]))
            for t, idx in tasks.items()}
    # batch-composition invariance: a reply of the largest served group
    # (8 when the requests arrive within max_wait_ms) against the same
    # request (its image, its sequence number) restored alone
    i = max(range(16), key=lambda k: int(replies[k][2]["X-Batch-Size"]))
    if int(replies[i][2]["X-Batch-Size"]) < 2:
        raise AssertionError("no SR request was coalesced with another")
    seq = int(replies[i][2]["X-Seq"])
    alone = svc.restore(gts[gt_of[i]][None].astype(np.float32) / 255.0,
                        "sr_averagepooling", [seq], input_kind="gt")
    alone_equal = encode_png(to_u8(alone[0])) == replies[i][1]
    # the last lane of a full group, where cuDNN's split reductions land
    group = svc.restore(np.stack(gts).astype(np.float32) / 255.0, "sr_averagepooling",
                        list(range(100, 108)), input_kind="gt")
    last = svc.restore(gts[7][None].astype(np.float32) / 255.0, "sr_averagepooling", [107],
                       input_kind="gt")
    last_lane_equal = encode_png(to_u8(group[7])) == encode_png(to_u8(last[0]))
    h, h_cs = load["health"], load_cs["health"]
    want = expected_launches(n_gn * 100 * h["batches"], n_attn * 100 * h["batches"])
    want_cs = expected_launches(n_gn * 100 * h_cs["batches"], n_attn * 100 * h_cs["batches"],
                                fwht=h_cs["batches"] * fwht_launches("cs_walshhadamard", 0.0,
                                                                     100))
    stats = {
        "requests": 22, "wall_seconds": load["wall"], "wall_seconds_cs": load_cs["wall"],
        "requests_per_second": 20 / load["wall"],
        "requests_per_second_cs": 2 / load_cs["wall"],
        "images_per_second_served": 22 / (load["wall"] + load_cs["wall"]),
        "warmup_seconds": warm, "batches": h["batches"], "batches_cs": h_cs["batches"],
        "mean_batch": h["mean_batch"], "mean_batch_cs": h_cs["mean_batch"],
        "latency_s": h.get("latency_s"), "latency_s_cs": h_cs.get("latency_s"),
        "psnr": psnr, "alone_vs_coalesced_byte_equal": alone_equal, "seq_checked": seq,
        "last_lane_vs_alone_byte_equal": last_lane_equal,
        "launches_per_group": {"sr_or_inpainting": {k: v / h["batches"]
                                                    for k, v in load["launches"].items()},
                               "cs_walshhadamard": {k: v / h_cs["batches"]
                                                    for k, v in load_cs["launches"].items()}},
    }
    print(f"served main path (flag DDPM, bf16, max_batch 8, 100 steps): 20 requests "
          f"(16 SR, 4 RGBA inpainting) in {load['wall']:.2f} s, "
          f"{stats['requests_per_second']:.4f} requests/s (images/s), {h['batches']} groups, "
          f"mean_batch {h['mean_batch']:.3f}, latency_s {h.get('latency_s')}; 2 CS requests "
          f"in {load_cs['wall']:.2f} s ({h_cs['batches']} group), latency_s "
          f"{h_cs.get('latency_s')}; {stats['images_per_second_served']:.4f} images/s served "
          f"in all; warm-up {warm:.2f} s", flush=True)
    print(f"served PSNR against ground truth: {psnr}; reply seq {seq} (a group of "
          f"{replies[i][2]['X-Batch-Size']}) "
          f"byte-equal alone: {alone_equal}; lane 7 of a direct group of 8 byte-equal "
          f"alone: {last_lane_equal}; launches {load['launches']} and (CS) "
          f"{load_cs['launches']}", flush=True)
    if not alone_equal:
        raise AssertionError(f"seq {seq}: the coalesced reply differs from the alone restore")
    if not last_lane_equal:
        raise AssertionError("lane 7 of a group of 8 differs from the same request alone")
    if not h["mean_batch"] > 1:
        raise AssertionError(f"mean_batch {h['mean_batch']} <= 1: nothing coalesced")
    if load["launches"] != want or load_cs["launches"] != want_cs:
        raise AssertionError(f"served launches {load['launches']} / {load_cs['launches']} != "
                             f"{want} / {want_cs}")
    if not (psnr["sr_averagepooling"] > 20 and psnr["inpainting"] > 14
            and np.isfinite(psnr["cs_walshhadamard"])):
        raise AssertionError(f"served PSNR {psnr} is not a restoration")
    launches = {k: load["launches"][k] + load_cs["launches"][k] for k in load["launches"]}
    del svc, svc_cs
    torch.cuda.empty_cache()
    return stats, launches


def guidance_bits_probe(clf, deterministic: bool) -> bool:
    """The toy32 classifier's guidance gradient (fp32, batch 2) gives the
    same bits on two calls, with cudnn.deterministic as given."""
    from ddnm_tpu_torch.models import classifier_guidance_fn

    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((2, 32, 32, 3), generator=gen, device="cuda")
        t = torch.tensor([400.0, 600.0], device="cuda")
        g = classifier_guidance_fn(clf, torch.tensor([1, 3], device="cuda"), 2.0)
        return bool(torch.equal(g(x, t), g(x, t)))
    finally:
        torch.backends.cudnn.deterministic = old


def served_hq_path(n_gn_hq: int, n_attn_hq: int, n_gn_clf: int, n_attn_clf: int
                   ) -> tuple[dict, dict]:
    """Phase 18: the hq service. (a) A class-conditional, guided
    PosteriorRestorationService on the toy32 ADM (toy_adm32.pt, whose
    forward takes no label) guided by the toy32 classifier (toy_clf32.pt,
    4 classes, scale 2.0) toward each request's ?class=N, fp32, the golden
    schedule (respacing 25 with jumps), max_batch 1: each of 2 HTTP replies
    equals, as uint8, the port's direct sample_posterior call on the same
    generators and label, with cudnn.deterministic on as
    serve_torch.build_hq_service sets it for a guided service: the guidance
    gradient's bits on two calls are held equal with it on and printed with
    it off (cuDNN's default backward-data algorithms are not deterministic
    on the card). (b) serve_torch.build_hq_service
    on configs/hq/inet256.yml, random weights from seed 1234, bf16, guided
    (classifier_scale 1.0), max_batch 2: 2 concurrent 4x SR requests of
    exp/datasets/imagenet with ?class=207 and ?class=951; s per served
    group, max |A(reply) - y| in [0, 1] (quantised, clamped replies) and
    every kernel's launches, forward and backward, exactly 280 model calls'
    of each group. Returns (stats, launches of (b))."""
    import serve_torch
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import decode_png, encode_png, load_image
    from ddnm_tpu_torch.models import classifier_guidance_fn
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.sampling.posterior import (
        build_posterior_tables,
        n_model_calls,
        sample_posterior,
    )
    from ddnm_tpu_torch.sampling.rng import (
        STREAM_INIT,
        STREAM_SAMPLE,
        default_noise,
        image_generators,
    )
    from ddnm_tpu_torch.server import PosteriorRestorationService

    stats = {}
    deterministic = torch.backends.cudnn.deterministic
    # (a) toy32, fp32
    model, clf = toy_adm("cuda"), toy_classifier("cuda")
    bits = {"cudnn.deterministic off": guidance_bits_probe(clf, False),
            "cudnn.deterministic on": guidance_bits_probe(clf, True)}
    torch.backends.cudnn.deterministic = True
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=HQ_RESPACING, schedule_jump_params=HQ_JUMP)
    op = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0,
                                   device="cuda")

    def guidance(p, x, t, at=None):
        return classifier_guidance_fn(p["classifier"], p["classes"], 2.0)(x, t, at)

    svc = PosteriorRestorationService(
        lambda p, x, t: p["model"](x, t), {"model": model, "classifier": clf}, tables,
        {"sr_averagepooling": op}, image_size=32, max_batch=1, base_seed=1234,
        guidance_fn=guidance, class_cond=True, num_classes=4)
    paths = sorted((REPO / "exp" / "datasets" / "toy32").glob("*.png"))[:2]
    gts = [to_u8(load_image(p)) for p in paths]
    labels = (1, 3)
    load = serve_load(svc, [(f"/restore?deg=sr_averagepooling&input=gt&class={c}",
                             encode_png(g)) for g, c in zip(gts, labels)])
    if [r[0] for r in load["replies"]] != [200, 200]:
        raise AssertionError(f"toy32 hq replies: {[(r[0], r[1][:200]) for r in load['replies']]}")
    equal = []
    for (status, body, headers), g, c in zip(load["replies"], gts, labels):
        seq = int(headers["X-Seq"])
        x01 = torch.from_numpy(g.astype(np.float32) / 255.0)[None].cuda()
        y = op.A(2.0 * x01 - 1.0)
        x_init = default_noise(image_generators(1234, [seq], STREAM_INIT, "cuda"), (1, 32, 32, 3))
        gens = image_generators(1234, [seq], STREAM_SAMPLE, "cuda")
        x, _ = sample_posterior(
            lambda z, s: model(z, s), x_init, op.Ap(y), op, tables, gens,
            guidance_fn=classifier_guidance_fn(clf, torch.tensor([c], device="cuda"), 2.0))
        direct = to_u8(torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)[0].cpu().numpy())
        equal.append(bool(np.array_equal(decode_png(body), direct)))
    stats["toy32"] = {"reply_equals_direct": equal, "wall_seconds": load["wall"],
                      "latency_s": load["health"].get("latency_s"),
                      "guidance_same_bits_twice": bits}
    print(f"hq service toy32 (fp32, guided, classes {labels}): replies equal the direct "
          f"sample_posterior call: {equal}; {load['wall']:.2f} s; guidance gradient same "
          f"bits on two calls: {bits}", flush=True)
    if not (all(equal) and bits["cudnn.deterministic on"]):
        raise AssertionError(f"toy32 hq service replies against the direct call {equal}, "
                             f"guidance bits {bits}")
    del svc, model, clf

    # (b) inet256, bf16, guided, random weights
    ns = serve_torch.parse_args([
        "--hq_conf", str(INET256), "--random_init", "--seed", "1234", "--dtype", "bfloat16",
        "--max_batch", "2", "--degs", "sr_averagepooling", "--device", "cuda"])
    t0 = time.perf_counter()
    svc = serve_torch.build_hq_service(ns)
    build_s = time.perf_counter() - t0
    calls = n_model_calls(svc._tables)
    imgs = [to_u8(load_image(REPO / "exp" / "datasets" / "imagenet" / f"0000{k}.png", 256))
            for k in range(2)]
    classes = (207, 951)
    load = serve_load(svc, [(f"/restore?deg=sr_averagepooling&input=gt&class={c}",
                             encode_png(g)) for g, c in zip(imgs, classes)])
    if [r[0] for r in load["replies"]] != [200, 200]:
        raise AssertionError(f"inet256 hq replies: {[(r[0], r[1][:200]) for r in load['replies']]}")
    outs = [decode_png(r[1]).astype(np.float64) / 255 for r in load["replies"]]
    pool = lambda a: a.reshape(64, 4, 64, 4, 3).mean(axis=(1, 3))
    range_err = max(float(np.abs(pool(o) - pool(g.astype(np.float64) / 255)).max())
                    for o, g in zip(outs, imgs))
    groups = load["health"]["batches"]
    want = expected_launches((n_gn_hq + n_gn_clf) * calls * groups,
                             (n_attn_hq + n_attn_clf) * calls * groups,
                             n_gn_clf * calls * groups, n_attn_clf * calls * groups)
    stats["inet256"] = {"build_seconds": build_s, "wall_seconds": load["wall"],
                        "groups": groups, "seconds_per_group": load["wall"] / groups,
                        "model_calls_per_group": calls, "mean_batch": load["health"]["mean_batch"],
                        "latency_s": load["health"].get("latency_s"),
                        "range_space_max_abs_01": range_err, "launches": load["launches"]}
    print(f"hq service inet256 (bf16, guided, random weights, classes {classes}): "
          f"{groups} group(s) of {calls} model calls, {load['wall'] / groups:.2f} s per served "
          f"group, mean_batch {load['health']['mean_batch']}, latency_s "
          f"{load['health'].get('latency_s')}; max |A(reply) - y| (uint8 replies in [0, 1]) "
          f"{range_err:.3e}; launches {load['launches']}", flush=True)
    if any(o.shape != (256, 256, 3) or not np.isfinite(o).all() for o in outs):
        raise AssertionError("inet256 hq service: replies not 256 x 256 x 3")
    if load["launches"] != want:
        raise AssertionError(f"inet256 hq service launches {load['launches']} != {want}")
    if not torch.backends.cudnn.deterministic:
        raise AssertionError("a guided hq service must run with cudnn.deterministic on")
    torch.backends.cudnn.deterministic = deterministic
    del svc
    torch.cuda.empty_cache()
    return stats, load["launches"]


# ------------------------------------------------------------------ phase 19

JPEG_ORACLE = REPO / "tests" / "fixtures" / "jpeg_pil_decode.npz"
FACE256 = REPO / "configs" / "hq" / "face256.yml"
# the face sweep's depth cut: 50 respaced steps with jumps of 5 resampled
# twice, 95 model calls a tile (the config's 250 / 10 / 10 make 2410)
FACE_CUT = ('timestep_respacing: "50"', "t_T: 50", "jump_length: 5", "jump_n_sample: 2")


def jpeg_decode_check() -> dict:
    """Phase 19 (a): every committed JPEG fixture through the port's reader
    against PIL's decode committed beside it (tools/make_torch_jpeg_fixtures.py):
    max |diff| <= 1 uint8 level, the count of pixels that differ; the
    decode's ms per image on this host at 256 x 256 (celeba_hq_jpeg, 4:2:0)
    and 500 x 375 (imagenet_jpeg), against the PNG reader's ms on the PNGs
    of celeba_hq (best of 3 rounds each)."""
    from ddnm_tpu_torch.data.io import decode_png, read_rgb8

    oracle = np.load(JPEG_ORACLE)
    rows = {}
    for key in oracle.files:
        ours = read_rgb8(REPO / key)
        ref = decode_png(bytes(oracle[key]))
        if ours.shape != ref.shape:
            raise AssertionError(f"{key}: decoded {ours.shape}, PIL {ref.shape}")
        diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
        rows[key] = dict(shape=list(ours.shape), max_abs=int(diff.max()),
                         pixels_differ=int((diff.max(axis=-1) > 0).sum()))
        print(f"jpeg {key}: {ours.shape[1]} x {ours.shape[0]}, max |diff| against PIL "
              f"{rows[key]['max_abs']}, pixels that differ {rows[key]['pixels_differ']}",
              flush=True)
        if diff.max() > 1:
            raise AssertionError(f"{key}: the JPEG decode is {diff.max()} levels from PIL's")

    def ms_per_image(paths) -> float:
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            for p in paths:
                read_rgb8(p)
            best = min(best, (time.perf_counter() - t0) / len(paths))
        return 1e3 * best

    ds = REPO / "exp" / "datasets"
    timing = {"jpeg_256x256_ms": ms_per_image(sorted((ds / "celeba_hq_jpeg").glob("*.jpg"))),
              "jpeg_500x375_ms": ms_per_image(sorted((ds / "imagenet_jpeg").glob("*.jpg"))),
              "png_256x256_ms": ms_per_image(sorted((ds / "celeba_hq").glob("*.png")))}
    print("decode ms per image on the host (best of 3): " + json.dumps(timing), flush=True)
    return dict(files=rows, **timing)


FORMATS_ORACLE = REPO / "tests" / "fixtures" / "formats_pil_decode.npz"


def format_decode_check() -> dict:
    """Phase 19 (a): every image-format fixture (tools/make_torch_format_fixtures.py)
    through the port's `decode_image` against PIL's mode and decode committed
    beside it (its RGBA or RGB pixels, or their SHA-256): byte-equal, JPEG
    within one level; then ms per 256 x 256 image of celeba_hq_mixed by
    format on this host (best of 3 rounds)."""
    import hashlib

    from ddnm_tpu_torch.data.io import convert, decode_image, decode_png, has_alpha

    oracle = np.load(FORMATS_ORACLE)
    keys = sorted({k.split("|")[0] for k in oracle.files})
    rows = {}
    for key in keys:
        arr, mode = decode_image((REPO / key).read_bytes(), key)
        want_mode = bytes(oracle[f"{key}|mode"]).decode()
        if mode != want_mode:
            raise AssertionError(f"{key}: mode {mode}, PIL {want_mode}")
        ours = convert(arr, mode, "RGBA" if has_alpha(mode) else "RGB")
        if f"{key}|sha256" in oracle.files:
            if (list(ours.shape) != oracle[f"{key}|shape"].tolist()
                    or hashlib.sha256(ours.tobytes()).digest() != bytes(oracle[f"{key}|sha256"])):
                raise AssertionError(f"{key}: pixels differ from PIL's (SHA-256)")
            worst = 0
        else:
            ref = decode_png(bytes(oracle[f"{key}|png"]))
            if ours.shape != ref.shape:
                raise AssertionError(f"{key}: decoded {ours.shape}, PIL {ref.shape}")
            worst = int(np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max())
        gate = 1 if key.endswith(".jpg") else 0
        rows[key] = dict(mode=mode, shape=list(ours.shape), max_abs=worst)
        print(f"format {key}: mode {mode}, {ours.shape[1]} x {ours.shape[0]}, max |diff| "
              f"against PIL {worst} (gate {gate})", flush=True)
        if worst > gate:
            raise AssertionError(f"{key}: {worst} levels from PIL's decode (gate {gate})")
    mixed = REPO / "exp" / "datasets" / "celeba_hq_mixed"
    kinds = {}
    for path in sorted(mixed.iterdir()):
        data = path.read_bytes()
        mode = decode_image(data, path.name)[1]
        if path.suffix == ".webp":
            kind = "webp_lossless" if data[12:16] == b"VP8L" else "webp_lossy"
        elif path.suffix == ".jpg":
            kind = "jpeg_cmyk" if mode == "CMYK" else "jpeg_progressive"
        else:
            kind = f"{path.suffix[1:]}_{mode.lower()}"
        kinds.setdefault(kind, []).append(data)
    timing = {}
    for kind, blobs in sorted(kinds.items()):
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            for data in blobs:
                decode_image(data)
            best = min(best, (time.perf_counter() - t0) / len(blobs))
        timing[f"{kind}_256x256_ms"] = 1e3 * best
    print("format decode ms per 256 x 256 image on the host (best of 3): "
          + json.dumps(timing), flush=True)
    return dict(files=rows, **timing)


def face_sweep_path(n_gn: int, n_attn: int) -> tuple[dict, dict]:
    """Phase 19 (c): hq_evaluation_torch.py --face_sweep at full width: the
    face256 ADM of configs/hq/face256.yml (128 channels, its channel_mult,
    random weights from seed 1234, bf16 torso) with the depth cut FACE_CUT
    (a temporary copy of the config), inpainting the 2 JPEG gts of
    exp/datasets/face_jpeg/gts (320 x 288: the pair loader crops them to
    256) under exp/datasets/face/gt_keep_masks (paired by position: the
    names differ by suffix), --sweep_batch 2. Checks the outputs, max
    |A(x) - y| on the written images (at most one level) and every kernel's
    launch count exactly. Returns (stats, launches)."""
    import hq_evaluation_torch
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.data.io import read_rgb8
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, n_model_calls
    from ddnm_tpu_torch.schedules import named_beta_schedule

    conf = FACE256.read_text()
    for old, new in zip(('timestep_respacing: "250"', "t_T: 250", "jump_length: 10",
                         "jump_n_sample: 10"), FACE_CUT):
        if conf.count(old) != 1:
            raise AssertionError(f"configs/hq/face256.yml: expected one {old!r}")
        conf = conf.replace(old, new)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "face256_cut.yml").write_text(conf)
        hq = load_hq_config(tmp / "face256_cut.yml")
        calls = n_model_calls(build_posterior_tables(
            betas=named_beta_schedule("linear", int(hq.diffusion_steps), use_scale=True),
            timestep_respacing=str(hq.timestep_respacing),
            schedule_jump_params=dict(hq.schedule_jump_params)))
        print(f"face sweep depth cut: {', '.join(FACE_CUT)}: {calls} model calls a tile "
              f"(configs/hq/face256.yml: 2410)", flush=True)
        ops.reset_launch_counts()
        out = hq_evaluation_torch.main([
            "--face_sweep", "--random-init", "--dtype", "bfloat16", "--max_len", "2",
            "--sweep_batch", "2", "--face_config", str(tmp / "face256_cut.yml"),
            "--face_gt", str(REPO / "exp" / "datasets" / "face_jpeg" / "gts"),
            "--face_masks", str(REPO / "exp" / "datasets" / "face" / "gt_keep_masks"),
            "-i", str(tmp / "out")])["face256"]
        launches = ops.launch_counts()
        tree = out["tree"]
        names = sorted(p.name for p in tree["srs"].iterdir())
        worst = 0.0
        for name in names:
            final = read_rgb8(tree["srs"] / name).astype(np.float64) / 255.0
            gt = read_rgb8(tree["gts"] / name).astype(np.float64) / 255.0
            keep = read_rgb8(tree["gt_keep_masks"] / name)[..., :1] > 127
            if final.shape != (hq.image_size, hq.image_size, 3) or gt.shape != final.shape:
                raise AssertionError(f"face sweep {name}: {final.shape}, gt {gt.shape}")
            worst = max(worst, float(np.abs(keep * (final - gt)).max()))
    stats = dict(wall_seconds=out["wall_seconds"], tiles=len(names), model_calls=calls,
                 seconds_per_tile=out["wall_seconds"] / max(len(names), 1),
                 psnr=out["psnr"], range_space_max_abs=worst)
    print(f"face sweep (face256 ADM, bf16, 2 JPEG gts cropped from 320 x 288, batch 2): "
          f"{stats['wall_seconds']:.2f} s wall, {stats['seconds_per_tile']:.2f} s per tile, "
          f"PSNR {['%.2f' % p for p in stats['psnr']]}, max |A(x) - y| on the written "
          f"images {worst:.4f} (one level {1 / 255:.4f}); launches {launches}, per model "
          f"call {({k: v / calls for k, v in launches.items()})}", flush=True)
    if names != ["face_00000.jpg", "face_00001.jpg"]:
        raise AssertionError(f"face sweep outputs: {names}")
    if not all(np.isfinite(stats["psnr"])) or worst > 1 / 255 + 1e-6:
        raise AssertionError(f"face sweep: PSNR {stats['psnr']}, max |A(x) - y| {worst}")
    want = expected_launches(n_gn * calls, n_attn * calls)
    if launches != want:
        raise AssertionError(f"face sweep launch counts {launches} != {want} ({calls} calls)")
    return stats, launches


# ------------------------------------------------------------ phases 5 and 7


def main_argv(deg: str, deg_scale: str, simplified: bool, path_y: str = "celeba_hq") -> list:
    """main_torch's flags of phases 5, 7, 19 and 20 (without -i)."""
    return ["--config", str(REPO / "configs" / "celeba_hq.yml"),
            "--ckpt", str(FLAG_PT), "--exp", str(REPO / "exp"),
            "--path_y", path_y, "--deg", deg,
            "--deg_scale", deg_scale, "--sigma_y", "0",
            *(["--simplified"] if simplified else []),
            "--dtype", "bfloat16", "--batch_size", "8", "--ni", "--verbose", "warning"]


def read_outputs(folder: Path) -> dict:
    """{image index: uint8 (H, W, 3)} of a run's <i>_0.png outputs."""
    from ddnm_tpu_torch.data.io import load_image

    return {int(f.name.split("_")[0]): to_u8(load_image(f)) for f in folder.glob("*_0.png")}


def main_path(deg: str, deg_scale: str, simplified: bool, n_gn: int, n_attn: int,
              want_fwht: int, path_y: str = "celeba_hq", keep: dict | None = None
              ) -> tuple[dict, dict]:
    """main_torch on configs/celeba_hq.yml, flag_ddpm256.pt, the 8 images of
    exp/datasets/<path_y> (the PNGs of celeba_hq, or their copies in other
    formats in celeba_hq_mixed), bf16 torso, batch 8, 100 steps, sigma_y 0; checks 8
    PNGs, PSNR > 14 dB and every kernel's launch count exactly. Returns (the
    run's stats, its launch counts); `keep` gets the outputs (read_outputs)."""
    import main_torch

    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        stats = main_torch.main(main_argv(deg, deg_scale, simplified, path_y)
                                + ["-i", str(Path(tmp) / "out")])
        launches = ops.launch_counts()
        n_png = len(list((Path(tmp) / "out").glob("*_0.png")))
        if keep is not None:
            keep.update(read_outputs(Path(tmp) / "out"))
    steps = 100
    print(f"main path ({'simplified' if simplified else 'SVD'} {deg}, {path_y}): "
          f"{stats['num_samples']} images, PSNR {stats['avg_psnr']:.4f}, "
          f"{stats['images_per_second']:.4f} images/s end to end "
          f"({stats['wall_seconds']:.2f} s), "
          f"{stats['num_samples'] / stats['sample_seconds']:.4f} images/s in the "
          f"sampler ({stats['sample_seconds']:.2f} s); launches {launches}",
          flush=True)
    print(overlap_gap_line(f"{'simplified' if simplified else 'SVD'} {deg} {path_y}", stats),
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


# ------------------------------------------------------------------ phase 20


def dp_mesh():
    """The mesh of 2 of phase 20: two cards where they exist, else cuda:0
    twice (its shards on two streams of the one card); and a line saying
    which."""
    from ddnm_tpu_torch.parallel import make_mesh

    count = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if count >= 2 else ["cuda:0", "cuda:0"]
    where = ("two cards" if count >= 2 else
             "one card: every mesh below repeats cuda:0, its two shards on separate streams")
    return make_mesh(devices=devices), f"{count} visible card(s); {where}"


def graphs_by_entry(stats: list) -> dict:
    """graphs.graph_stats() summed per mesh entry: graphs, warm-up, capture
    and instantiate seconds, pool bytes."""
    out: dict = {}
    for s in stats:
        e = out.setdefault(s["entry"], dict(graphs=0, warmup_s=0.0, capture_s=0.0,
                                             instantiate_s=0.0, pool_bytes=0))
        e["graphs"] += 1
        for k in ("warmup_s", "capture_s", "instantiate_s"):
            e[k] += s[k]
        e["pool_bytes"] += s["pool_bytes"] or 0
    return out


def format_entries(per_entry: dict) -> str:
    return "; ".join(
        f"shard {i}: {e['graphs']} graph(s), capture {e['capture_s']:.3f} s, instantiate "
        f"{e['instantiate_s']:.3f} s (warm-up {e['warmup_s']:.3f} s), pool "
        f"{e['pool_bytes'] / 2**20:.1f} MiB" for i, e in sorted(per_entry.items()))


@contextlib.contextmanager
def scoped_graph_stats(out: list):
    """Collect graphs.graph_stats() as each graphs.scope() of the block ends
    (Runner.run and hq_main_torch.main drop their graphs then)."""
    from ddnm_tpu_torch.sampling import graphs

    real = graphs.scope

    @contextlib.contextmanager
    def scope():
        with real():
            try:
                yield
            finally:
                out.extend(graphs.graph_stats())

    graphs.scope = scope
    try:
        yield
    finally:
        graphs.scope = real


def max_level_diff(a: dict, b: dict) -> int:
    """Largest |a - b| in uint8 levels over the images of both (same keys)."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"image sets differ: {sorted(a)} against {sorted(b)}")
    return max(int(np.abs(a[k].astype(np.int16) - b[k].astype(np.int16)).max()) for k in a)


def dp_runner(mesh, where: str, n_gn: int, n_attn: int, phase5: dict, phase5_out: dict
              ) -> tuple[dict, dict]:
    """Phase 20(a): phase 5's main path through main_torch on `mesh` under
    --loop auto (the scan driver: a graph a shard) and --loop host: the
    written images byte-equal, each within 1 level of phase 5's unsharded
    run, launches per shard exact under both; each shard's graphs."""
    import main_torch

    legs = {}
    for loop in ("auto", "host"):
        graph_stats: list = []
        with tempfile.TemporaryDirectory() as tmp, scoped_graph_stats(graph_stats):
            ops.reset_launch_counts()
            stats = main_torch.main(main_argv("sr_averagepooling", "4", True)
                                    + ["-i", str(Path(tmp) / "out"), "--loop", loop], mesh=mesh)
            legs[loop] = (stats, ops.launch_counts(), ops.tagged_launch_counts(),
                          read_outputs(Path(tmp) / "out"), graphs_by_entry(graph_stats))
    stats, launches, per_shard, outs, per_entry = legs["auto"]
    host_stats, host_launches, host_per_shard, host_outs, _ = legs["host"]
    diff = max_level_diff(outs, phase5_out)
    equal = max_level_diff(outs, host_outs) == 0
    want = expected_launches(n_gn * 100, n_attn * 100)
    r = {"mesh": [str(d) for d in mesh.devices], "where": where,
         "images_per_second": stats["images_per_second"],
         "sampler_images_per_second": stats["num_samples"] / stats["sample_seconds"],
         "host_images_per_second": host_stats["images_per_second"],
         "host_sampler_images_per_second":
             host_stats["num_samples"] / host_stats["sample_seconds"],
         "phase5_images_per_second": phase5["images_per_second"],
         "phase5_sampler_images_per_second": phase5["num_samples"] / phase5["sample_seconds"],
         "wall_seconds": stats["wall_seconds"], "max_level_diff_vs_phase5": diff,
         "byte_equal_to_host_driven": equal, "graphs_per_shard": per_entry,
         "avg_psnr": stats["avg_psnr"], "launches_per_shard": per_shard}
    print(f"(a) runner on {r['mesh']} ({where}), --loop auto (a graph a shard): "
          f"{stats['num_samples']} images, PSNR {stats['avg_psnr']:.4f}, "
          f"{r['images_per_second']:.4f} images/s end to end against phase 5's "
          f"{r['phase5_images_per_second']:.4f}, {r['sampler_images_per_second']:.4f} in the "
          f"sampler against {r['phase5_sampler_images_per_second']:.4f} (--loop host on the "
          f"mesh: {r['host_images_per_second']:.4f} / "
          f"{r['host_sampler_images_per_second']:.4f}); images byte-equal to --loop host's: "
          f"{equal}; within {diff} level(s) of phase 5's; {format_entries(per_entry)}; "
          f"launches per shard {per_shard}", flush=True)
    if stats["num_samples"] != 8 or diff > 1 or not equal:
        raise AssertionError(f"mesh runner: {stats['num_samples']} images, {diff} levels off, "
                             f"byte-equal to host-driven {equal}")
    if sorted(per_entry) != [0, 1]:
        raise AssertionError(f"mesh runner graphs per shard {per_entry}")
    for got, total in ((per_shard, launches), (host_per_shard, host_launches)):
        if sorted(got) != [0, 1] or any(c != want for c in got.values()):
            raise AssertionError(f"mesh runner launches per shard {got} != {want} each")
        if total != {k: 2 * v for k, v in want.items()}:
            raise AssertionError(f"mesh runner launches {total}")
    return r, launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_processes(phase5_out: dict) -> dict:
    """Phase 20(b): main_torch.py as two ranks (env RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT, gloo), both on cuda:0 on a one-card machine,
    one card each otherwise, writing into one folder."""
    import os

    one_card = torch.cuda.device_count() < 2
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out"
        procs, logs, walls = [], [], [None, None]
        try:
            for rank in range(2):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                log = open(Path(tmp) / f"rank{rank}.log", "w+")
                logs.append(log)
                argv = main_argv("sr_averagepooling", "4", True) + ["-i", str(out)]
                argv += ["--device", "cuda:0"] if one_card else []
                procs.append((time.perf_counter(), subprocess.Popen(
                    [sys.executable, str(REPO / "main_torch.py"), *argv], cwd=REPO, env=env,
                    stdout=log, stderr=subprocess.STDOUT)))
            deadline = time.perf_counter() + 400
            while None in walls and time.perf_counter() < deadline:
                for rank, (t0, proc) in enumerate(procs):
                    if walls[rank] is None and proc.poll() is not None:
                        walls[rank] = time.perf_counter() - t0
                time.sleep(0.05)
            for rank, (_, proc) in enumerate(procs):
                if proc.poll() != 0:
                    logs[rank].seek(0)
                    raise AssertionError(f"rank {rank} exited {proc.poll()}: "
                                         f"{logs[rank].read()[-3000:]}")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for log in logs:
                log.close()
        outs = read_outputs(out)
        texts = [(Path(tmp) / f"rank{r}.log").read_text() for r in range(2)]
    counts = [int(re.search(r"Number of samples: (\d+)", t).group(1)) for t in texts]
    diff = max_level_diff(outs, phase5_out)
    r = {"ranks": 2, "devices": "cuda:0 for both" if one_card else "cuda:0 and cuda:1",
         "wall_seconds": walls, "images_per_rank": counts, "images": sorted(outs),
         "max_level_diff_vs_phase5": diff}
    print(f"(b) two processes ({r['devices']}): images per rank {counts}, images "
          f"{sorted(outs)}, wall {walls[0]:.2f} s and {walls[1]:.2f} s (process start "
          f"included), within {diff} level(s) of phase 5's", flush=True)
    if counts != [4, 4] or sorted(outs) != list(range(8)) or diff > 1:
        raise AssertionError(f"two processes: {r}")
    return r


def dp_served(mesh, n_gn: int, n_attn: int) -> tuple[dict, dict]:
    """Phase 20(c): phase 17's service (flag DDPM, bf16, max_batch 8) with
    --dp 2 on `mesh`."""
    import serve_torch
    from ddnm_tpu_torch.data.datasets import FolderDataset
    from ddnm_tpu_torch.data.io import encode_png
    from ddnm_tpu_torch.sampling import graphs
    from ddnm_tpu_torch.server import RestorationService

    svc = serve_torch.build_service(serve_torch.parse_args(
        SERVED_FLAGS + ["--degs", "sr_averagepooling", "--deg_scale", "4", "--dp", "2"]),
        mesh=mesh)
    svc.warmup()
    ds = FolderDataset(REPO / "exp" / "datasets" / "celeba_hq", 256)
    gts = [to_u8(ds[i][0]) for i in range(len(ds))]
    load = serve_load(svc, [("/restore?deg=sr_averagepooling&input=gt", encode_png(g))
                            for g in gts])
    replies, h = load["replies"], load["health"]
    if [r[0] for r in replies] != [200] * 8:
        raise AssertionError(f"--dp 2 replies: {[(r[0], r[1][:200]) for r in replies]}")
    i = max(range(8), key=lambda k: int(replies[k][2]["X-Batch-Size"]))
    seq = int(replies[i][2]["X-Seq"])
    alone = svc.restore(gts[i][None].astype(np.float32) / 255.0, "sr_averagepooling",
                        [seq], input_kind="gt")
    alone_equal = encode_png(to_u8(alone[0])) == replies[i][1]
    imgs = np.stack(gts).astype(np.float32) / 255.0
    ops.reset_launch_counts()
    group = svc.restore(imgs, "sr_averagepooling", list(range(100, 108)), input_kind="gt")
    per_shard = ops.tagged_launch_counts()
    per_entry = graphs_by_entry(graphs.graph_stats())
    host_svc = serve_torch.build_service(serve_torch.parse_args(
        SERVED_FLAGS + ["--degs", "sr_averagepooling", "--deg_scale", "4", "--dp", "2",
                        "--loop", "host"]), mesh=mesh)
    ops.reset_launch_counts()
    host_group = host_svc.restore(imgs, "sr_averagepooling", list(range(100, 108)),
                                  input_kind="gt")
    host_per_shard = ops.tagged_launch_counts()
    host_equal = bool(np.array_equal(group, host_group))
    del host_svc
    last = svc.restore(imgs[7:8], "sr_averagepooling", [107], input_kind="gt")
    last_equal = encode_png(to_u8(group[7])) == encode_png(to_u8(last[0]))
    single = RestorationService(svc._model_fn, svc._params, svc._sched, svc._operators,
                                image_size=256, max_batch=8, base_seed=1234)
    ref = single.restore(imgs, "sr_averagepooling", list(range(100, 108)), input_kind="gt")
    diff = int(np.abs(to_u8(group).astype(np.int16) - to_u8(ref).astype(np.int16)).max())
    want = expected_launches(n_gn * 100, n_attn * 100)
    want_load = expected_launches(2 * n_gn * 100 * h["batches"], 2 * n_attn * 100 * h["batches"])
    r = {"requests": 8, "wall_seconds": load["wall"], "requests_per_second": 8 / load["wall"],
         "batches": h["batches"], "mean_batch": h["mean_batch"], "latency_s": h.get("latency_s"),
         "alone_vs_coalesced_byte_equal": alone_equal, "seq_checked": seq,
         "last_lane_vs_alone_byte_equal": last_equal, "max_level_diff_vs_dp1": diff,
         "bit_equal_to_host_driven": host_equal, "graphs_per_shard": per_entry,
         "launches_per_shard_per_group": per_shard}
    print(f"(c) served --dp 2 on {[str(d) for d in mesh.devices]}: 8 requests in "
          f"{load['wall']:.2f} s, {r['requests_per_second']:.4f} requests/s, {h['batches']} "
          f"groups, mean_batch {h['mean_batch']:.3f}, latency_s {h.get('latency_s')}; reply seq "
          f"{seq} byte-equal alone: {alone_equal}; lane 7 of a group of 8 byte-equal alone: "
          f"{last_equal}; the group within {diff} level(s) of the --dp 1 service's, bit-equal "
          f"to a --dp 2 --loop host service's: {host_equal}; {format_entries(per_entry)}; "
          f"launches {load['launches']}, per shard of one group {per_shard}", flush=True)
    if not (alone_equal and last_equal and host_equal) or diff > 1:
        raise AssertionError(f"--dp 2 service: {r}")
    if sorted(per_entry) != [0, 1]:
        raise AssertionError(f"--dp 2 service graphs per shard {per_entry}")
    for got in (per_shard, host_per_shard):
        if sorted(got) != [0, 1] or any(c != want for c in got.values()):
            raise AssertionError(f"--dp 2 launches per shard {got} != {want} each")
    if load["launches"] != want_load:
        raise AssertionError(f"--dp 2 launches {load['launches']}")
    del svc, single
    torch.cuda.empty_cache()
    return r, load["launches"]


def dp_hq(mesh) -> tuple[dict, dict]:
    """Phase 20(d): the toy32 ADM's Mask-Shift canvases in fp32, wavefront
    order, on `mesh` against unsharded: phase 9's 48 x 48 canvas on its
    tables (2 x 2 tiles: every group one tile, on the first entry) and an
    80 x 128 crop of a natural128 image on a 10-step schedule without
    jumps (4 x 7 tiles: the wavefront 2i + j = 6 is a group of 4, sharded
    2 + 2). On the mesh under loop "auto" (a graph a shard and group size)
    and "host": bit-equal, launches equal."""
    from ddnm_tpu_torch.sampling import graphs
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables
    from ddnm_tpu_torch.tiling import mask_shift_sample

    model = toy_adm("cuda")
    betas = sch.named_beta_schedule("linear", 1000, use_scale=True)
    zero = lambda gens, shape: torch.zeros(shape, device="cuda")
    canvases = {
        "48x48": (load_image(sorted((REPO / "exp/datasets/natural64").glob("*.png"))[0])[:48, :48],
                  build_posterior_tables(betas=betas, timestep_respacing=HQ_RESPACING,
                                         schedule_jump_params=HQ_JUMP)),
        "80x128": (load_image(sorted((REPO / "exp/datasets/natural128").glob("*.png"))[0])[:80],
                   build_posterior_tables(betas=betas, timestep_respacing="10",
                                          schedule_jump_params=dict(t_T=10, n_sample=1,
                                                                    jump_length=1,
                                                                    jump_n_sample=1))),
    }
    out, launches = {}, None
    for name, (img, tables) in canvases.items():
        gt = (img * 2.0 - 1.0)[None]
        res = {}
        for label, m, loop in (("unsharded", None, "auto"), ("mesh", mesh, "auto"),
                               ("mesh_host", mesh, "host")):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            run = mask_shift_sample(lambda z, t: model(z, t), gt, "sr_averagepooling", tables, 0,
                                    scale=4, noise_fn=zero, tile=32, stride=16, device="cuda",
                                    parallel=True, mesh=m, loop=loop)
            res[label] = (run["final"], time.perf_counter() - t0, ops.launch_counts(),
                          ops.tagged_launch_counts())
            if label == "mesh":
                per_entry = graphs_by_entry(graphs.graph_stats())
            graphs.clear_graphs()
        host_equal = bool(np.array_equal(res["mesh"][0], res["mesh_host"][0])
                          and res["mesh"][2:] == res["mesh_host"][2:])
        to01 = lambda a: np.clip((a + 1) / 2, 0, 1)
        psnr = {k: 10 * math.log10(1 / max(float(np.mean((to01(v[0]) - to01(gt)) ** 2)), 1e-12))
                for k, v in res.items()}
        shard1 = res["mesh"][3].get(1, {}).get("attention", 0)
        out[name] = {"psnr_unsharded": psnr["unsharded"], "psnr_mesh": psnr["mesh"],
                     "max_abs_diff": float(np.abs(res["mesh"][0] - res["unsharded"][0]).max()),
                     "seconds": {k: v[1] for k, v in res.items()},
                     "bit_equal_to_host_driven": host_equal, "graphs_per_shard": per_entry,
                     "shard1_attention_launches": shard1}
        print(f"(d) hq {name} wavefront fp32: PSNR {psnr['mesh']:.4f} on the mesh against "
              f"{psnr['unsharded']:.4f} unsharded, max |diff| {out[name]['max_abs_diff']:.2e}, "
              f"{res['mesh'][1]:.2f} s against {res['unsharded'][1]:.2f} (host-driven on the "
              f"mesh {res['mesh_host'][1]:.2f} s, final and launches equal: {host_equal}); "
              f"{format_entries(per_entry)}; shard 1's attention launches {shard1}", flush=True)
        if not abs(psnr["mesh"] - psnr["unsharded"]) <= 0.01 or not host_equal:
            raise AssertionError(f"hq {name} on the mesh: {out[name]}")
        # a sharded group runs one forward a shard: shard 1's launches on top
        extra = res["mesh"][3].get(1, dict.fromkeys(res["mesh"][2], 0))
        if res["mesh"][2] != {k: v + extra[k] for k, v in res["unsharded"][2].items()}:
            raise AssertionError(f"hq {name}: launches {res['mesh'][2]} != "
                                 f"{res['unsharded'][2]} + shard 1's {extra}")
        if (name == "80x128") != (shard1 > 0):
            raise AssertionError(f"hq {name}: shard 1 launched {shard1} attentions")
        launches = res["mesh"][2]
    del model
    return out, launches


def dp_guidance(mesh) -> tuple[dict, dict]:
    """Phase 20(e): the guidance gradient of the 256 px classifier
    (cc_classifier, bf16) at batch 8 sharded 4 + 4 over `mesh`, against the
    two halves run one after the other on one stream, bit for bit with
    cudnn.deterministic: the four backward kernels (gn_bwd_reduce with its
    launch counters) on the two shards' streams. The backward runs on
    autograd's device thread (each op on its forward's stream) while the
    shard's caller waits, and counts under the shard's tag too."""
    from ddnm_tpu_torch.models import classifier_guidance_fn
    from ddnm_tpu_torch.parallel import replicate, sharded_sampler

    clf = cc_classifier()
    n_gn, n_attn = module_counts(clf)
    gen = torch.Generator(device="cuda").manual_seed(20)
    x = torch.randn((8, 256, 256, 3), generator=gen, device="cuda")
    t = torch.linspace(50.0, 950.0, 8, device="cuda")
    labels = torch.arange(8, device="cuda") * 111
    grad = lambda c, z, s, y: classifier_guidance_fn(c, y, 1.0)(z, s)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        halves = torch.cat([grad(clf, x[i:i + 4], t[i:i + 4], labels[i:i + 4]) for i in (0, 4)])
        ops.reset_launch_counts()
        sharded = sharded_sampler(grad, mesh)(replicate(mesh, clf), x, t, labels)
        torch.cuda.synchronize()
        launches, per_shard = ops.launch_counts(), ops.tagged_launch_counts()
    finally:
        torch.backends.cudnn.deterministic = old
    equal = bool(torch.equal(sharded, halves))
    want = expected_launches(n_gn, n_attn, n_gn, n_attn)
    r = {"bit_equal_to_halves": equal, "grad_norm": float(sharded.norm()),
         "launches": launches, "launches_per_shard": per_shard}
    print(f"(e) guidance gradient (256 px classifier, bf16, batch 8) sharded 4 + 4: bit-equal "
          f"to the halves run alone: {equal}, norm {r['grad_norm']:.4f}; launches {launches}, "
          f"launches per shard {per_shard}", flush=True)
    if (not equal or launches != {k: 2 * v for k, v in want.items()}
            or sorted(per_shard) != [0, 1] or any(c != want for c in per_shard.values())):
        raise AssertionError(f"sharded guidance: {r}")
    del clf
    torch.cuda.empty_cache()
    return r, launches


# ------------------------------------------------------------------ phase 21

# the full-width path's depth cut: 10 respaced steps, no jumps (10 model
# calls a tile; the config's 250 / 10 / 10 make 2410)
SP_CUT = ('timestep_respacing: "10"', "t_T: 10", "jump_length: 1", "jump_n_sample: 1")
# face256 at sp = 2 against sp = 1, bf16, dense random weights, on the
# written final.png: the shards' GroupNorm sums and the gathered attention
# add in other orders and cuDNN picks other plans for half a map, and the
# bf16 torso carries the differences through 10 calls; the gate is the PSNR
# of one output against the other, in dB (49.02, at most 17 levels apart,
# in this PR's chip calls, NVIDIA H100 80GB HBM3, 700.00 W)
SP_PSNR_MIN = 40.0


def face_adm(dtype=torch.bfloat16):
    """The face256 ADM UNet of configs/hq/face256.yml on the card, random
    weights from seed 1234 (as hq_main_torch --random_init)."""
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.models import cast_torso
    from ddnm_tpu_torch.models.unet_adm import init_like_flax
    from hq_main_torch import build_adm_from_hq

    model = init_like_flax(build_adm_from_hq(load_hq_config(FACE256), "cuda"), 1234).eval()
    return cast_torso(model, dtype) if dtype != torch.float32 else model


def dense_adm_weights(config: Path, path: Path) -> None:
    """The ADM UNet of the hq config `config` with random weights from seed
    1234 (as hq_main_torch --random_init) and the layers that the init
    zeroes (each ResBlock's out conv, each attention's proj_out, the head
    conv) drawn as the others, fp32, saved to `path`: a model whose eps
    depends on its input, so that two runs of it can disagree."""
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.models.unet_adm import _ZERO_INIT, init_like_flax
    from hq_main_torch import build_adm_from_hq

    model = init_like_flax(build_adm_from_hq(load_hq_config(config), "cuda"), 1234).eval()
    gen = torch.Generator(device="cuda").manual_seed(1235)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.endswith(_ZERO_INIT) and hasattr(mod, "weight"):
                w = mod.weight
                w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=gen)
    torch.save(model.state_dict(), path)
    del model
    torch.cuda.empty_cache()


def conv3x3_count(model) -> int:
    """The 3x3 convolutions of a UNet (each a halo exchange when sharded),
    the ADM's head among them."""
    return sum(isinstance(m, torch.nn.Conv2d) and tuple(m.kernel_size) == (3, 3)
               for m in model.modules())


def _rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def spatial_kernels(shapes: dict, sp: int = 2) -> dict:
    """Phase 21(a): the stats kernel's partial mode and the finalize kernel,
    and attention with Tq != Tk, against their plain versions on the card at
    the face256 forward's shapes (`shapes`, op_shapes at batch 1) with the
    rows cut over `sp` shards, in bf16 and fp32: the sp shards' partial
    sums added in rank order and finalised against the one-launch stats
    kernel on the whole map, a shard's queries against every key against
    the plain version and against those rows of the full kernel's output.
    Times (back to back), bounds and the library call where there is one
    (SDPA for attention); totals per sharded face256 forward (bf16)."""
    from ddnm_tpu_torch.ops.groupnorm import (_finalize, _stats_partial,
                                              _torch_affine_from_sums, _torch_stats_partial)

    gen = torch.Generator(device="cuda").manual_seed(21)
    rnd = lambda *s, dtype=torch.float32: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    per_forward = {k: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                           max_abs_err=0.0)
                   for k in ("partial", "finalize", "attention_gathered")}
    rows = []
    gn = sorted({(k[1], k[2]) for k in shapes if k[0] == "groupnorm"}, key=str)
    for (b, h, w, c), dt in gn:
        calls = shapes[("groupnorm", (b, h, w, c), dt)]
        film = ("groupnorm_film", (b, h, w, c), dt) in shapes
        for dtype in (torch.bfloat16, torch.float32):
            x = rnd(b, h, w, c, dtype=dtype) * 2 + 0.3
            gamma, beta = rnd(c), rnd(c)
            fs, ft = (rnd(b, c) * 0.1, rnd(b, c) * 0.1) if film else (None, None)
            shards = [s.contiguous() for s in x.chunk(sp, dim=1)]
            part = _stats_partial(shards[0], 32)
            err_p = _rel_err(part, _torch_stats_partial(shards[0]))
            sums = None
            for s in shards:
                p = _stats_partial(s, 32)
                sums = p if sums is None else sums + p
            a, bb = _finalize(sums, h * w, gamma, beta, 32, 1e-5, fs, ft)
            a_p, b_p = _torch_affine_from_sums(sums, h * w, gamma, beta, 32, 1e-5, fs, ft)
            err_f = max(_rel_err(a, a_p), _rel_err(bb, b_p))
            a_w, b_w = _stats_affine(x, gamma, beta, 32, 1e-5, fs, ft)
            err_w = max(_rel_err(a, a_w), _rel_err(bb, b_w))
            tol = TOL[("groupnorm_stats", dtype)]
            if max(err_p, err_f, err_w) > tol:
                raise AssertionError(f"spatial GroupNorm {tuple(shards[0].shape)} {dtype}: "
                                     f"partial {err_p:.2e}, finalize {err_f:.2e}, against the "
                                     f"whole map {err_w:.2e} > {tol}")
            ms_p = cuda_ms(lambda: _stats_partial(shards[0], 32))
            dev_p = device_ms(lambda: _stats_partial(shards[0], 32))
            plain_p = cuda_ms(lambda: _torch_stats_partial(shards[0]))
            ms_f = cuda_ms(lambda: _finalize(sums, h * w, gamma, beta, 32, 1e-5, fs, ft))
            dev_f = device_ms(lambda: _finalize(sums, h * w, gamma, beta, 32, 1e-5, fs, ft))
            plain_f = cuda_ms(lambda: _torch_affine_from_sums(sums, h * w, gamma, beta, 32,
                                                              1e-5, fs, ft))
            bound_p = (shards[0].numel() * shards[0].element_size() + 8 * b * c) / HBM_BYTES_PER_S * 1e3
            bound_f = (8 * b * c * (3 if film else 2) + 8 * c) / HBM_BYTES_PER_S * 1e3
            row = dict(shape=list(shards[0].shape), dtype=str(dtype).split(".")[-1], film=film,
                       calls_per_forward=calls, partial=dict(max_abs_err=err_p, ms=ms_p,
                       device_ms=dev_p, plain_ms=plain_p, bound_ms=bound_p), finalize=dict(
                       max_abs_err=err_f, ms=ms_f, device_ms=dev_f, plain_ms=plain_f,
                       bound_ms=bound_f), against_whole_map=err_w)
            rows.append(row)
            print(f"spatial GroupNorm shard {tuple(shards[0].shape)} {row['dtype']} film "
                  f"{film}: partial {ms_p:.4f} ms (device {dev_p:.4f}, plain {plain_p:.4f}, "
                  f"bound {bound_p:.4f}), finalize {ms_f:.4f} ms (device {dev_f:.4f}, plain "
                  f"{plain_f:.4f}, bound {bound_f:.5f}); errors {err_p:.1e} / {err_f:.1e}, "
                  f"{sp} shards against the whole map {err_w:.1e}", flush=True)
            if dtype == torch.bfloat16:
                for k, ms, dev, plain, bound, err in (
                        ("partial", ms_p, dev_p, plain_p, bound_p, err_p),
                        ("finalize", ms_f, dev_f, plain_f, bound_f, err_f)):
                    f = per_forward[k]
                    f["ms"] += calls * ms
                    f["device_ms"] += calls * dev
                    f["plain_ms"] += calls * plain
                    f["bound_ms"] += calls * bound
                    f["max_abs_err"] = max(f["max_abs_err"], err)
    for key, calls in sorted(((k, v) for k, v in shapes.items() if k[0] == "attention"), key=str):
        _, (bh, t, c), _ = key
        tq = t // sp
        for dtype in (torch.bfloat16, torch.float32):
            q_full, k, v = (rnd(bh, t, c, dtype=dtype) for _ in range(3))
            scale = c ** -0.5
            full = _kernel_attention(q_full, k, v, scale)
            worst = worst_rows = 0.0
            for r in range(sp):
                q = q_full[:, r * tq:(r + 1) * tq].contiguous()
                out = _kernel_attention(q, k, v, scale)
                worst = max(worst, _rel_err(out, _torch_attention(q, k, v, scale)))
                worst_rows = max(worst_rows, _rel_err(out, full[:, r * tq:(r + 1) * tq]))
            bits = all(torch.equal(_kernel_attention(q_full[:, r * tq:(r + 1) * tq].contiguous(),
                                                     k, v, scale), full[:, r * tq:(r + 1) * tq])
                       for r in range(sp))
            tol = TOL[("attention", dtype)]
            if max(worst, worst_rows) > tol:
                raise AssertionError(f"attention Tq {tq} Tk {t} C {c} {dtype}: against plain "
                                     f"{worst:.2e}, against the full kernel's rows "
                                     f"{worst_rows:.2e} > {tol}")
            q = q_full[:, :tq].contiguous()
            ms = cuda_ms(lambda: _kernel_attention(q, k, v, scale))
            dev = device_ms(lambda: _kernel_attention(q, k, v, scale))
            plain = cuda_ms(lambda: _torch_attention(q, k, v, scale))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            flops = 4.0 * bh * tq * t * c
            nbytes = (2 * bh * tq * c + 2 * bh * t * c) * q.element_size()
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            row = dict(shape=[bh, tq, t, c], dtype=str(dtype).split(".")[-1],
                       calls_per_forward=calls, max_abs_err=worst, against_full_rows=worst_rows,
                       rows_bit_equal=bits, ms=ms, device_ms=dev, plain_ms=plain,
                       library_ms=lib,
                       bound_ms=bound, bound_by=by, bound_ops_ms=t_ops, bound_bytes_ms=t_bytes)
            rows.append(row)
            print(f"spatial attention Tq {tq} Tk {t} (B*heads {bh}, C {c}) {row['dtype']}: "
                  f"{ms:.4f} ms (device {dev:.4f}, plain {plain:.4f}, SDPA {lib:.4f}, bound "
                  f"{bound:.5f} by {by}); "
                  f"against plain {worst:.1e}, against the full kernel's rows {worst_rows:.1e} "
                  f"(bit-equal: {bits})", flush=True)
            if dtype == torch.bfloat16:
                f = per_forward["attention_gathered"]
                f["ms"] += calls * ms
                f["device_ms"] += calls * dev
                f["plain_ms"] += calls * plain
                f["bound_ms"] += calls * bound
                f["library_ms"] += calls * lib
                f["max_abs_err"] = max(f["max_abs_err"], worst)
                f["bound_by"] = by
    for k in ("partial", "finalize"):
        per_forward[k].update(bound_by="bytes", library_ms=None)
    print(f"per sharded face256 forward (bf16, sp {sp}, one shard): "
          + "; ".join(f"{k} {v['ms']:.4f} ms (device {v['device_ms']:.4f}, plain "
                      f"{v['plain_ms']:.4f}, bound {v['bound_ms']:.4f})"
                      for k, v in per_forward.items()), flush=True)
    return {"per_forward": per_forward, "shapes": rows}


def spatial_worker(argv: list) -> int:
    """One rank of a phase 21 or 22 process group (`chip_smoke.py
    --spatial-worker KIND OUT_JSON [ARGS]`; the parent sets RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT). KIND "golden": the toy32 hq
    golden hq_sr_ap_4x on the spatial grid of every rank, fp32, each rank on
    cuda:0; "hq": hq_main_torch.main(ARGS); "guided_golden" (phase 22): the
    toy32 guided golden, the ADM and the classifier sharded; "guided_hq"
    (phase 22): the guidance gradient of the dense 256 px classifier
    (ARGS[0], a state dict) on the grid at a fixed input, saved beside
    OUT_JSON, then hq_main_torch.main(ARGS[1:]). Writes the rank's
    launches, collectives and a hash of its final images to OUT_JSON."""
    import hashlib

    from ddnm_tpu_torch.models import shard_spatially
    from ddnm_tpu_torch.parallel import (BACKWARD_COLLECTIVES, COLLECTIVES, make_mesh_2d,
                                         multihost, reset_collective_counts)
    from ddnm_tpu_torch.sampling import graphs

    kind, out_json, rest = argv[0], Path(argv[1]), argv[2:]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    digest = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    if kind == "golden":
        multihost.maybe_init_distributed()
        import torch.distributed as dist

        world = dist.get_world_size()
        grid = make_mesh_2d(1, world, device="cuda:0")
        model = shard_spatially(toy_adm("cuda:0"), grid.spatial)
        fn, _, _ = grid.wrap(lambda z, t: model(z, t), model=model)
        ops.reset_launch_counts()
        reset_collective_counts()
        with graphs.host_only():  # the wrapped model's collectives run from the host
            psnr, x, secs = hq_golden_run(fn, "cuda:0", TASKS_HQ[0])
        result = dict(psnr=psnr, seconds=secs, sha256=digest(x.cpu().numpy()),
                      **gloo_resolution(grid))
    elif kind == "hq":
        import hq_main_torch

        try:  # --loop scan on a gloo grid on a card: refused before any tile
            hq_main_torch.main(rest + ["--loop", "scan"])
            cli_scan = None
        except ValueError as e:
            cli_scan = str(e)
        ops.reset_launch_counts()
        reset_collective_counts()
        out = hq_main_torch.main(rest)
        result = dict(stats=out["stats"], sha256=digest(out["final"]), cli_scan_error=cli_scan)
    elif kind == "guided_golden":
        multihost.maybe_init_distributed()
        import torch.distributed as dist

        grid = make_mesh_2d(1, dist.get_world_size(), device="cuda:0")
        model = shard_spatially(toy_adm("cuda:0"), grid.spatial)
        clf = shard_spatially(toy_classifier("cuda:0"), grid.spatial)
        ops.reset_launch_counts()
        reset_collective_counts()
        with graphs.host_only():
            psnr, x, per_image, secs = guided_golden_run(model, clf, "cuda:0", grid=grid)
        result = dict(psnr=psnr, per_image=per_image, seconds=secs,
                      sha256=digest(x.cpu().numpy()), **gloo_resolution(grid))
    elif kind == "guided_hq":
        import hq_main_torch
        import torch.distributed as dist
        from ddnm_tpu_torch.models import classifier_guidance_fn

        multihost.maybe_init_distributed()
        grid = make_mesh_2d(1, dist.get_world_size(), device="cuda:0")
        clf = cc_classifier("cuda:0")
        clf.load_state_dict(torch.load(rest[0], map_location="cuda:0"))
        shard_spatially(clf, grid.spatial)
        x, t = guidance_probe_input()
        _, _, _, guide = grid.wrap(guidance_fn=classifier_guidance_fn(clf, 951, 1.0),
                                   classifier=clf)
        grad = guide(x, t)
        torch.cuda.synchronize()
        torch.save(grad.cpu(), out_json.with_suffix(".grad.pt"))
        del clf
        ops.reset_launch_counts()
        reset_collective_counts()
        out = hq_main_torch.main(rest[1:])
        result = dict(stats=out["stats"], sha256=digest(out["final"]),
                      grad_sha256=digest(grad.cpu().numpy()))
    else:
        raise ValueError(f"unknown spatial worker kind {kind!r}")
    result.update(launches=ops.launch_counts(), spatial_launches=ops.spatial_launch_counts(),
                  collectives=dict(COLLECTIVES),
                  backward_collectives=dict(BACKWARD_COLLECTIVES),
                  rank=multihost.process_index())
    out_json.write_text(json.dumps(result))
    return 0


def gloo_resolution(grid) -> dict:
    """What the loop drivers resolve to on `grid` (gloo on a card): "auto"
    and the message with which "scan" is refused."""
    from ddnm_tpu_torch.sampling import graphs

    try:
        graphs.resolve_loop("scan", mesh=grid)
        refused = None
    except ValueError as e:
        refused = str(e)
    return dict(auto_resolves_to=graphs.resolve_loop("auto", mesh=grid), scan_refused=refused)


def check_gloo_resolution(what: str, ranks: list, key: str = "scan_refused") -> str:
    """Print and check phase 21 / 22's resolution on the gloo grid of two
    processes on cuda:0: auto is host, scan raised SCAN_OVER_GLOO."""
    from ddnm_tpu_torch.sampling import graphs

    autos = sorted({x["auto_resolves_to"] for x in ranks if "auto_resolves_to" in x})
    refusals = sorted({str(x[key]) for x in ranks})
    print(f"{what}: gloo on one card, not capturable: auto resolved to {autos or '-'}, "
          f"scan raised {refusals}", flush=True)
    if autos not in ([], ["host"]) or refusals != [graphs.SCAN_OVER_GLOO]:
        raise AssertionError(f"{what}: the gloo grid's loop resolution {autos}, {refusals}")
    return graphs.SCAN_OVER_GLOO


def spatial_processes(kind: str, world: int, args: list, tmp: Path,
                      timeout: float = 300) -> list:
    """`world` ranks of spatial_worker(kind) (gloo rendezvous on
    127.0.0.1, every rank on cuda:0); their results in rank order and the
    seconds each process took."""
    import os

    port = free_port()
    procs, logs, walls = [], [], [None] * world
    try:
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            log = open(tmp / f"{kind}_rank{rank}.log", "w+")
            logs.append(log)
            procs.append((time.perf_counter(), subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--spatial-worker", kind,
                 str(tmp / f"{kind}_rank{rank}.json"), *args], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT)))
        deadline = time.perf_counter() + timeout
        while None in walls and time.perf_counter() < deadline:
            for rank, (t0, proc) in enumerate(procs):
                if walls[rank] is None and proc.poll() is not None:
                    walls[rank] = time.perf_counter() - t0
            time.sleep(0.05)
        for rank, (_, proc) in enumerate(procs):
            if proc.poll() != 0:
                logs[rank].seek(0)
                raise AssertionError(f"{kind} rank {rank} exited {proc.poll()}: "
                                     f"{logs[rank].read()[-3000:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    results = [json.loads((tmp / f"{kind}_rank{r}.json").read_text()) for r in range(world)]
    for r, wall in zip(results, walls):
        r["process_seconds"] = wall
    return results


def spatial_golden(n_gn: int, n_attn: int, n_conv: int) -> dict:
    """Phase 21(b): the toy32 hq golden hq_sr_ap_4x (fp32, TF32 off) at sp
    = 2, two processes on cuda:0 (gloo): within HQ_PSNR_TOL of the JAX
    package's PSNR, both ranks' final images bit-equal, each rank's
    launches and collectives exact."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, n_model_calls

    golden = json.loads(TOY_ADM_PSNR.read_text())[TASKS_HQ[0][0]]["ours_psnr"]
    calls = n_model_calls(build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=HQ_RESPACING, schedule_jump_params=HQ_JUMP))
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spatial_processes("golden", 2, [], Path(tmp))
    r = {"psnr": [x["psnr"] for x in ranks], "golden": golden,
         "seconds": [x["seconds"] for x in ranks],
         "process_seconds": [x["process_seconds"] for x in ranks],
         "ranks_bit_equal": len({x["sha256"] for x in ranks}) == 1,
         "spatial_launches": ranks[0]["spatial_launches"],
         "collectives": ranks[0]["collectives"],
         "scan_refused": check_gloo_resolution("(b) loop resolution", ranks)}
    print(f"(b) toy32 hq golden {TASKS_HQ[0][0]} at sp 2 (two processes on cuda:0, gloo): "
          f"PSNR {r['psnr']} (JAX {golden:.4f}), {r['seconds']} s in the sampler, ranks' "
          f"finals bit-equal {r['ranks_bit_equal']}; launches {ranks[0]['spatial_launches']}, "
          f"collectives {ranks[0]['collectives']} ({calls} model calls)", flush=True)
    if not r["ranks_bit_equal"] or any(abs(p - golden) > HQ_PSNR_TOL for p in r["psnr"]):
        raise AssertionError(f"spatial golden: {r}")
    want = dict(dict.fromkeys(ops.spatial_launch_counts(), 0),
                groupnorm_partial=n_gn * calls, groupnorm_finalize=n_gn * calls,
                attention_gathered=n_attn * calls)
    want_coll = dict(halo=n_conv * calls, groupnorm=n_gn * calls, attention=n_attn * calls,
                     rows=calls, batch=0)
    for x in ranks:
        if (x["spatial_launches"] != want or x["collectives"] != want_coll
                or x["launches"] != dict(expected_launches(), groupnorm_apply=n_gn * calls)):
            raise AssertionError(f"spatial golden rank {x['rank']}: launches "
                                 f"{x['launches']} / {x['spatial_launches']}, collectives "
                                 f"{x['collectives']}; want {want}, {want_coll}")
    return r


def spatial_hq(n_gn: int, n_attn: int, n_conv: int) -> tuple[dict, dict]:
    """Phase 21(c): hq_main_torch.py on configs/hq/face256.yml (full width,
    bf16) with the depth cut SP_CUT, one 256 px tile (4x SR with --resize_y
    of a 64 x 64 PNG pooled from exp/datasets/celeba_hq), on the weights of
    `dense_adm_weights` (--ckpt: with the init's zero layers the model's
    eps would be 0 whatever the sharding): --sp 1 in this process, --sp 2
    as two processes on cuda:0 (gloo). Seconds per tile at each; every
    rank's final bit-equal; sp 2 against sp 1 within SP_PSNR_MIN; launches
    per shard and model call, collectives included, exact. Returns (stats,
    launches of rank 0)."""
    import hq_main_torch
    from ddnm_tpu_torch.config import load_hq_config
    from ddnm_tpu_torch.data.io import load_image, save_image
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, n_model_calls
    from ddnm_tpu_torch.schedules import named_beta_schedule

    conf = FACE256.read_text()
    for old, new in zip(('timestep_respacing: "250"', "t_T: 250", "jump_length: 10",
                         "jump_n_sample: 10"), SP_CUT):
        if conf.count(old) != 1:
            raise AssertionError(f"configs/hq/face256.yml: expected one {old!r}")
        conf = conf.replace(old, new)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "face256_sp.yml").write_text(conf)
        hq = load_hq_config(tmp / "face256_sp.yml")
        calls = n_model_calls(build_posterior_tables(
            betas=named_beta_schedule("linear", int(hq.diffusion_steps), use_scale=True),
            timestep_respacing=str(hq.timestep_respacing),
            schedule_jump_params=dict(hq.schedule_jump_params)))
        img = load_image(sorted((REPO / "exp" / "datasets" / "celeba_hq").glob("*.png"))[0])
        save_image(img.reshape(64, 4, 64, 4, 3).mean(axis=(1, 3)), tmp / "lr.png")
        dense_adm_weights(FACE256, tmp / "face256_dense.pt")
        torch.cuda.empty_cache()
        argv = ["--config", str(tmp / "face256_sp.yml"), "--path_y", str(tmp / "lr.png"),
                "--deg", "sr_averagepooling", "--scale", "4", "--resize_y", "--ckpt",
                str(tmp / "face256_dense.pt"), "--dtype", "bfloat16", "--device", "cuda:0"]
        ops.reset_launch_counts()
        one = hq_main_torch.main(argv + ["-i", str(tmp / "sp1")])
        launches_one = ops.launch_counts()
        ranks = spatial_processes("hq", 2, argv + ["--sp", "2", "-i", str(tmp / "sp2")], tmp)
        check_gloo_resolution("(c) hq_main_torch --sp 2 --loop scan", ranks, "cli_scan_error")
        a = load_image(tmp / "sp2" / "final.png")
        b = load_image(tmp / "sp1" / "final.png")
    diff = int(np.abs(np.round(a * 255) - np.round(b * 255)).max())
    psnr = 10.0 * math.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))
    per_call = {k: v / calls for k, v in ranks[0]["spatial_launches"].items()}
    per_call.update(groupnorm_apply=ranks[0]["launches"]["groupnorm_apply"] / calls,
                    collectives={k: v / calls for k, v in ranks[0]["collectives"].items()})
    stats = {"model_calls": calls, "sp1_seconds_per_tile": one["stats"]["seconds_per_tile"],
             "sp2_seconds_per_tile": [x["stats"]["seconds_per_tile"] for x in ranks],
             "sp2_process_seconds": [x["process_seconds"] for x in ranks],
             "ranks_bit_equal": len({x["sha256"] for x in ranks}) == 1,
             "sp2_vs_sp1_psnr": psnr, "sp2_vs_sp1_max_levels": diff,
             "launches_per_shard_per_call": per_call}
    print(f"(c) face256 (full width, bf16, {calls} model calls a tile): "
          f"{stats['sp1_seconds_per_tile']:.3f} s per tile at sp 1, "
          f"{stats['sp2_seconds_per_tile']} at sp 2 (two processes on cuda:0, gloo); final at sp "
          f"2 against sp 1: PSNR {psnr:.2f} dB, max {diff} levels; ranks bit-equal "
          f"{stats['ranks_bit_equal']}; per shard and model call {per_call}", flush=True)
    if not stats["ranks_bit_equal"] or psnr < SP_PSNR_MIN:
        raise AssertionError(f"face256 at sp 2: {stats}")
    if launches_one != expected_launches(n_gn * calls, n_attn * calls):
        raise AssertionError(f"face256 at sp 1: launches {launches_one}")
    want = dict(dict.fromkeys(ops.spatial_launch_counts(), 0),
                groupnorm_partial=n_gn * calls, groupnorm_finalize=n_gn * calls,
                attention_gathered=n_attn * calls)
    want_coll = dict(halo=n_conv * calls, groupnorm=n_gn * calls, attention=n_attn * calls,
                     rows=calls, batch=0)
    for x in ranks:
        if (x["spatial_launches"] != want or x["collectives"] != want_coll
                or x["launches"] != dict(expected_launches(), groupnorm_apply=n_gn * calls)):
            raise AssertionError(f"face256 at sp 2, rank {x['rank']}: launches "
                                 f"{x['launches']} / {x['spatial_launches']}, collectives "
                                 f"{x['collectives']}; want {want}, {want_coll}")
    return stats, {**ranks[0]["launches"], **ranks[0]["spatial_launches"]}


# ------------------------------------------------------------------ phase 22

# inet256 guided at sp = 2 against sp = 1 on the same dense classifier
# weights, bf16: the guidance gradient at one input, relative to max |sp 1|
# (the shards' GroupNorm sums, the gathered attention and the summed dK / dV
# partials add in other orders, each partial rounded to bf16; printed with
# the fp32 gradient's distance, which the toy32 runs gate), and the final
# tile after the cut's 10 calls as PSNR of one against the other
# (the finals with the ADM's zero-init layers drawn stood 49.96 dB apart on
# an H100; with those layers zero, eps was 0 and the tiles 91 dB apart)
SP_GUIDED_GRAD_TOL = 0.1
SP_GUIDED_PSNR_MIN = 40.0


def _timed(fn, plain, nbytes: float, flops: float, peak: float) -> dict:
    """ms back to back, device ms, plain ms and the bound of one call."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return dict(ms=cuda_ms(fn), device_ms=device_ms(fn), plain_ms=cuda_ms(plain, iters=5),
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def spatial_grad_kernels(shapes: dict, sp: int = 2) -> dict:
    """Phase 22(a): the backward kernels' spatial modes against their plain
    versions on the card, at the 256 px classifier's backward shapes at
    batch 1 (`shapes`, grad_shapes: the guided inet256 tile's) with the rows
    cut over `sp` shards, in bf16 and fp32, and against the one-launch
    kernels on the whole map: gn_bwd_reduce's partial mode on each shard and
    gn_bwd_finalize on the shards' sums added in rank order (against the
    plain versions, and the coefficients against gn_bwd_reduce's on the
    whole map; the partial the same bits twice); attn_bwd_dq and
    attn_bwd_dkdv with Tq = T / sp against every key (against the plain
    versions; a shard's dq, LSE and D bit-equal to the full kernel's rows;
    the shards' dK, dV partials added in rank order against the full
    kernel's). Times (back to back and on the device), bounds, and per
    sharded guidance call (bf16, one shard) their sums; SDPA's autograd
    backward at Tq != Tk as the pair's yardstick."""
    from ddnm_tpu_torch.ops.groupnorm import (_bwd_finalize, _bwd_partial, _torch_bwd_finalize,
                                              _torch_bwd_partial)
    from ddnm_tpu_torch.parallel.spatial import _rank_order_sum

    gen = torch.Generator(device="cuda").manual_seed(22)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    names = ("gn_bwd_partial", "gn_bwd_finalize", "attn_bwd_dq_gathered",
             "attn_bwd_dkdv_gathered")
    per_call = {k: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                        library_ms=None) for k in names}
    per_call["attn_bwd_pair_sdpa_ms"] = 0.0
    rows = []

    def add(name, calls, r, err):
        f = per_call[name]
        for k in ("ms", "device_ms", "plain_ms", "bound_ms"):
            f[k] += calls * r[k]
        f["bound_by"] = r["bound_by"]
        f["max_abs_err"] = max(f["max_abs_err"], err)

    for key, calls in sorted(((k, c) for k, c in shapes.items() if k[0] == "gn"), key=str):
        _, (b, h, w, c), swish, film = key
        for dtype in (torch.bfloat16, torch.float32):
            elem = torch.empty((), dtype=dtype).element_size()
            x, dy = (rnd(b, h, w, c) * 2 + 0.5).to(dtype), rnd(b, h, w, c).to(dtype)
            gamma, beta = rnd(c), rnd(c)
            fs, ft = (rnd(b, c) * 0.3, rnd(b, c) * 0.3) if film else (None, None)
            a_, b_ = _stats_affine(x, gamma, beta, 32, 1e-5, fs, ft)  # the whole map's
            xs = [t.contiguous() for t in x.chunk(sp, dim=1)]
            dys = [t.contiguous() for t in dy.chunk(sp, dim=1)]
            parts = [_bwd_partial(xr, dr, 32, swish, a_, b_) for xr, dr in zip(xs, dys)]
            bits = torch.equal(parts[0], _bwd_partial(xs[0], dys[0], 32, swish, a_, b_))
            err_p = max(_rel_err(p, _torch_bwd_partial(xr, dr, swish, a_, b_))
                        for p, xr, dr in zip(parts, xs, dys))
            sums = _rank_order_sum(parts)
            coef = _bwd_finalize(sums, h * w, gamma, 32, 1e-5, fs)
            err_f = _rel_err(coef, _torch_bwd_finalize(sums, h * w, gamma, 32, 1e-5, fs))
            err_w = _rel_err(coef, _bwd_reduce(x, dy, gamma, 32, 1e-5, swish, a_, b_, fs))
            tol = TOL[("gn_bwd_reduce", dtype)]
            if not bits or max(err_p, err_f, err_w) > tol:
                raise AssertionError(f"spatial GroupNorm backward {tuple(xs[0].shape)} {dtype} "
                                     f"swish={swish} film={film}: partial {err_p:.2e} (same "
                                     f"bits twice: {bits}), finalize {err_f:.2e}, against the "
                                     f"whole map {err_w:.2e} > {tol}")
            n = xs[0].numel()
            t_p = _timed(lambda: _bwd_partial(xs[0], dys[0], 32, swish, a_, b_),
                         lambda: _torch_bwd_partial(xs[0], dys[0], swish, a_, b_),
                         2 * n * elem + 16 * b * c + (8 * b * c if swish else 0),
                         (6 + (12 if swish else 0)) * n, PEAK_FLOPS[torch.float32])
            t_f = _timed(lambda: _bwd_finalize(sums, h * w, gamma, 32, 1e-5, fs),
                         lambda: _torch_bwd_finalize(sums, h * w, gamma, 32, 1e-5, fs),
                         28 * b * c + 4 * c + (4 * b * c if film else 0), 10 * b * c,
                         PEAK_FLOPS[torch.float32])
            dt = str(dtype).split(".")[-1]
            rows.append(dict(kind="gn_bwd", shape=list(xs[0].shape), dtype=dt, swish=swish,
                             film=film, calls_per_guidance=calls, partial=dict(t_p,
                             max_abs_err=err_p), finalize=dict(t_f, max_abs_err=err_f),
                             against_whole_map=err_w))
            print(f"spatial GroupNorm backward shard {tuple(xs[0].shape)} {dt} swish {swish} "
                  f"film {film}: partial {t_p['ms']:.4f} ms (device {t_p['device_ms']:.4f}, "
                  f"plain {t_p['plain_ms']:.4f}, bound {t_p['bound_ms']:.5f}), finalize "
                  f"{t_f['ms']:.4f} ms (device {t_f['device_ms']:.4f}, plain "
                  f"{t_f['plain_ms']:.4f}, bound {t_f['bound_ms']:.6f}); errors {err_p:.1e} / "
                  f"{err_f:.1e}, {sp} shards against the whole map {err_w:.1e}", flush=True)
            if dtype == torch.bfloat16:
                add("gn_bwd_partial", calls, t_p, err_p)
                add("gn_bwd_finalize", calls, t_f, err_f)
    for key, calls in sorted(((k, c) for k, c in shapes.items() if k[0] == "attn"), key=str):
        _, (bh, t, c) = key
        if t % sp:  # the attention pool's (T + 1 tokens), which runs whole on every rank
            continue
        tq = t // sp
        for dtype in (torch.bfloat16, torch.float32):
            elem = torch.empty((), dtype=dtype).element_size()
            q, k, v, do = (rnd(bh, t, c).to(dtype) for _ in range(4))
            scale = c ** -0.25
            o = _kernel_attention(q, k, v, scale)
            dq_full, lse_full, dsum_full = _attn_bwd_dq(q, k, v, o, do, scale)
            dk_full, dv_full = _attn_bwd_dkdv(q, k, v, do, lse_full, dsum_full, scale)
            bits, err_q, err_kv, dks, dvs = True, 0.0, 0.0, [], []
            for r in range(sp):
                rs = slice(r * tq, (r + 1) * tq)
                qr, dor = q[:, rs].contiguous(), do[:, rs].contiguous()
                orr = _kernel_attention(qr, k, v, scale)
                dq, lse, dsum = _attn_bwd_dq(qr, k, v, orr, dor, scale)
                bits &= all(torch.equal(a, b_) for a, b_ in ((dq, dq_full[:, rs]),
                            (lse, lse_full[:, rs]), (dsum, dsum_full[:, rs])))
                err_q = max(err_q, _rel_err(dq, _torch_attn_bwd_dq(qr, k, v, orr, dor,
                                                                    scale)[0]))
                dk, dv = _attn_bwd_dkdv(qr, k, v, dor, lse, dsum, scale)
                pk, pv = _torch_attn_bwd_dkdv(qr, k, v, dor, lse, dsum, scale)
                err_kv = max(err_kv, _rel_err(dk, pk), _rel_err(dv, pv))
                dks.append(dk)
                dvs.append(dv)
            err_sum = max(_rel_err(_rank_order_sum(dks), dk_full),
                          _rel_err(_rank_order_sum(dvs), dv_full))
            tol_q, tol_kv = TOL[("attn_bwd_dq", dtype)], TOL[("attn_bwd_dkdv", dtype)]
            if not bits or err_q > tol_q or max(err_kv, err_sum) > tol_kv:
                raise AssertionError(f"attention backward Tq {tq} Tk {t} C {c} {dtype}: dq "
                                     f"{err_q:.2e} (rows bit-equal {bits}), dK / dV "
                                     f"{err_kv:.2e}, shards summed against the full kernel "
                                     f"{err_sum:.2e}")
            qr, dor = q[:, :tq].contiguous(), do[:, :tq].contiguous()
            orr = _kernel_attention(qr, k, v, scale)
            _, lse, dsum = _attn_bwd_dq(qr, k, v, orr, dor, scale)
            rows_b = 2 * bh * tq * 4
            t_q = _timed(lambda: _attn_bwd_dq(qr, k, v, orr, dor, scale),
                         lambda: _torch_attn_bwd_dq(qr, k, v, orr, dor, scale),
                         (4 * qr.numel() + 2 * k.numel()) * elem + rows_b, 6 * bh * tq * t * c,
                         PEAK_FLOPS[dtype])
            t_kv = _timed(lambda: _attn_bwd_dkdv(qr, k, v, dor, lse, dsum, scale),
                          lambda: _torch_attn_bwd_dkdv(qr, k, v, dor, lse, dsum, scale),
                          (2 * qr.numel() + 4 * k.numel()) * elem + rows_b,
                          8 * bh * tq * t * c, PEAK_FLOPS[dtype])
            lin = [z[:, None].detach().requires_grad_(True) for z in (qr, k, v)]
            lout = F.scaled_dot_product_attention(*lin, scale=scale)
            sdpa = cuda_ms(lambda: torch.autograd.grad(lout, lin, dor[:, None],
                                                       retain_graph=True), iters=10)
            dt = str(dtype).split(".")[-1]
            rows.append(dict(kind="attn_bwd", shape=[bh, tq, t, c], dtype=dt,
                             calls_per_guidance=calls, rows_bit_equal=bits,
                             dq=dict(t_q, max_abs_err=err_q), dkdv=dict(t_kv, max_abs_err=err_kv),
                             summed_against_full=err_sum, sdpa_autograd_ms=sdpa))
            print(f"spatial attention backward Tq {tq} Tk {t} (B*heads {bh}, C {c}) {dt}: dq "
                  f"{t_q['ms']:.4f} ms (device {t_q['device_ms']:.4f}, plain "
                  f"{t_q['plain_ms']:.4f}, bound {t_q['bound_ms']:.5f} by {t_q['bound_by']}), "
                  f"dkdv {t_kv['ms']:.4f} ms (device {t_kv['device_ms']:.4f}, plain "
                  f"{t_kv['plain_ms']:.4f}, bound {t_kv['bound_ms']:.5f}); SDPA autograd "
                  f"{sdpa:.4f} ms; dq rows bit-equal {bits}, errors {err_q:.1e} / {err_kv:.1e}, "
                  f"{sp} shards' dK / dV summed against the full kernel {err_sum:.1e}",
                  flush=True)
            if dtype == torch.bfloat16:
                add("attn_bwd_dq_gathered", calls, t_q, err_q)
                add("attn_bwd_dkdv_gathered", calls, t_kv, max(err_kv, err_sum))
                per_call["attn_bwd_pair_sdpa_ms"] += calls * sdpa
    print(f"per sharded 256 px guidance call (bf16, batch 1, sp {sp}, one shard): "
          + "; ".join(f"{k} {v['ms']:.4f} ms (device {v['device_ms']:.4f}, plain "
                      f"{v['plain_ms']:.4f}, bound {v['bound_ms']:.4f})"
                      for k, v in per_call.items() if isinstance(v, dict))
          + f"; SDPA autograd for the attention pairs {per_call['attn_bwd_pair_sdpa_ms']:.4f} ms",
          flush=True)
    return {"per_call": per_call, "shapes": rows}


def guidance_probe_input():
    """The fixed input of phase 22(c)'s guidance gradient: one 256 px image
    and its timestep."""
    g = torch.Generator("cuda").manual_seed(22)
    return (torch.randn(1, 256, 256, 3, device="cuda", generator=g),
            torch.full((1,), 500.0, device="cuda"))


def spatial_guided_golden(counts: dict) -> dict:
    """Phase 22(b): the toy32 guided golden (tests/fixtures/
    toy_adm32_guided_golden.json; fp32, TF32 off) at sp = 2, the ADM and
    the classifier sharded, two processes on cuda:0 (gloo): within
    HQ_PSNR_TOL of the JAX package's PSNR on both ranks, their finals
    bit-equal, each rank's launches and collectives, the backward's
    included, exact. `counts`: the module counts of the toy ADM and
    classifier, and their 3x3 convolutions."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables, n_model_calls

    golden = json.loads(GUIDED_GOLDEN.read_text())
    want_psnr = golden["tiers"]["toy32"]["psnr"]
    proto = golden["protocol"]
    calls = n_model_calls(build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=proto["timestep_respacing"],
        schedule_jump_params=proto["schedule_jump_params"]))
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spatial_processes("guided_golden", 2, [], Path(tmp))
    r = {"psnr": [x["psnr"] for x in ranks], "jax_psnr": want_psnr,
         "per_image_max_abs_vs_jax": ranks[0]["per_image"],
         "seconds": [x["seconds"] for x in ranks],
         "process_seconds": [x["process_seconds"] for x in ranks],
         "ranks_bit_equal": len({x["sha256"] for x in ranks}) == 1, "model_calls": calls,
         "spatial_launches": ranks[0]["spatial_launches"],
         "collectives": ranks[0]["collectives"],
         "backward_collectives": ranks[0]["backward_collectives"],
         "scan_refused": check_gloo_resolution("(b) loop resolution", ranks)}
    print(f"(b) toy32 guided golden at sp 2 (two processes on cuda:0, gloo): PSNR {r['psnr']} "
          f"(JAX {want_psnr:.4f}), per-image max |x - JAX| "
          f"{['%.2e' % e for e in r['per_image_max_abs_vs_jax']]}, {r['seconds']} s in the "
          f"sampler ({calls} model calls); ranks' finals bit-equal {r['ranks_bit_equal']}; "
          f"launches {ranks[0]['launches']} / {r['spatial_launches']}, collectives "
          f"{r['collectives']}, backward {r['backward_collectives']}", flush=True)
    if not r["ranks_bit_equal"] or any(abs(p - want_psnr) > HQ_PSNR_TOL for p in r["psnr"]):
        raise AssertionError(f"spatial guided golden: {r}")
    _check_guided_counts("toy32 guided golden", ranks, calls, **counts)
    return r


def _check_guided_counts(what: str, ranks: list, calls: int, n_gn: int, n_attn: int,
                         n_conv: int, n_gn_c: int, n_attn_c: int, n_conv_c: int) -> None:
    """Each rank's launches and collectives of `calls` guided model calls at
    sp > 1 against the module counts of the UNet (n_*) and the classifier
    (n_*_c, its attention pool among the attentions: the pool runs whole
    on every rank, its attention and backward the Tq == Tk launches)."""
    sharded_attn = n_attn + n_attn_c - 1
    want = dict(dict.fromkeys(ops.spatial_launch_counts(), 0),
                groupnorm_partial=(n_gn + n_gn_c) * calls,
                groupnorm_finalize=(n_gn + n_gn_c) * calls,
                attention_gathered=sharded_attn * calls, gn_bwd_partial=n_gn_c * calls,
                gn_bwd_finalize=n_gn_c * calls, attn_bwd_dq_gathered=(n_attn_c - 1) * calls,
                attn_bwd_dkdv_gathered=(n_attn_c - 1) * calls)
    want_launches = dict(expected_launches(), groupnorm_apply=(n_gn + n_gn_c) * calls,
                         gn_bwd_dx=n_gn_c * calls, attention=calls, attn_bwd_dq=calls,
                         attn_bwd_dkdv=calls)
    # rows: the UNet's output, the classifier's pooled map, the gradient
    want_coll = dict(halo=(n_conv + n_conv_c) * calls, groupnorm=(n_gn + n_gn_c) * calls,
                     attention=sharded_attn * calls, rows=3 * calls, batch=0)
    want_bwd = dict(halo_grad=n_conv_c * calls, groupnorm_grad=n_gn_c * calls,
                    attention_grad=(n_attn_c - 1) * calls)
    for x in ranks:
        got = (x["spatial_launches"], x["launches"], x["collectives"],
               x["backward_collectives"])
        if got != (want, want_launches, want_coll, want_bwd):
            raise AssertionError(f"{what} rank {x['rank']}: launches {got[1]} / {got[0]}, "
                                 f"collectives {got[2]} / {got[3]}; want {want_launches} / "
                                 f"{want}, {want_coll} / {want_bwd}")


def spatial_guided_hq(counts: dict) -> tuple[dict, dict]:
    """Phase 22(c): configs/hq/inet256.yml guided at full width, bf16: the
    553.8M ADM with `dense_adm_weights` (random weights from seed 1234,
    the layers the init zeroes drawn, through --ckpt: with the init's zero
    head eps would be 0, and the tile would move by the guidance term
    alone), the 54.1M classifier with `cc_classifier`'s dense random
    weights from seed 1234 (--classifier_ckpt: with the init's zero layers
    most of its backward would carry zeros); cut to 10 model calls
    (respacing 10, no jumps), one 256 px tile (4x SR with --resize_y of a
    64 x 64 PNG): --sp 1 in this process, --sp 2 as two processes on
    cuda:0 (gloo). Seconds per tile and per call at each; the guidance
    gradient of the same classifier at one input (`guidance_probe_input`)
    at sp 2 against sp 1 within SP_GUIDED_GRAD_TOL, the ranks' bit-equal;
    the finals' PSNR against each other (the sharded ADM forward and the
    sharded guidance together) at least SP_GUIDED_PSNR_MIN, the ranks'
    bit-equal; launches and collectives per shard exact. Returns (stats,
    launches of rank 0)."""
    import hq_main_torch
    from ddnm_tpu_torch.data.io import load_image, save_image
    from ddnm_tpu_torch.models import classifier_guidance_fn

    conf = INET256.read_text()
    for old, new in (('timestep_respacing: "100"', 'timestep_respacing: "10"'),
                     ("t_T: 100\n  n_sample: 1\n  jump_length: 10\n  jump_n_sample: 3",
                      "t_T: 10\n  n_sample: 1\n  jump_length: 1\n  jump_n_sample: 1")):
        if conf.count(old) != 1:
            raise AssertionError(f"configs/hq/inet256.yml: expected one {old!r}")
        conf = conf.replace(old, new)
    calls = 10
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "inet256_sp.yml").write_text(conf)
        img = load_image(REPO / "exp" / "datasets" / "imagenet" / "00000.png")
        save_image(img[:256, :256].reshape(64, 4, 64, 4, 3).mean(axis=(1, 3)), tmp / "y64.png")
        dense_adm_weights(INET256, tmp / "inet256_dense.pt")
        clf = cc_classifier()
        torch.save(clf.state_dict(), tmp / "clf_dense.pt")
        x, t = guidance_probe_input()
        grad1 = classifier_guidance_fn(clf, 951, 1.0)(x, t).cpu()
        clf32 = cc_classifier(dtype=torch.float32)
        ref32 = classifier_guidance_fn(clf32, 951, 1.0)(x, t).cpu()
        del clf, clf32
        torch.cuda.empty_cache()
        argv = ["--config", str(tmp / "inet256_sp.yml"), "--path_y", str(tmp / "y64.png"),
                "--deg", "sr_averagepooling", "--scale", "4", "--resize_y", "--class", "951",
                "--ckpt", str(tmp / "inet256_dense.pt"), "--seed", "1234", "--classifier_ckpt",
                str(tmp / "clf_dense.pt"), "--dtype", "bfloat16", "--device", "cuda:0"]
        ops.reset_launch_counts()
        one = hq_main_torch.main(argv + ["-i", str(tmp / "sp1")])
        launches_one = ops.launch_counts()
        torch.cuda.empty_cache()
        ranks = spatial_processes("guided_hq", 2, [str(tmp / "clf_dense.pt")]
                                  + argv + ["--sp", "2", "-i", str(tmp / "sp2")], tmp)
        grad2 = torch.load(tmp / "guided_hq_rank0.grad.pt")
        a = load_image(tmp / "sp2" / "final.png")
        b = load_image(tmp / "sp1" / "final.png")
    scale = float(grad1.abs().max())
    grad_err = float((grad2 - grad1).abs().max()) / scale
    bf16_err = float((grad1 - ref32).abs().max()) / float(ref32.abs().max())
    psnr = 10.0 * math.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))
    per_call = {k: v / calls for k, v in {**ranks[0]["launches"],
                                         **ranks[0]["spatial_launches"]}.items() if v}
    stats = {"model_calls": calls, "sp1_seconds_per_tile": one["stats"]["seconds_per_tile"],
             "sp2_seconds_per_tile": [x["stats"]["seconds_per_tile"] for x in ranks],
             "sp2_process_seconds": [x["process_seconds"] for x in ranks],
             "sp1_seconds_per_call": one["stats"]["seconds_per_tile"] / calls,
             "sp2_seconds_per_call": ranks[0]["stats"]["seconds_per_tile"] / calls,
             "ranks_bit_equal": len({x["sha256"] for x in ranks}) == 1,
             "grad_ranks_bit_equal": len({x["grad_sha256"] for x in ranks}) == 1,
             "grad_sp2_vs_sp1": grad_err, "grad_bf16_vs_fp32_sp1": bf16_err,
             "sp2_vs_sp1_psnr": psnr, "launches_per_shard_per_call": per_call,
             "collectives_per_call": {k: v / calls for k, v in
                                      ranks[0]["collectives"].items()},
             "backward_collectives_per_call": {k: v / calls for k, v in
                                               ranks[0]["backward_collectives"].items()}}
    print(f"(c) inet256 guided (full width, bf16, {calls} model calls a tile): "
          f"{stats['sp1_seconds_per_tile']:.3f} s per tile at sp 1, "
          f"{stats['sp2_seconds_per_tile']} at sp 2 (two processes on cuda:0, gloo): "
          f"{stats['sp1_seconds_per_call']:.4f} / {stats['sp2_seconds_per_call']:.4f} s per "
          f"call; guidance gradient at sp 2 against sp 1: max |d| / max |sp 1| {grad_err:.3e} "
          f"(bf16 sp 1 against fp32 {bf16_err:.3e}), ranks bit-equal "
          f"{stats['grad_ranks_bit_equal']}; final at sp 2 against sp 1 PSNR {psnr:.2f} dB, "
          f"ranks bit-equal {stats['ranks_bit_equal']}; per shard and call {per_call}, "
          f"collectives {stats['collectives_per_call']}, backward "
          f"{stats['backward_collectives_per_call']}", flush=True)
    if (not stats["ranks_bit_equal"] or not stats["grad_ranks_bit_equal"]
            or not grad_err <= SP_GUIDED_GRAD_TOL or psnr < SP_GUIDED_PSNR_MIN):
        raise AssertionError(f"inet256 guided at sp 2: {stats}")
    n = counts
    if launches_one != expected_launches((n["n_gn"] + n["n_gn_c"]) * calls,
                                         (n["n_attn"] + n["n_attn_c"]) * calls,
                                         n["n_gn_c"] * calls, n["n_attn_c"] * calls):
        raise AssertionError(f"inet256 guided at sp 1: launches {launches_one}")
    _check_guided_counts("inet256 guided", ranks, calls, **counts)
    return stats, {**ranks[0]["launches"], **ranks[0]["spatial_launches"]}


# ------------------------------------------------------------------ phase 23

EXPORT_GOLDEN = REPO / "tests" / "fixtures" / "toy_export_golden.json"
EXPORT_GOLDEN_TOL = 1e-3  # max abs, fp32 trajectories on the card against JAX's artifacts
MOVED_TOL = 1e-4  # max abs, a CPU-built artifact on the card against its CPU run
# the flag step through its artifact against the eager step, bf16 (the same
# kernels and convolutions in the same order: bit-equal expected, printed)
FLAG_STEP_TOL = 1e-2


def export_golden_keys(device) -> torch.Tensor:
    """The golden's per-image keys, jax.random.key_data(PRNGKey(7)) and
    PRNGKey(8) (a seed s < 2^32 gives the words (0, s)), as int64."""
    return torch.tensor([[0, 7], [0, 8]], dtype=torch.int64, device=device)


def export_golden_case(kind: str, device) -> dict:
    """One run of the serving golden (tests/fixtures/toy_export_golden.json,
    tools/emit_torch_export_golden.py) in the port: the fixture's model on
    `device` (fp32), the operator, the schedule or tables, the export
    function's keyword arguments, the inputs in the artifact's order and the
    JAX artifact's final x."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.sampling import build_schedule
    from ddnm_tpu_torch.sampling.posterior import build_posterior_tables

    golden = json.loads(EXPORT_GOLDEN.read_text())
    p = golden["protocol"][kind]
    paths = sorted((REPO / "exp" / "datasets" / "toy32").glob("*.png"))[:2]
    gt = torch.from_numpy(np.stack([load_image(q) for q in paths]) * 2.0 - 1.0).float()
    nhwc = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))
    x_init = nhwc(np.random.RandomState(p["x_init_seed"]).randn(2, 3, 32, 32).astype(np.float32))
    if kind == "simplified":
        model = toy_ddpm(device, p)
        op = build_functional_operator(p["deg"], image_size=32, deg_scale=p["deg_scale"],
                                       device=device)
        betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                      num_diffusion_timesteps=1000)
        sched = build_schedule(betas=betas, t_sampling=p["t_sampling"],
                               travel_length=p["travel_length"],
                               travel_repeat=p["travel_repeat"])
        y = op.A(gt.to(device))
        inputs = (x_init.to(device), y)
        kw = dict(batch=2, image_size=32, y_shape=tuple(y.shape), eta=p["eta"],
                  sigma_y=p["sigma_y"], per_image_keys=True)
        calls = int((~sched.is_travel).sum())
        return dict(model=model, operator=op, schedule=sched, kw=kw, calls=calls, protocol=p,
                    inputs=inputs + (export_golden_keys(device),),
                    golden=decode_f32(golden["runs"][kind]))
    model = toy_adm(device)
    op = build_functional_operator("inpainting", image_size=32,
                                   mask=np.ones((32, 32, 1), np.float32), device=device)
    ctx = torch.from_numpy((np.random.RandomState(p["ctx_seed"]).random((2, 32, 32, 1))
                            > p["ctx_keep_above"]).astype(np.float32)).to(device)
    paste_mask = torch.from_numpy((np.random.RandomState(p["paste_mask_seed"]).random(
        (2, 32, 32, 1)) > p["paste_mask_above"]).astype(np.float32)).to(device)
    paste_content = torch.from_numpy(np.random.RandomState(p["paste_content_seed"]).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)).to(device)
    tables = build_posterior_tables(
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing=p["timestep_respacing"],
        schedule_jump_params=p["schedule_jump_params"])
    apy = op.Ap_ctx(op.A_ctx(gt.to(device), ctx), ctx)
    kw = dict(batch=2, image_size=32, clip_denoised=p["clip_denoised"], with_paste=True,
              with_ctx=True, per_image_keys=True)
    return dict(model=model, operator=op, schedule=tables, kw=kw, protocol=p,
                calls=int((~tables.is_travel).sum()),
                inputs=(x_init.to(device), apy, paste_mask, paste_content, ctx,
                        export_golden_keys(device)),
                golden=decode_f32(golden["runs"][kind]))


def export_case(case: dict, device=None, path=None) -> bytes:
    """The trajectory artifact of an export_golden_case, on `device` (the
    model's by default)."""
    from ddnm_tpu_torch import serving

    fn = (serving.export_simplified_trajectory if "y_shape" in case["kw"]
          else serving.export_posterior_trajectory)
    return fn(case["model"], case["operator"], case["schedule"], device=device, path=path,
              **case["kw"])


def op_route_host_us(shapes: dict, iters: int = 2000) -> dict:
    """Host microseconds per call of each forward kernel, back to back, through
    its ddnm:: custom op against the direct wrapper call, at one main-path
    shape each (bf16, batch 8): the host's time to issue `iters` calls (the
    card runs each in less, so the host sets the pace), then a synchronize."""
    from ddnm_tpu_torch.ops.groupnorm import _stats_affine_buffer

    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(shapes["groupnorm"], device="cuda", generator=gen).to(torch.bfloat16)
    c = x.shape[-1]
    scale, bias = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    ab = _stats_affine_buffer(x, scale, bias, 32, 1e-6, None, None)
    a, b = ab[0], ab[1]
    q = torch.randn(shapes["attention"], device="cuda", generator=gen).to(torch.bfloat16)
    s = q.shape[-1] ** -0.5
    pairs = {
        "gn_stats_affine": (lambda: _stats_affine_buffer(x, scale, bias, 32, 1e-6, None, None),
                            lambda: torch.ops.ddnm.gn_stats_affine(x, scale, bias, None, None,
                                                                   32, 1e-6)),
        "gn_apply": (lambda: _apply(x, a, b, True),
                     lambda: torch.ops.ddnm.gn_apply(x, a, b, True)),
        "attention": (lambda: _kernel_attention(q, q, q, s),
                      lambda: torch.ops.ddnm.attention(q, q, q, s)),
    }
    out = {}
    for name, (direct, via_op) in pairs.items():
        row = {"shape": list(shapes["attention" if name == "attention" else "groupnorm"])}
        # direct, op, op, direct: the two orders' means
        times = {"direct_us": [], "op_us": []}
        for key, fn in (("direct_us", direct), ("op_us", via_op), ("op_us", via_op),
                        ("direct_us", direct)):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times[key].append((time.perf_counter() - t0) / iters * 1e6)
            torch.cuda.synchronize()
        row.update({k: sum(v) / len(v) for k, v in times.items()})
        row["op_minus_direct_us"] = row["op_us"] - row["direct_us"]
        out[name] = row
        print(f"{name:16s} {str(row['shape']):18s} host us per call back to back: direct "
              f"{row['direct_us']:.2f}, through torch.ops.ddnm {row['op_us']:.2f} "
              f"(+{row['op_minus_direct_us']:.2f})", flush=True)
    return out


def call_profile(fn) -> dict:
    """One call of fn() on an idle card: the host's ms to issue it (its wall
    time without a synchronize, which is the call's host side unless the
    launch queue fills), and from torch.profiler the card's busy ms (the
    sum of its device events) and the CUDA kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    return {"host_ms": host_ms,
            "busy_ms": sum(e.time_range.elapsed_us() for e in events
                           if e.device_type == cuda) / 1e3,
            "cuda_launches": sum(e.device_type == torch.autograd.DeviceType.CPU
                                 and e.name.startswith("cudaLaunchKernel") for e in events)}


def serving_flag_step(n_gn: int, n_attn: int, tmp: Path) -> tuple[dict, dict]:
    """Phase 23(a): the flag DDPM (113.7M, bf16 torso, flag_ddpm256.pt),
    simplified DDNM+ 4x average-pooling SR, batch 8, 256 px: the step
    exported on the card, saved, loaded, run once, held to the eager step
    (serving.py's step module called eagerly: the direct kernel calls) on
    the same inputs and threefry key; launches per step through the
    artifact equal the eager step's; ms per step of both. Returns (stats,
    the artifact's launches)."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch import serving
    from ddnm_tpu_torch.models import DDPMUNet, cast_torso
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.runner import load_checkpoint

    model = DDPMUNet(resolution=256)
    load_checkpoint(model, FLAG_PT)
    model = cast_torso(model, torch.bfloat16).cuda().eval()
    op = build_functional_operator("sr_averagepooling", image_size=256, deg_scale=4,
                                   device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2323)
    x = torch.randn(8, 256, 256, 3, device="cuda", generator=gen)
    y = op.A(torch.rand(8, 256, 256, 3, device="cuda", generator=gen) * 2 - 1)
    abar = sch.alpha_bar_table(sch.get_beta_schedule(
        "linear", beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=1000))
    t, t_next = 499, 489  # a step of the main path's 100 (skip 10)
    args = (x, y, torch.tensor([0, 7], dtype=torch.int64, device="cuda"),
            torch.tensor(float(t), device="cuda"),
            torch.tensor(float(abar[t + 1]), device="cuda"),
            torch.tensor(float(abar[t_next + 1]), device="cuda"))
    path = tmp / "flag_step.pt2"
    t0 = time.perf_counter()
    blob = serving.export_simplified_step(model, op, batch=8, image_size=256,
                                          y_shape=tuple(y.shape), path=path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = serving.load_exported(path)
    load_s = time.perf_counter() - t0
    eager = serving._SimplifiedStep(model, op, 0.85, 0.0)
    with torch.no_grad():
        ops.reset_launch_counts()
        x_art, x0_art = step(*args)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        ops.reset_launch_counts()
        x_eager, x0_eager = eager(*args)
        torch.cuda.synchronize()
        launches_eager = ops.launch_counts()
        ms_artifact = cuda_ms(lambda: step(*args), iters=10, warmup=2)
        ms_eager = cuda_ms(lambda: eager(*args), iters=10, warmup=2)
        ms_artifact_again = cuda_ms(lambda: step(*args), iters=10, warmup=0)
        prof_artifact, prof_eager = call_profile(lambda: step(*args)), call_profile(
            lambda: eager(*args))
    err = max(float((x_art - x_eager).abs().max()), float((x0_art - x0_eager).abs().max()))
    bit_equal = bool(torch.equal(x_art, x_eager) and torch.equal(x0_art, x0_eager))
    want = expected_launches(n_gn, n_attn)
    stats = {"export_seconds": export_s, "load_seconds": load_s, "artifact_bytes": len(blob),
             "max_abs_vs_eager": err, "bit_equal": bit_equal, "launches": launches,
             "launches_eager": launches_eager, "ms_per_step_artifact": ms_artifact,
             "ms_per_step_artifact_again": ms_artifact_again, "ms_per_step_eager": ms_eager,
             "profile_artifact": prof_artifact, "profile_eager": prof_eager,
             "finite": bool(torch.isfinite(x_art).all())}
    print(f"(a) flag step (bf16, batch 8, 256 px): exported on the card in {export_s:.2f} s "
          f"({len(blob)} bytes), loaded in {load_s:.2f} s; against the eager step max abs "
          f"{err:.3e}, bit-equal {bit_equal}; launches {launches} (eager {launches_eager}); "
          f"ms per step artifact {ms_artifact:.3f} / {ms_artifact_again:.3f}, eager "
          f"{ms_eager:.3f}; one step's host ms / busy ms / CUDA launches: artifact "
          f"{prof_artifact['host_ms']:.3f} / {prof_artifact['busy_ms']:.3f} / "
          f"{prof_artifact['cuda_launches']}, eager {prof_eager['host_ms']:.3f} / "
          f"{prof_eager['busy_ms']:.3f} / {prof_eager['cuda_launches']}", flush=True)
    if launches != want or launches_eager != want:
        raise AssertionError(f"flag step: launches {launches} / eager {launches_eager}, "
                             f"want {want}")
    if not stats["finite"] or not err <= FLAG_STEP_TOL:
        raise AssertionError(f"flag step through its artifact: {stats}")
    return stats, launches


def serving_toy_trajectories(tmp: Path) -> tuple[dict, dict]:
    """Phase 23(b) and (c): the toy32 trajectories of the serving golden in
    fp32 (TF32 off). (b) the posterior one (toy_adm32.pt, paste + ctx,
    per-image keys) exported on the card, and the simplified one
    (toy_ddpm32.pt, a travel step) exported with CPU tensors and moved to
    the card, each within EXPORT_GOLDEN_TOL of the JAX artifact's final x;
    (c) the simplified one's card run within MOVED_TOL of its CPU run.
    Launches through each exactly the model calls' kernels. Returns
    (stats, launches of the simplified one on the card)."""
    from ddnm_tpu_torch import serving

    out, launches_of = {}, {}
    for kind, where in (("posterior", "cuda"), ("simplified", "cpu")):
        case = export_golden_case(kind, where)
        t0 = time.perf_counter()
        export_case(case, path=tmp / f"{kind}.pt2")
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        call = serving.load_exported(tmp / f"{kind}.pt2", device="cuda")
        load_s = time.perf_counter() - t0
        inputs = tuple(a.cuda() for a in case["inputs"])
        with torch.no_grad():
            ops.reset_launch_counts()
            x, _ = call(*inputs)
            torch.cuda.synchronize()
            launches_of[kind] = ops.launch_counts()
        n_gn, n_attn = module_counts(case["model"])
        want = expected_launches(n_gn * case["calls"], n_attn * case["calls"])
        err = float(np.abs(x.cpu().numpy() - case["golden"]).max())
        r = {"export_seconds": export_s, "load_seconds": load_s, "exported_on": where,
             "model_calls": case["calls"], "max_abs_vs_jax": err,
             "launches": launches_of[kind]}
        if where == "cpu":
            cpu_call = serving.load_exported(tmp / f"{kind}.pt2")
            with torch.no_grad():
                x_cpu, _ = cpu_call(*case["inputs"])
            r["max_abs_card_vs_cpu"] = float((x.cpu() - x_cpu).abs().max())
        print(f"({'b' if where == 'cuda' else 'b, c'}) toy32 {kind} trajectory (fp32, "
              f"{case['calls']} model calls, exported on {where} in {export_s:.2f} s, loaded "
              f"onto the card in {load_s:.2f} s): max abs against the JAX artifact {err:.3e}"
              + (f", card against its CPU run {r['max_abs_card_vs_cpu']:.3e}"
                 if where == "cpu" else "") + f"; launches {launches_of[kind]}", flush=True)
        if launches_of[kind] != want:
            raise AssertionError(f"toy32 {kind} artifact: launches {launches_of[kind]}, "
                                 f"want {want}")
        if not err <= EXPORT_GOLDEN_TOL or r.get("max_abs_card_vs_cpu", 0.0) > MOVED_TOL:
            raise AssertionError(f"toy32 {kind} artifact: {r}")
        out[kind] = r
    return out, launches_of["simplified"]


TRAIN_GOLDEN = REPO / "tests" / "fixtures" / "toy_train_golden.json"
# phase 24's toy models: the port's trainer module (tools/*_torch.py) and
# the committed weights the steps start from
TRAIN_MODELS = {"ddpm": ("train_toy_golden_torch", "toy_ddpm32.pt"),
                "adm": ("train_toy_adm_golden_torch", "toy_adm32.pt"),
                "clf": ("train_toy_classifier_golden_torch", "toy_clf32.pt")}
# the fp32 attention backward at the DDPM AttnBlocks' heads: the flagship's
# 16 px and 8 px maps (C = 512) and big128's 16 px map (C = 256), batch 16
TRAIN_ATTENTION_SHAPES = ((16, 256, 512), (16, 64, 512), (16, 256, 256))


def _tools_module(name: str):
    import importlib

    for sub in ("tools", "tools/experiments"):
        if str(REPO / sub) not in sys.path:
            sys.path.insert(0, str(REPO / sub))
    return importlib.import_module(name)


def train_golden_run(name: str, device, golden: dict | None = None) -> dict:
    """The steps of tests/fixtures/toy_train_golden.json's protocol on the
    port: the toy model `name` (ddpm, adm, clf) from its committed weights,
    its trainer's step (tools/train_toy_*_torch.py) at the protocol's
    batch and learning rate, keys from PRNGKey(seed) split before every
    step, fp32: every loss, each leaf's gradient L2 norm at step 1, each
    leaf's parameter sum after the last step, the first batch's checksum."""
    from ddnm_tpu_torch import training
    from ddnm_tpu_torch.data.checkpoints import load_checkpoint
    from ddnm_tpu_torch.sampling import threefry

    golden = golden or json.loads(TRAIN_GOLDEN.read_text())
    proto = golden["protocol"]
    mod_name, fixture = TRAIN_MODELS[name]
    mod = _tools_module(mod_name)
    model = mod.build_model("cpu")
    load_checkpoint(model, REPO / "tests" / "fixtures" / fixture)
    model = model.to(device).train()
    spec = mod.make_spec(proto["steps"], proto["batch"], proto["lr"][name])
    abar = torch.as_tensor(spec.abar, device=device)
    opt = training.make_optimizer(model, spec.lr)
    key = threefry.prng_key(proto["seed"], device)
    losses, grad_norms, first = [], {}, {}
    for i in range(proto["steps"]):
        ks = threefry.split(key)
        key, k = ks[0], ks[1]
        if i == 0:
            b = training.draw_batch(k, spec, device)
            first = {"x0_sum": float(b["x0"].double().sum()),
                     "x0_abs": float(b["x0"].double().abs().sum()),
                     "t_sum": int(b["t"].sum()), "noise_sum": float(b["noise"].double().sum()),
                     "noise_abs": float(b["noise"].double().abs().sum())}
        loss, _ = training.train_step(model, opt, k, spec, i, abar)
        losses.append(float(loss))
        if i == 0:
            grad_norms = {n: float(q.grad.double().norm()) for n, q in model.named_parameters()}
    return {"losses": losses, "grad_norms_step1": grad_norms,
            "param_sums_final": {n: float(q.detach().double().sum())
                                 for n, q in model.named_parameters()},
            "first_batch": first, "lr": spec.lr, "steps": proto["steps"],
            "sizes": {n: q.numel() for n, q in model.named_parameters()}}


def check_train_golden(name: str, got: dict, golden: dict) -> dict:
    """Hold a `train_golden_run` to the JAX golden: each loss within 1e-4
    relative, each leaf's step-1 gradient norm within 1e-3 relative (or
    1e-6 of the largest leaf's norm, for a leaf whose gradient is 0 in
    exact arithmetic), each
    leaf's parameter sum within 3 x 2 x lr x its size (Adam's first steps
    move a near-zero gradient by +-lr whatever its sign: bits are not the
    gate), the first batch's sums within 1e-5 relative (float32 draws) and
    its timesteps exact. Raises on a miss; returns the worst of each."""
    want = golden[name]
    if set(got["grad_norms_step1"]) != set(want["grad_norms_step1"]):
        raise AssertionError(f"{name}: the port's leaves differ from the golden's")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    # a leaf whose gradient is 0 in exact arithmetic (a key bias under the
    # softmax, a bias a GroupNorm follows) holds rounding noise alone: its
    # norm is held to 1e-6 of the largest leaf's instead
    floor = 1e-6 * max(want["grad_norms_step1"].values())
    norm_rel = max(abs(got["grad_norms_step1"][k] - v) / max(abs(v), 1e3 * floor)
                   for k, v in want["grad_norms_step1"].items())
    sum_share = max(abs(got["param_sums_final"][k] - v)
                    / (3 * 2 * got["lr"] * got["sizes"][k])
                    for k, v in want["param_sums_final"].items())
    fb, wb = got["first_batch"], want["first_batch"]
    batch_rel = max(abs(fb[k] - wb[k]) / max(abs(wb[k]), 1.0)
                    for k in ("x0_sum", "x0_abs", "noise_sum", "noise_abs"))
    out = {"losses": got["losses"], "golden_losses": want["losses"], "loss_rel": loss_rel,
           "grad_norm_rel": norm_rel, "param_sum_share_of_gate": sum_share,
           "first_batch_rel": batch_rel, "t_sum": fb["t_sum"]}
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-3 and sum_share <= 1.0
            and batch_rel <= 1e-5 and fb["t_sum"] == wb["t_sum"]):
        raise AssertionError(f"{name}: train steps against the JAX golden: {out}")
    return out


def training_kernels(gen: torch.Generator) -> dict:
    """Phase 24 (a): gn_bwd_param (the backward finalize with the parameter
    gradients) against its plain version at every
    distinct norm shape of the flagship at batch 16 (with and without
    SiLU) and with FiLM at a toy ADM shape; the training backward of a
    norm and the attention backward pair at the DDPM heads against their
    plain versions and autograd, timed at the main shapes."""
    from ddnm_tpu_torch.models import DDPMUNet

    flag = _tools_module("train_flagship_golden_torch")
    model = DDPMUNet(**flag.DDPM_KW).cuda().eval()
    shapes = grad_shapes(model, torch.zeros(1, 256, 256, 3, device="cuda"))
    del model
    torch.cuda.empty_cache()
    gn = sorted({((16,) + key[1][1:], key[2]) for key in shapes if key[0] == "gn"})
    results = {"gn_param": [], "gn_train": [], "attn_bwd": []}
    main_gn = ((16, 256, 256, 128), True)  # the first ResnetBlock's norm1, 256 px
    for shape, swish in gn:
        results["gn_param"].append(check_backward("gn_param", shape, torch.float32, gen, swish,
                                                  timed=(shape, swish) == main_gn))
        results["gn_train"].append(check_backward("gn_train", shape, torch.float32, gen, swish,
                                                  timed=(shape, swish) == main_gn))
    for kind in ("gn_param", "gn_train"):  # FiLM: the toy ADM's 16 px ResBlocks
        results[kind].append(check_backward(kind, (16, 16, 16, 64), torch.float32, gen,
                                            True, True, timed=False))
    for shape in TRAIN_ATTENTION_SHAPES:
        results["attn_bwd"].append(check_backward("attn_bwd", shape, torch.float32, gen))
    for kind, rows in results.items():
        for r in rows:
            t = (f", {r['ms']:.4f} ms ({r['device_ms']:.4f} on the device), plain "
                 f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} ({r['bound_by']})"
                 + (f", library {r['library_ms']:.4f} ({r['library_device_ms']:.4f} on the "
                    f"device)" if r.get("library_ms") is not None else "")
                 if "ms" in r else "")
            print(f"{kind} {r['shape']} fp32 swish={r['swish']} film={r['film']}: max abs "
                  f"{r['max_abs_err']:.3e}, worst output {r['worst']} at "
                  f"{r['err_over_tol']:.3f} of its tol {r['tol']:.3e}"
                  + (f", autograd worst {r['autograd_worst']} {r['autograd_err']:.3e} at "
                     f"{r['autograd_err_over_tol']:.3f} of its tol" if "autograd_err" in r
                     else "")
                  + t, flush=True)
    return {"norm_shapes": len(gn), **results}


def train_golden_parity() -> dict:
    """Phase 24 (b): the three toy models' train steps against the JAX
    golden on the card, fp32, TF32 off, cuDNN deterministic."""
    golden = json.loads(TRAIN_GOLDEN.read_text())
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for name in TRAIN_MODELS:
            ops.reset_launch_counts()
            got = train_golden_run(name, "cuda", golden)
            counts = ops.launch_counts()
            if not (counts["gn_bwd_param"] and counts["gn_bwd_sums"] == counts["gn_bwd_param"]
                    and counts["gn_bwd_reduce"] == 0):
                raise AssertionError(f"{name}: the train steps did not take the training "
                                     f"backward kernels: {counts}")
            out[name] = check_train_golden(name, got, golden)
            print(f"train golden {name}: losses {got['losses']} (JAX {golden[name]['losses']}),"
                  f" loss rel {out[name]['loss_rel']:.2e}, grad norm rel "
                  f"{out[name]['grad_norm_rel']:.2e}, param sums at "
                  f"{out[name]['param_sum_share_of_gate']:.3f} of their gate", flush=True)
    finally:
        torch.backends.cudnn.deterministic = det
    return out


def flagship_training(tmp: Path) -> tuple[dict, dict]:
    """Phase 24 (c): 5 steps of the flagship trainer's loop (fresh 114M
    DDPM, 256 px, batch 16, fp32 with TF32 allowed, the mix drawn on the
    card) with every kernel's launches exact, one more step profiled and
    one timed, the export read back into a fresh UNet and a 2-step bf16
    simplified trajectory of it against the trained module's. Returns
    (stats, launches of the 5 steps)."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch import training
    from ddnm_tpu_torch.data.checkpoints import load_checkpoint
    from ddnm_tpu_torch.models import DDPMUNet, cast_torso
    from ddnm_tpu_torch.operators import build_functional_operator
    from ddnm_tpu_torch.sampling import build_schedule, sample_simplified, threefry

    flag = _tools_module("train_flagship_golden_torch")
    steps, batch, lr = 5, 16, 2e-4
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        model, result = flag.train(steps, batch, lr, tmp, device="cuda", log_every=1)
        launches = ops.launch_counts()
        trained = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        n_gn, n_attn = module_counts(model)
        want = expected_launches(steps * n_gn, steps * n_attn, 0, steps * n_attn,
                                 gn_bwd_sums=steps * n_gn, gn_bwd_param=steps * n_gn)
        want["gn_bwd_dx"] = steps * n_gn  # the training backward: sums, param, dx
        if launches != want or any(ops.spatial_launch_counts().values()):
            raise AssertionError(f"flagship training launches {launches} != {want}, spatial "
                                 f"{ops.spatial_launch_counts()}")
        losses = [row["loss"] for row in result["tail"]]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"flagship training losses {losses}")
        # one more step timed alone, and one profiled: busy and idle share
        spec = training.TrainSpec(kind="eps", res=256, batch=batch, lr=lr, steps=steps,
                                  data=_tools_module("train_mid_golden_torch").make_mix,
                                  abar=flag.mid._abar("ddpm"), cosine=True)
        abar = torch.as_tensor(spec.abar, device="cuda")
        opt = training.make_optimizer(model, lr)
        key = threefry.prng_key(2, "cuda")
        step = lambda: training.train_step(model, opt, key, spec, 0, abar)  # noqa: E731
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        prof = call_profile(step)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the export round trip
        fresh = DDPMUNet(**flag.DDPM_KW)
        load_checkpoint(fresh, tmp / "flag_ddpm256.pt")
        model.load_state_dict(trained)  # the weights of the 5 steps, which were exported
        if set(trained) != set(fresh.state_dict()) or not all(
                torch.equal(fresh.state_dict()[k], v.half().float()) for k, v in trained.items()):
            raise AssertionError("flagship export: the fresh UNet's weights are not the trained "
                                 "module's rounded to fp16")
        model.eval()
        fresh = fresh.cuda().eval()
        cast_torso(model, torch.bfloat16)
        cast_torso(fresh, torch.bfloat16)
        # a 2-step simplified DDNM+ trajectory (t = 500, then 0; 4x SR, zero
        # noise) of each
        key = threefry.prng_key(3, "cuda")
        x0, x_t = (threefry.normal(k, (2, 256, 256, 3)) for k in threefry.split(key))
        op = build_functional_operator("sr_averagepooling", image_size=256, deg_scale=4,
                                       device="cuda")
        sched = build_schedule(betas=sch.get_beta_schedule(
            "linear", beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=1000),
            t_sampling=2)
        zero = lambda gens, shape: torch.zeros(shape, device="cuda")  # noqa: E731
        with torch.no_grad():
            a, b = (sample_simplified(lambda x, t, m=m: m(x, t), x_t, op.A(x0.clamp(-1, 1)),
                                      op, sched, [None] * 2, noise_fn=zero)[0]
                    for m in (model, fresh))
        call_err = float((a - b).abs().max())
        call_tol = 3e-2 * max(1.0, float(b.abs().max()))
        if not call_err <= call_tol:
            raise AssertionError(f"flagship export: one bf16 sampling step of the reloaded UNet"
                                 f" {call_err:.3e} from the trained one's (> {call_tol:.3e})")
        stats = {"steps": steps, "batch": batch, "res": 256, "losses": losses,
                 "s_per_step_loop": result["seconds"] / steps, "s_per_step": step_s,
                 "profiled_step": prof, "busy_share": prof["busy_ms"] / (step_s * 1e3),
                 "peak_memory_gb": peak_gb, "params_m": training.param_count(model) / 1e6,
                 "launches_per_step": {k: v // steps for k, v in launches.items() if v},
                 "export_bf16_step_max_abs": call_err, "export_bf16_step_tol": call_tol}
        print(f"flagship training: losses {losses}, {step_s:.3f} s a step "
              f"({result['seconds'] / steps:.3f} s a step over the 5-step loop, its first "
              f"included), profiled step busy {prof['busy_ms']:.1f} ms of {step_s * 1e3:.1f} "
              f"(idle share {1 - stats['busy_share']:.3f}), peak memory {peak_gb:.2f} GB, "
              f"launches a step {stats['launches_per_step']}, export bf16 sampling step max abs "
              f"{call_err:.3e}", flush=True)
        del model, fresh, opt
        torch.cuda.empty_cache()
        return stats, launches
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ------------------------------------------------------------------ phase 25

# the five toy32 fp32 paths of phase 25(a); a DDNM schedule with time
# travel, a posterior jump schedule with undo steps
LOOP_PATHS = ("simplified", "svd", "multistep", "posterior", "guided")
LOOP_SCHED = dict(t_sampling=10, travel_length=2, travel_repeat=2)
LOOP_JUMP = dict(t_T=10, n_sample=1, jump_length=3, jump_n_sample=2)


def loop_driver_env(device) -> dict:
    """Phase 25(a)'s models, operators and inputs on `device`, built once:
    a graph's key holds the operator and the model by identity."""
    from ddnm_tpu_torch import schedules as sch
    from ddnm_tpu_torch.data.io import load_image
    from ddnm_tpu_torch.models import classifier_guidance_fn
    from ddnm_tpu_torch.operators import build_functional_operator, build_svd_operator
    from ddnm_tpu_torch.sampling import build_posterior_tables, build_schedule
    from ddnm_tpu_torch.sampling.ddnm import _nhwc_to_vec

    golden = json.loads(SOLVER_GOLDEN.read_text())
    paths = sorted((REPO / "exp" / "datasets" / "toy32").glob("*.png"))[:2]
    gt = torch.from_numpy(np.stack([load_image(q) for q in paths]) * 2.0 - 1.0).to(device)
    xt = np.random.RandomState(7).randn(2, 3, 32, 32).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(xt.transpose(0, 2, 3, 1))).to(device)
    betas = sch.get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                                  num_diffusion_timesteps=1000).astype(np.float32)
    sr = build_functional_operator("sr_averagepooling", image_size=32, deg_scale=4.0,
                                   device=device)
    masks = torch.ones(2, 32, 32, 1, device=device)
    masks[0, 8:20, 4:28] = 0.0
    masks[1, 14:30, 10:22] = 0.0
    inpaint = build_functional_operator("inpainting", image_size=32,
                                        mask=masks[0, ..., 0].cpu().numpy(), device=device)
    paste = torch.zeros(2, 32, 32, 1, device=device)
    paste[:, :8] = 1.0
    cs = build_svd_operator("cs_walshhadamard", channels=3, image_size=32, deg_scale=0.25,
                            device=device)
    post = lambda sigma_y: build_posterior_tables(  # noqa: E731
        betas=sch.named_beta_schedule("linear", 1000, use_scale=True),
        timestep_respacing="10", sigma_y=sigma_y, schedule_jump_params=LOOP_JUMP)
    model = toy_adm(device)
    return {"ddpm": toy_ddpm(device, golden["protocol"]["ddpm"]), "adm": model,
            "adm_fn": lambda x, t: model(x, t), "gt": gt, "xt": xt, "sr": sr,
            "inpaint": inpaint, "masks": masks, "paste": paste, "content": torch.flip(gt, (1,)),
            "cs": cs, "y_cs": cs.A(_nhwc_to_vec(gt)),
            "sched": build_schedule(betas=betas, **LOOP_SCHED),
            "tables": post(0.1), "tables_clean": post(0.0),
            "guidance": classifier_guidance_fn(toy_classifier(device), 2, 2.0)}


def loop_driver_run(env: dict, path: str, loop: str, noise: str, shift: float = 0.0):
    """One phase 25(a) trajectory: (its outputs, its launch counts, the
    noise source's next draws). `noise`: "gens" (per-image generators) or
    "key" (a KeyNoise of PRNGKey(3)); x_T moved by `shift`."""
    from ddnm_tpu_torch.sampling import sample_posterior, sample_simplified, sample_svd
    from ddnm_tpu_torch.sampling.rng import STREAM_SAMPLE, image_generators
    from ddnm_tpu_torch.sampling.threefry import KeyNoise, prng_key

    dev = env["xt"].device
    src = (KeyNoise(prng_key(3, dev)) if noise == "key"
           else image_generators(5, [0, 1], STREAM_SAMPLE, dev))
    xt = env["xt"] + shift
    ops.reset_launch_counts()
    if path in ("simplified", "multistep"):
        out = sample_simplified(env["ddpm"], xt, env["sr"].A(env["gt"]), env["sr"], env["sched"],
                                src, loop=loop,
                                solver="multistep" if path == "multistep" else "ddim")
    elif path == "svd":
        out = sample_svd(env["ddpm"], xt, env["y_cs"], env["cs"], env["sched"], src, loop=loop)
    elif path == "posterior":
        op, ctx = env["inpaint"], env["masks"]
        out = sample_posterior(env["adm_fn"], xt, op.Ap_ctx(op.A_ctx(env["gt"], ctx), ctx), op,
                               env["tables"], src, paste_mask=env["paste"],
                               paste_content=env["content"], op_ctx=ctx, loop=loop)
    else:
        out = sample_posterior(env["adm_fn"], xt, env["sr"].Ap(env["sr"].A(env["gt"])),
                               env["sr"], env["tables_clean"], src, guidance_fn=env["guidance"],
                               loop=loop)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    state = (src.key.clone() if noise == "key" else
             torch.stack([torch.randn(4, generator=g, device=dev) for g in src]))
    return out, launches, state


def loop_drivers_toy() -> dict:
    """Phase 25(a): the five toy32 fp32 paths through both drivers on the
    card (cuDNN deterministic, as the guidance gradient's bits need): for
    each path and noise source, the captured graph's first call and a
    replay on other inputs bit-equal to the eager loop, launch counts and
    the noise source's state after the call equal; then the phase 9 and 13
    goldens under an explicit loop="scan" (phases 9, 13 and 15 run the
    samplers on auto, the scan, already)."""
    import functools

    from ddnm_tpu_torch.sampling import graphs
    from ddnm_tpu_torch.sampling.posterior import sample_posterior

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        env = loop_driver_env("cuda")
        out = {}
        for path in LOOP_PATHS:
            for noise in ("gens", "key"):
                graphs.clear_graphs()
                row = {}
                for shift in (0.0, 0.5):
                    t0 = time.perf_counter()
                    host = loop_driver_run(env, path, "host", noise, shift)
                    t1 = time.perf_counter()
                    scan = loop_driver_run(env, path, "scan", noise, shift)
                    t2 = time.perf_counter()
                    equal = all(torch.equal(a, b) for a, b in zip(host[0], scan[0]))
                    if not (equal and host[1] == scan[1] and torch.equal(host[2], scan[2])):
                        raise AssertionError(
                            f"phase 25 {path} ({noise}, shift {shift}): scan against host "
                            f"bit-equal {equal}, launches {host[1]} / {scan[1]}, noise state "
                            f"equal {torch.equal(host[2], scan[2])}")
                    row[f"shift {shift}"] = {"host_s": t1 - t0, "scan_s": t2 - t1}
                (stats,) = graphs.graph_stats()
                row.update(launches={k: v for k, v in scan[1].items() if v},
                           capture_s=stats["capture_s"], instantiate_s=stats["instantiate_s"],
                           replays=stats["replays"], pool_bytes=stats["pool_bytes"])
                out[f"{path}/{noise}"] = row
                print(f"loop drivers toy32 {path:10s} {noise:4s}: scan bit-equal to host at "
                      f"capture and replay, launches and noise state equal; capture "
                      f"{stats['capture_s']:.3f} s, instantiate {stats['instantiate_s']:.3f} s, "
                      f"pool {stats['pool_bytes']} bytes, launches {row['launches']}",
                      flush=True)
        graphs.clear_graphs()
        scan = functools.partial(sample_posterior, loop="scan")
        want = json.loads(TOY_ADM_PSNR.read_text())[TASKS_HQ[0][0]]["ours_psnr"]
        psnr, _, _ = hq_golden_run(env["adm"], "cuda", TASKS_HQ[0], sample=scan)
        golden = json.loads(GUIDED_GOLDEN.read_text())["tiers"]["toy32"]["recorded_psnr"]
        g_psnr, _, per_image, _ = guided_golden_run(env["adm"], toy_classifier("cuda"), "cuda",
                                                    sample=scan)
        print(f"loop drivers goldens under scan: {TASKS_HQ[0][0]} PSNR {psnr:.4f} (JAX "
              f"{want:.4f}), guided PSNR {g_psnr:.4f} (JAX {golden:.4f}), per-image max "
              f"|x - JAX| {max(per_image):.2e}", flush=True)
        if abs(psnr - want) > HQ_PSNR_TOL or abs(g_psnr - golden) > HQ_PSNR_TOL:
            raise AssertionError("phase 25: a golden missed under loop='scan'")
        out["goldens"] = {"hq": psnr, "hq_golden": want, "guided": g_psnr,
                          "guided_golden": golden, "guided_per_image_max_abs": per_image}
        return out
    finally:
        torch.backends.cudnn.deterministic = deterministic


def loop_drivers_main_path() -> dict:
    """Phase 25(b): the main path at full width (the flag DDPM, bf16, batch
    8, 100 steps, sr_averagepooling) through both drivers
    (tools/time_loop_drivers.py `measure`): ms a step, capture and
    instantiate seconds, the device idle share of each, the pool's bytes;
    bit-equal outputs and equal launches."""
    spec = importlib.util.spec_from_file_location(
        "time_loop_drivers", REPO / "tools" / "time_loop_drivers.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    r = mod.measure("main")
    h, s = r["host"], r["scan"]
    print(f"loop drivers main path: host {h['ms_per_step']:.3f} ms a step, scan "
          f"{s['ms_per_step']:.3f} ms a step (first call {s['first_call_seconds']:.3f} s: "
          f"warm-up {s['warmup_seconds']:.3f} s, capture {s['capture_seconds']:.3f} s, "
          f"instantiate {s['instantiate_seconds']:.3f} s)", flush=True)
    print(f"loop drivers main path idle share: host {h['idle_share_unprofiled']} (busy "
          f"{h['device_busy_ms']:.1f} ms of {1e3 * h['seconds']:.1f}; profiled "
          f"{h['idle_share']} of {h['profiled_wall_ms']:.1f} ms), scan "
          f"{s['idle_share_unprofiled']} (busy {s['device_busy_ms']:.1f} ms of "
          f"{1e3 * s['seconds']:.1f}; profiled {s['idle_share']} of "
          f"{s['profiled_wall_ms']:.1f} ms, {s['device_events']} device events); graph pool "
          f"{s['pool_bytes']} bytes; launches a call {r['launches']}", flush=True)
    return r


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
        for line in ptxas_summary(_build.ptxas_report(
                "fgc_conv_kernel", "gn_apply_kernel", "fwht_kernel", "gn_bwd_reduce_kernel",
                "gn_bwd_finalize_kernel", "attn_bwd_dq_kernel",
                "attn_bwd_dkdv_kernel",
                "attn_bwd_dq_mma_kernel", "attn_bwd_dkdv_mma_kernel")):
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

        # the attention pair against SDPA's autograd backward at each head
        # shape of the 256 px classifier at batch 8 (bf16), on the device
        for key in sorted(k for k in clf_tables["cc256_b8"] if k[0] == "attn"):
            r = bwd_results[(key, "attn_bwd", torch.bfloat16)]
            print(f"attn_bwd pair {str(key[1]):16s} bfloat16: device {r['device_ms']:.4f} ms "
                  f"against SDPA autograd {r['library_device_ms']:.4f} ms "
                  f"({r['device_ms'] / r['library_device_ms']:.2f}x), bound "
                  f"{r['bound_ms']:.4f} ms", flush=True)

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
        for name in ("cc256_b1", "cc256_b8"):
            r = bwd_per_call[(name, "gn_bwd_reduce")]
            print(f"gn_bwd_reduce share of the bound per {name} guidance call (bfloat16): "
                  f"device {r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_ms'] / r['device_ms']:.1%})", flush=True)
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
        main_outputs = {}
        main_stats, launches_simplified = main_path("sr_averagepooling", "4", True, n_gn,
                                                    n_attn, 0, keep=main_outputs)

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
                   "50 steps) and the noisy CelebA rows"):
        inet_rows, launches_inet = imagenet_rows(n_gn_inet, n_attn_inet, n_gn, n_attn)

    with phase(13, "guided parity on the toy32 ADM and classifier (fp32 golden, bf16)"):
        guided_toy = guided_parity()

    with phase(14, "guided runs at full width (inet256 hq tile, imagenet_256_cc row; bf16)"):
        guided, launches_ghq, launches_gcc = guided_full_width(n_gn_hq, n_attn_hq,
                                                               n_gn_inet, n_attn_inet)

    with phase(15, "multistep and encoder-cache parity (toy32 and flag 256 px fp32 goldens)"):
        solver = solver_parity()

    with phase(16, "the accelerators at full width through the CLIs (bf16)"):
        from hq_main_torch import build_adm_from_hq
        from ddnm_tpu_torch.config import load_hq_config

        with torch.device("meta"):
            ddpm_meta = DDPMUNet(resolution=256)
        adm_meta = build_adm_from_hq(load_hq_config(INET256), "meta")
        counts = {"ddpm": (n_gn, n_attn), "ddpm_decoder": decoder_counts(ddpm_meta),
                  "hq": (n_gn_hq, n_attn_hq), "hq_decoder": decoder_counts(adm_meta),
                  "inet": (n_gn_inet, n_attn_inet),
                  "classifier": (guided["classifier_modules"]["groupnorm"],
                                 guided["classifier_modules"]["attention"])}
        del ddpm_meta, adm_meta
        print(f"module counts (GroupNorm, attention): {counts}", flush=True)
        accel_stats, launches_accel = accel_full_width(counts)

    with phase(17, "the served main path (serve_torch + RestorationServer, flag DDPM, bf16, "
                   "max_batch 8)"):
        served, launches_served = served_main_path(n_gn, n_attn)

    with phase(18, "the hq service (toy32 guided fp32 against sample_posterior; inet256 "
                   "guided bf16, max_batch 2)"):
        served_hq, launches_served_hq = served_hq_path(*counts["hq"], *counts["classifier"])

    with phase(19, "the data long tail on the card (JPEG and image-format decodes, the main "
                   "path on mixed formats, the face sweep through hq_evaluation_torch)"):
        decode = jpeg_decode_check()
        decode["formats"] = format_decode_check()
        mixed_stats, launches_mixed = main_path("sr_averagepooling", "4", True, n_gn, n_attn, 0,
                                              path_y="celeba_hq_mixed")
        print("main path on mixed formats against phase 5 (PNG), images/s end to end "
              f"{mixed_stats['images_per_second']:.4f} against "
              f"{main_stats['images_per_second']:.4f}, in the sampler "
              f"{mixed_stats['num_samples'] / mixed_stats['sample_seconds']:.4f} against "
              f"{main_stats['num_samples'] / main_stats['sample_seconds']:.4f}; launches per "
              f"batch {launches_mixed['groupnorm_stats']} GroupNorm, "
              f"{launches_mixed['attention']} attention", flush=True)
        with torch.device("meta"):
            face_meta = build_adm_from_hq(load_hq_config(FACE256), "meta")
        face_stats, launches_face = face_sweep_path(*module_counts(face_meta))
        del face_meta
        long_tail = dict(decode=decode, mixed_main={
            k: mixed_stats[k] for k in ("images_per_second", "sample_seconds", "wall_seconds",
                                       "num_samples", "avg_psnr")}, face_sweep=face_stats)

    with phase(20, "data parallelism on a mesh of 2 (the runner, two processes, "
                   "--dp 2 serving, hq tiles, the guidance gradient)"):
        mesh, where = dp_mesh()
        print(f"torch.cuda.device_count() = {torch.cuda.device_count()}: {where}", flush=True)
        dp_run, launches_dp_runner = dp_runner(mesh, where, n_gn, n_attn, main_stats,
                                               main_outputs)
        dp_procs = dp_processes(main_outputs)
        dp_serve, launches_dp_served = dp_served(mesh, n_gn, n_attn)
        dp_tiles, launches_dp_hq = dp_hq(mesh)
        dp_guide, launches_dp_guidance = dp_guidance(mesh)
        multi_device = {"device_count": torch.cuda.device_count(), "mesh": where,
                        "runner": dp_run, "processes": dp_procs, "served": dp_serve,
                        "hq": dp_tiles, "guidance": dp_guide}

    with phase(21, "spatial partitioning at sp = 2 (the kernels' new modes, the toy32 "
                   "golden and face256 at full width, two processes on cuda:0)"):
        face = face_adm()
        n_gn_face, n_attn_face = module_counts(face)
        n_conv_face = conv3x3_count(face)
        face_shapes = op_shapes(face, torch.zeros(1, 256, 256, 3, device="cuda"))
        del face
        toy = toy_adm("cuda")
        toy_counts = (*module_counts(toy), conv3x3_count(toy))
        del toy
        torch.cuda.empty_cache()
        sp_kernels = spatial_kernels(face_shapes)
        sp_golden = spatial_golden(*toy_counts)
        sp_hq, launches_sp = spatial_hq(n_gn_face, n_attn_face, n_conv_face)
        spatial = {"kernels": sp_kernels["shapes"], "golden": sp_golden, "face256": sp_hq}

    with phase(22, "classifier guidance under spatial partitioning at sp = 2 (the backward "
                   "kernels' new modes, the toy32 guided golden and inet256 guided at full "
                   "width, two processes on cuda:0)"):
        clf = cc_classifier()
        clf_counts = dict(zip(("n_gn_c", "n_attn_c"), module_counts(clf)),
                          n_conv_c=conv3x3_count(clf))
        clf_grad_shapes = grad_shapes(clf, torch.zeros(1, 256, 256, 3, device="cuda"))
        del clf
        with torch.device("meta"):
            adm_meta = build_adm_from_hq(load_hq_config(INET256), "meta")
        inet_counts = dict(n_gn=n_gn_hq, n_attn=n_attn_hq, n_conv=conv3x3_count(adm_meta),
                           **clf_counts)
        del adm_meta
        toy, toy_clf = toy_adm("cpu"), toy_classifier("cpu")
        toy_guided_counts = dict(zip(("n_gn", "n_attn"), module_counts(toy)),
                                 n_conv=conv3x3_count(toy),
                                 **dict(zip(("n_gn_c", "n_attn_c"), module_counts(toy_clf))),
                                 n_conv_c=conv3x3_count(toy_clf))
        del toy, toy_clf
        torch.cuda.empty_cache()
        print(f"module counts (GroupNorm, attention, 3x3 conv): inet256 guided {inet_counts}, "
              f"toy32 guided {toy_guided_counts}", flush=True)
        sp_grad = spatial_grad_kernels(clf_grad_shapes)
        sp_guided_golden = spatial_guided_golden(toy_guided_counts)
        sp_guided_hq, launches_sp_guided = spatial_guided_hq(inet_counts)
        spatial_guided = {"kernels": sp_grad["shapes"], "per_guidance_call": sp_grad["per_call"],
                          "golden": sp_guided_golden, "inet256": sp_guided_hq}

    with phase(23, "serving: torch.export artifacts through the ddnm:: kernel ops (the flag "
                   "step at full width, the toy32 trajectories against JAX, a CPU-built "
                   "artifact on the card)"):
        route = op_route_host_us({"groupnorm": (8, 32, 32, 256), "attention": (8, 64, 512)})
        with tempfile.TemporaryDirectory() as tmp:
            flag_step, launches_serving_step = serving_flag_step(n_gn, n_attn, Path(tmp))
            toy_traj, launches_serving_traj = serving_toy_trajectories(Path(tmp))
        serving_stats = {"op_route_host_us": route, "flag_step": flag_step,
                         "toy32_trajectories": toy_traj}

    with phase(24, "the training path (GroupNorm parameter gradients and the attention "
                   "backward at C = 256 / 512 against their plain versions; toy32 train "
                   "steps against the JAX golden; 5 flagship steps at full width)"):
        train_kernels = training_kernels(torch.Generator(device="cuda").manual_seed(24))
        train_golden = train_golden_parity()
        with tempfile.TemporaryDirectory() as tmp:
            flag_train, launches_train = flagship_training(Path(tmp))
        training_stats = {"kernels": train_kernels, "golden": train_golden,
                          "flagship": flag_train}

    with phase(25, "the loop drivers (scan against host: five toy32 fp32 paths; the main "
                   "path at full width, bf16, batch 8, 100 steps)"):
        loop_drivers = {"toy32": loop_drivers_toy(), "main_path": loop_drivers_main_path()}


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
                              "guided_imagenet_cc": launches_gcc[kind],
                              **{run: counts_[kind] for run, counts_ in launches_accel.items()},
                              "served": launches_served[kind],
                              "served_hq": launches_served_hq[kind],
                              "mixed_main": launches_mixed[kind],
                              "face_sweep": launches_face[kind],
                              "dp_runner": launches_dp_runner[kind],
                              "dp_served": launches_dp_served[kind],
                              "dp_hq": launches_dp_hq[kind],
                              "dp_guidance": launches_dp_guidance[kind],
                              "serving_flag_step": launches_serving_step[kind],
                              "serving_toy32_trajectory": launches_serving_traj[kind]},
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
            if kind in BACKWARD else {}),
         # the spatial path's modes of the stats kernel (phase 21): launches
         # per shard of the face256 tile at sp = 2, the rest per sharded forward
         **({"modes": {mode: {"launches": launches_sp[f"groupnorm_{mode}"],
                              **sp_kernels["per_forward"][mode]}
                       for mode in ("partial", "finalize")}}
            if kind == "groupnorm_stats" else {})}
        for kind in SOURCES] + [
        {"name": "attention_gathered", "route": "cuda", "source": SOURCES["attention"][0],
         "replaces": SOURCES["attention"][1], "launches": launches_sp["attention_gathered"],
         **sp_kernels["per_forward"]["attention_gathered"]}] + [
        # the backward kernels' spatial modes (phase 22): launches per shard of
        # the guided inet256 tile at sp = 2 (10 calls), the rest per sharded
        # guidance call of the 256 px classifier (bf16, batch 1, one shard)
        {"name": name, "route": "cuda", "source": SOURCES[base][0],
         "replaces": SOURCES[base][1], "launches": launches_sp_guided[name],
         **{k: sp_grad["per_call"][name][k] for k in
            ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for name, base in (("gn_bwd_partial", "gn_bwd_reduce"),
                           ("gn_bwd_finalize", "gn_bwd_reduce"),
                           ("attn_bwd_dq_gathered", "attn_bwd_dq"),
                           ("attn_bwd_dkdv_gathered", "attn_bwd_dkdv"))] + [
        # the training path (phase 24): launches over the flagship's 5 steps
        # (attn_bwd_c512: both passes of the fp32 pair at C = 512), the rest
        # at the flagship's first norm ((16, 256, 256, 128) with its SiLU)
        # and its 16 px attention ((16, 256, 512)), fp32
        {"name": name, "route": "cuda", "source": SOURCES[base][0],
         "replaces": "none (training: jax.grad through XLA in tools/train_*_golden.py)",
         "launches": n, **{k: row[k] for k in
                           ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}}
        for name, base, n, row in (
            ("gn_bwd_param", "gn_bwd_reduce", launches_train["gn_bwd_param"],
             next(r for r in train_kernels["gn_param"] if "ms" in r)),
            ("attn_bwd_c512", "attn_bwd_dq",
             launches_train["attn_bwd_dq"] + launches_train["attn_bwd_dkdv"],
             train_kernels["attn_bwd"][0]))],
        "hq_main_path": hq_stats, "imagenet_rows": inet_rows,
        "guided_toy32": guided_toy, "guided": guided, "solver_parity": solver,
        "accelerators": accel_stats, "served": served, "served_hq": served_hq,
        "data_long_tail": long_tail, "multi_device": multi_device, "spatial": spatial,
        "spatial_guided": spatial_guided, "serving": serving_stats,
        "training": training_stats, "loop_drivers": loop_drivers}
    print(smi, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--spatial-worker"]:  # one rank of a phase 21 process group
        sys.exit(spatial_worker(sys.argv[2:]))
    sys.exit(main())
