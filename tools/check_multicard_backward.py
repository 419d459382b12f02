#!/usr/bin/env python3
"""The GroupNorm and attention backward kernels on other cards than the
first, held to the same calls on cuda:0 bit for bit.

The backward reduce kernel sets its shared-memory carveout and its other
function attributes per device (csrc/groupnorm.cu `grant_smem`), and the
launch counters live per (device, stream) (ops/groupnorm.py `_counters`):
a call on cuda:1 or cuda:3 that ran with cuda:0's attributes, or on
another device's counters, would give other bits or fail. Needs four cards
on one host; on each of cuda:1 and cuda:3:
  - the GroupNorm backward of the guidance gradient (frozen affine: the
    reduce and dx kernels) at the 256 px classifier's maps, bf16, batch 1
    (several clusters an image) and 8;
  - the training backward (the reduce kernel's partial sums, the finalize
    with the parameter gradients, dx: dx and the gradients of the scale, bias and FiLM) in fp32 at the
    flagship's first map (16, 256, 256, 128) and a FiLM map;
  - the attention backward pair in fp32 at C = 512 and bf16 at C = 64;
  - one guidance gradient of the 256 px classifier (configs/
    imagenet_256_cc.yml, random weights from seed 1234, every layer drawn),
    bf16, batch 1,
each against cuda:0's result with torch.equal, printing one line a check,
the card's name and power limit, and last one JSON object. Exits 1 if a
check differs.

    python3 tools/check_multicard_backward.py [--devices 1 3]
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from ddnm_tpu_torch.ops.attention import AttentionFunction  # noqa: E402
from ddnm_tpu_torch.ops.groupnorm import GroupNormFunction  # noqa: E402

GN_GUIDANCE = (((1, 256, 256, 128), torch.bfloat16), ((1, 64, 64, 256), torch.bfloat16),
               ((8, 32, 32, 512), torch.bfloat16))
GN_TRAINING = (((16, 256, 256, 128), False), ((16, 16, 16, 64), True))
ATTENTION = (((16, 256, 512), torch.float32), ((32, 1024, 64), torch.bfloat16))


def _inputs(shape, seed: int, scale=1.0, shift=0.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale + shift


def gn_guidance(shape, dtype, dev):
    x = _inputs(shape, 1, 2, 0.5).to(dev, dtype).requires_grad_(True)
    dy = _inputs(shape, 2).to(dev, dtype)
    g, b = _inputs(shape[-1:], 3).to(dev), _inputs(shape[-1:], 4).to(dev)
    GroupNormFunction.apply(x, g, b, None, None, 32, 1e-5, True, "kernel").backward(dy)
    return [x.grad]


def gn_training(shape, film, dev):
    B, C = shape[0], shape[-1]
    leaves = [_inputs(shape, 5, 2, 0.5), _inputs((C,), 6), _inputs((C,), 7)]
    if film:
        leaves += [_inputs((B, C), 8) * 0.3, _inputs((B, C), 9) * 0.3]
    leaves = [t.to(dev).requires_grad_(True) for t in leaves]
    pad = [] if film else [None, None]
    GroupNormFunction.apply(*leaves, *pad, 32, 1e-5, True, "kernel").backward(
        _inputs(shape, 10).to(dev))
    return [t.grad for t in leaves]


def attention(shape, dtype, dev):
    q, k, v = (_inputs(shape, 11 + i).to(dev, dtype).requires_grad_(True) for i in range(3))
    AttentionFunction.apply(q, k, v, shape[-1] ** -0.5, "kernel").backward(
        _inputs(shape, 14).to(dev, dtype))
    return [q.grad, k.grad, v.grad]


def guidance(clf, dev):
    from ddnm_tpu_torch.models.unet_adm import classifier_guidance_fn

    x = _inputs((1, 256, 256, 3), 15).to(dev)
    t = torch.full((1,), 500.0, device=dev)
    return [classifier_guidance_fn(clf, 3, 1.0)(x, t)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 3])
    ns = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() <= max(ns.devices):
        raise RuntimeError(f"needs cards cuda:0 and {ns.devices}; "
                           f"torch.cuda.device_count() = {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    import chip_smoke

    base = chip_smoke.cc_classifier("cuda:0", torch.bfloat16)
    checks = ([(f"gn_guidance {s} {str(d)[6:]}", lambda dev, s=s, d=d: gn_guidance(s, d, dev))
               for s, d in GN_GUIDANCE]
              + [(f"gn_training {s} film={f}", lambda dev, s=s, f=f: gn_training(s, f, dev))
                 for s, f in GN_TRAINING]
              + [(f"attention {s} {str(d)[6:]}", lambda dev, s=s, d=d: attention(s, d, dev))
                 for s, d in ATTENTION]
              + [("guidance 256 px classifier bf16", lambda dev: guidance(
                  copy.deepcopy(base).to(dev), dev))])
    results, ok = [], True
    for name, fn in checks:
        ref = [t.detach().cpu() for t in fn("cuda:0")]
        for d in ns.devices:
            got = [t.detach().cpu() for t in fn(f"cuda:{d}")]
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
            ok &= same
            results.append({"check": name, "device": f"cuda:{d}", "bit_equal": same,
                             "max_abs_diff": diff})
            print(f"{name} on cuda:{d} against cuda:0: "
                  f"{'bit-equal' if same else f'DIFFERS, max abs {diff:.3e}'}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"ok": ok, "device_count": torch.cuda.device_count(), "checks": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
