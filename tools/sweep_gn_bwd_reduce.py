#!/usr/bin/env python3
"""Device time of the GroupNorm backward reduce kernel at other launch
layouts than its plan's, at every GroupNorm backward shape of the 256 px
classifier (configs/imagenet_256_cc.yml, `chip_smoke.cc_classifier`, bf16).

For each shape (batch 1 and 8; the SiLU variant where the classifier has
one) it times `_bwd_reduce` with the plan's layout and with every (channel
span, runs, cluster) of a grid: spans of whole groups from the whole row
down to 32 bytes of a pixel, runs 1..256 (at most H*W), clusters of 1, 2
and 8 CTAs, at most two waves of blocks. Each layout is built by
`ops.groupnorm._bwd_reduce_layout` and checked against the plain version
(1e-4) before it is timed; the device time is the better of two
`chip_smoke.device_ms` readings. The plan's rules (`_bwd_reduce_plan`)
were chosen from this table.

    python3 tools/sweep_gn_bwd_reduce.py [--batch 1 8] [--top 6]

Prints the card's `nvidia-smi` name and power limit, the device time of a
one-element `add_` timed the same way (the launch floor), one line per shape
(the plan's layout and time, then the fastest layouts as span/runs x
cluster), and one JSON object as its last line (every layout's time, as
(ms, span, runs, cluster)). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

RUNS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
CLUSTERS = (1, 2, 8)


def layouts(B: int, HW: int, C: int, G: int, elem: int, max_blocks: int):
    """The (span, runs, cluster) grid of one shape (x on 16 bytes)."""
    from ddnm_tpu_torch.ops.groupnorm import _bwd_reduce_layout

    vec, cpg = 16 // elem, C // G
    span = C
    while span % vec == 0 and span % cpg == 0 and span * elem >= 32:
        for runs in RUNS:
            if runs > HW:
                break
            for k in CLUSTERS:
                if runs % k == 0 and runs * B * (C // span) <= max_blocks:
                    yield _bwd_reduce_layout(B, HW, C, cpg, elem, vec, span, runs, k)
        span //= 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool times kernels on a card")
    import chip_smoke
    from ddnm_tpu_torch.ops import _build
    from ddnm_tpu_torch.ops import groupnorm as gn

    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    one = torch.zeros(1, device="cuda")
    floor_ms = chip_smoke.device_ms(lambda: one.add_(1), iters=40)
    print(f"launch floor (a one-element add_, timed the same way): {floor_ms * 1e3:.2f} us",
          flush=True)
    clf = chip_smoke.cc_classifier()
    shapes = sorted({(key[1], key[2]) for b in args.batch for key in chip_smoke.grad_shapes(
        clf, torch.zeros(b, 256, 256, 3, device="cuda")) if key[0] == "gn"})
    del clf
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = _build.sm_count(torch.device("cuda"))
    plan_of = gn._bwd_reduce_plan
    rows = []
    for (B, H, W, C), swish in shapes:
        x = (torch.randn(B, H, W, C, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(B, H, W, C, device="cuda", generator=gen).to(torch.bfloat16)
        g, b = (torch.randn(C, device="cuda", generator=gen) for _ in range(2))
        a_, b_ = gn._stats_affine(x, g, b, 32, 1e-5, None, None)
        ref = gn._torch_bwd_reduce(x, dy, g, 32, 1e-5, swish, a_, b_)
        run = lambda: gn._bwd_reduce(x, dy, g, 32, 1e-5, swish, a_, b_)
        plan = plan_of(B, H * W, C, 32, 2, True, sms)
        timed = []
        try:
            for lay in [plan, *layouts(B, H * W, C, 32, 2, 4 * sms)]:
                gn._bwd_reduce_plan = lambda *_, lay=lay, **__: lay
                err = float((run() - ref).abs().max()) / max(1.0, float(ref.abs().max()))
                if not err <= 1e-4:
                    raise AssertionError(f"{(B, H, W, C)} {lay}: {err:.2e} > 1e-4")
                ms = min(chip_smoke.device_ms(run, iters=20) for _ in range(2))
                timed.append((ms, lay["span"], lay["runs"], lay["cluster"]))
        finally:
            gn._bwd_reduce_plan = plan_of
        chosen, rest = timed[0], sorted(timed[1:])
        print(f"{(B, H, W, C)} {'swish' if swish else 'plain'}: plan {chosen[1]}/{chosen[2]}x"
              f"{chosen[3]} {chosen[0] * 1e3:.2f} us | fastest "
              + ", ".join(f"{s}/{r}x{k} {ms * 1e3:.2f}" for ms, s, r, k in rest[:args.top]),
              flush=True)
        rows.append({"shape": (B, H, W, C), "swish": swish, "plan": chosen, "layouts": rest})
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "launch_floor_ms": floor_ms, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
