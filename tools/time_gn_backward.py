#!/usr/bin/env python3
"""Device time of the GroupNorm backward kernels per guidance call of the
256 px classifier, for one checkout of this repository.

At every GroupNorm backward shape of the classifier of
configs/imagenet_256_cc.yml (`chip_smoke.cc_classifier`: bf16, random
weights) at batch 1 and 8, runs chip_smoke.py's phase-3 check of
gn_bwd_reduce, gn_bwd_dx and the pair (`chip_smoke.check_backward`: each
against its plain version, the reduce's bits on a second call, ms back to
back and on the device, the bound) in bf16, and sums each over the calls
one guidance call makes. `--root` names the checkout whose chip_smoke.py
and ddnm_tpu_torch are imported (default: this one), so that a parent
commit unpacked beside this one can be timed in its own process on the
same card, in turns:

    python3 tools/time_gn_backward.py [--root DIR] [--kinds gn_bwd_reduce,gn_bwd_dx,gn_bwd]

Prints the card's `nvidia-smi` name and power limit, one line per shape
and kind, and one JSON object as its last line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--kinds", default="gn_bwd_reduce,gn_bwd_dx,gn_bwd")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool times kernels on a card")
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    kinds = args.kinds.split(",")
    clf = chip_smoke.cc_classifier()
    tables = {f"cc256_b{b}": chip_smoke.grad_shapes(
        clf, torch.zeros(b, 256, 256, 3, device="cuda")) for b in (1, 8)}
    del clf
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fields = ("ms", "device_ms", "plain_ms", "bound_ms")
    per_call = {name: {k: dict.fromkeys(fields, 0.0) | {"calls": 0} for k in kinds}
                for name in tables}
    shapes = []
    for name, table in tables.items():
        for key, calls in sorted(table.items(), key=str):
            if key[0] != "gn":
                continue
            for kind in kinds:
                r = chip_smoke.check_backward(kind, key[1], torch.bfloat16, gen,
                                              swish=key[2], film=key[3])
                print(f"{name} {kind:14s} {str(key[1]):20s} swish={key[2]:d} film={key[3]:d} "
                      f"x{calls:<2d} err {r['max_abs_err']:.2e} device {r['device_ms']:.4f} ms "
                      f"bound {r['bound_ms']:.4f} ms", flush=True)
                shapes.append({"table": name, "kind": kind, "shape": key[1], "swish": key[2],
                               "film": key[3], "calls": calls,
                               **{f: r[f] for f in fields + ("max_abs_err",)}})
                acc = per_call[name][kind]
                for f in fields:
                    acc[f] += r[f] * calls
                acc["calls"] += calls
    for name, by_kind in per_call.items():
        for kind, acc in by_kind.items():
            print(f"{kind}: per {name} guidance call (bfloat16): device "
                  f"{acc['device_ms']:.4f} ms, bound {acc['bound_ms']:.4f} ms "
                  f"({acc['bound_ms'] / acc['device_ms']:.1%}), {acc['calls']} calls", flush=True)
    print(json.dumps({"root": str(root), "device": torch.cuda.get_device_name(0), "smi": smi,
                      "per_call": per_call, "shapes": shapes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
