#!/usr/bin/env python3
"""Instructions per element of the GroupNorm backward reduce kernel's main
loop, read from the SASS of the built kernel library.

Builds the port's kernels (`ddnm_tpu_torch.ops._build`), runs `cuobjdump
-sass` on the library (or reads a saved dump given with --sass), finds
`gn_bwd_reduce_kernel<__nv_bfloat16, 8>` and, in it, every loop (a branch
back to a lower address) that holds at least 16 `MUFU.EX2`: the bf16
SiLU' loops, one `MUFU.EX2` an element. For each it prints the loop's
instructions, elements, instructions an element and the opcodes an
element.

    python3 tools/reduce_sass.py [--sass DUMP]

Needs `cuobjdump` (the CUDA toolkit, beside `nvcc`) unless --sass is given.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

KERNEL = "gn_bwd_reduce_kernelI13__nv_bfloat16Li8E"


def sass_text() -> str:
    from ddnm_tpu_torch.ops import _build

    lib, _ = _build.build()
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout


def loops(text: str) -> list[dict]:
    """The SiLU' loops of the kernel: instructions, elements, opcodes."""
    body = next(b for b in text.split("Function : ")[1:] if KERNEL in b.split("\n", 1)[0])
    instrs = [(int(a, 16), op.strip()) for a, op in
              re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    out = []
    for addr, op in instrs:
        target = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", op)
        if not target or int(target.group(1), 16) >= addr:
            continue
        loop = [o for a, o in instrs if int(target.group(1), 16) <= a <= addr]
        elements = sum("MUFU.EX2" in o for o in loop)
        if elements >= 16:
            names = Counter(re.sub(r"^@!?U?P\w+\s+", "", o).split()[0].split(".")[0] for o in loop)
            out.append({"instructions": len(loop), "elements": elements,
                        "per_element": len(loop) / elements,
                        "opcodes_per_element": {k: v / elements for k, v in names.most_common()}})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", type=Path, help="a saved `cuobjdump -sass` dump to read instead")
    args = ap.parse_args()
    text = args.sass.read_text() if args.sass else sass_text()
    for i, lp in enumerate(loops(text)):
        ops = ", ".join(f"{k} {v:.2f}" for k, v in lp["opcodes_per_element"].items() if v >= 0.2)
        print(f"loop {i}: {lp['instructions']} instructions for {lp['elements']} elements, "
              f"{lp['per_element']:.2f} an element ({ops})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
