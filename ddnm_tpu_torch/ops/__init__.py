"""Hand-written CUDA kernels for the hot ops, each beside its plain version.

  - group_norm: GroupNorm(+FiLM+SiLU) over NHWC, three launches (partial
    sums, fixed-order finalize into an affine, apply) — replaces the Pallas
    `_stats_kernel` / `_apply_kernel` pair of ddnm_tpu/ops/groupnorm.py;
  - fused_attention: flash-style single-head attention over (B*, T, C) —
    replaces the Pallas `_attn_kernel` of ddnm_tpu/ops/attention.py;
  - fwht: the Walsh-Hadamard transform as a shared-memory butterfly, two
    launches (rows, then columns) — replaces the Pallas `_fwht_kernel` of
    ddnm_tpu/ops/fwht.py.

A CUDA tensor goes through the kernel, a CPU tensor through the plain
version; `force=` picks one explicitly. Each kernel wrapper counts its
launches, so a run can show that it went through the kernels.
"""

from ddnm_tpu_torch.ops import attention as _attention
from ddnm_tpu_torch.ops import fwht as _fwht
from ddnm_tpu_torch.ops import groupnorm as _groupnorm
from ddnm_tpu_torch.ops.attention import fused_attention
from ddnm_tpu_torch.ops.fwht import fwht, hadamard_matrix
from ddnm_tpu_torch.ops.groupnorm import group_norm

__all__ = ["fused_attention", "fwht", "group_norm", "hadamard_matrix", "launch_counts",
           "reset_launch_counts"]

_TABLES = (_groupnorm.LAUNCHES, _attention.LAUNCHES, _fwht.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel wrapper since the last reset."""
    return {name: n for table in _TABLES for name, n in table.items()}


def reset_launch_counts() -> None:
    for table in _TABLES:
        for name in table:
            table[name] = 0
