"""Hand-written CUDA kernels for the hot ops, each beside its plain version.

  - group_norm: GroupNorm(+FiLM+SiLU) over NHWC, two launches (the sums
    folded into an affine in one, then a vectorised apply with an optional
    SiLU epilogue) — replaces the Pallas `_stats_kernel` / `_apply_kernel`
    pair of ddnm_tpu/ops/groupnorm.py;
  - fused_attention: single-head attention over (B*, T, C), bf16 on the
    tensor cores (mma.sync), fp32 by FMA —
    replaces the Pallas `_attn_kernel` of ddnm_tpu/ops/attention.py;
  - fwht: the Walsh-Hadamard transform as a butterfly in one launch (its
    stages in registers, shared memory and, for a slab wider than a CTA,
    a thread-block cluster's distributed shared memory) — replaces the
    Pallas `_fwht_kernel` of ddnm_tpu/ops/fwht.py;
  - fused_gn_conv: GroupNorm affine -> SiLU -> 3x3 conv as an implicit GEMM
    on bf16 tensor cores (wgmma, TMA, a persistent warp-specialised grid),
    behind the GroupNorm stats kernel, in three modes
    (full, conv, act) — replaces the Pallas kernels of the fused GN+SiLU+conv
    experiment (tools/experiments/fused_gn_conv.py `_pallas_raw`,
    fused_gn_conv_ablations.py `_call`), which is not a route of the UNet.

A CUDA tensor goes through the kernel, a CPU tensor through the plain
version; `force=` picks one explicitly. Each kernel wrapper counts its
launches, so a run can show that it went through the kernels.

GroupNormFunction and AttentionFunction are group_norm and fused_attention
with a backward (dx of the GroupNorm; dq, dk, dv of attention), which runs
hand-written backward kernels of their own on a card (gn_bwd_reduce,
gn_bwd_dx; attn_bwd_dq, attn_bwd_dkdv). They have no TPU counterpart: the
JAX package takes the classifier-guidance gradient with jax.grad through
its XLA GroupNorm and attention.
"""

from ddnm_tpu_torch.ops import attention as _attention
from ddnm_tpu_torch.ops import fused_gn_conv as _fused_gn_conv
from ddnm_tpu_torch.ops import fwht as _fwht
from ddnm_tpu_torch.ops import groupnorm as _groupnorm
from ddnm_tpu_torch.ops.attention import AttentionFunction, fused_attention
from ddnm_tpu_torch.ops.fused_gn_conv import fused_gn_conv
from ddnm_tpu_torch.ops.fwht import fwht, hadamard_matrix
from ddnm_tpu_torch.ops.groupnorm import GroupNormFunction, group_norm

__all__ = ["AttentionFunction", "GroupNormFunction", "fused_attention", "fused_gn_conv", "fwht",
           "group_norm", "hadamard_matrix", "launch_counts", "reset_launch_counts"]

_TABLES = (_groupnorm.LAUNCHES, _attention.LAUNCHES, _fwht.LAUNCHES,
           _fused_gn_conv.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel wrapper since the last reset."""
    return {name: n for table in _TABLES for name, n in table.items()}


def reset_launch_counts() -> None:
    for table in _TABLES:
        for name in table:
            table[name] = 0
