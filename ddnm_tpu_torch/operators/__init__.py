"""Degradation operators of the port (simplified mode only so far; the SVD
operators are a later slice)."""

from ddnm_tpu_torch.operators.functional import (
    FunctionalOperator,
    build_functional_operator,
    compose,
)

__all__ = ["FunctionalOperator", "build_functional_operator", "compose"]
