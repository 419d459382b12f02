"""Samplers of the port: simplified DDNM+ and SVD-mode DDNM / DDNM+."""

from ddnm_tpu_torch.sampling.ddnm import (
    DDNMSchedule,
    build_schedule,
    sample_simplified,
    sample_svd,
)

__all__ = ["DDNMSchedule", "build_schedule", "sample_simplified", "sample_svd"]
