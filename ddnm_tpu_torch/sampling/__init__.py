"""Samplers of the port (simplified DDNM+ so far)."""

from ddnm_tpu_torch.sampling.ddnm import (
    DDNMSchedule,
    build_schedule,
    sample_simplified,
)

__all__ = ["DDNMSchedule", "build_schedule", "sample_simplified"]
