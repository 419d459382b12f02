"""Samplers of the port: simplified DDNM+ and SVD-mode DDNM / DDNM+, the
posterior (hq) sampler, the second-order multistep solver of each
(sampling/solvers.py) and the encoder propagation (sampling/accel.py)."""

from ddnm_tpu_torch.sampling.ddnm import (
    DDNMSchedule,
    build_schedule,
    sample_simplified,
    sample_svd,
)
from ddnm_tpu_torch.sampling.posterior import (
    PosteriorTables,
    build_posterior_tables,
    respace_betas,
    sample_posterior,
)
from ddnm_tpu_torch.sampling.solvers import (
    sample_posterior_multistep,
    sample_simplified_multistep,
    sample_svd_multistep,
)

__all__ = [
    "sample_posterior_multistep",
    "sample_simplified_multistep",
    "sample_svd_multistep",
    "DDNMSchedule",
    "build_schedule",
    "sample_simplified",
    "sample_svd",
    "PosteriorTables",
    "build_posterior_tables",
    "respace_betas",
    "sample_posterior",
]
