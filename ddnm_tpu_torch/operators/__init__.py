"""Degradation operators of the port: the simplified-mode functional A / A+
maps and the matrix-free SVD operators of SVD mode."""

from ddnm_tpu_torch.operators.base import (
    SVDOperator,
    ddnm_plus_lambda,
    ddnm_plus_noise_coeffs,
)
from ddnm_tpu_torch.operators.functional import (
    FunctionalOperator,
    build_functional_operator,
    compose,
)
from ddnm_tpu_torch.operators.svd_ops import (
    BlockCS,
    Colorization,
    Deblurring,
    Deblurring2D,
    Denoising,
    GeneralA,
    Inpainting,
    SRConv,
    SuperResolution,
    WalshHadamardCS,
    bicubic_kernel,
    build_svd_operator,
)

__all__ = [
    "FunctionalOperator",
    "build_functional_operator",
    "compose",
    "SVDOperator",
    "ddnm_plus_lambda",
    "ddnm_plus_noise_coeffs",
    "BlockCS",
    "Colorization",
    "Deblurring",
    "Deblurring2D",
    "Denoising",
    "GeneralA",
    "Inpainting",
    "SRConv",
    "SuperResolution",
    "WalshHadamardCS",
    "bicubic_kernel",
    "build_svd_operator",
]
