"""PyTorch/CUDA port of ddnm_tpu (DDNM / DDNM+ zero-shot image restoration).

A second package beside the JAX reference `ddnm_tpu`: module names mirror
the JAX package so each counterpart is easy to find, public functions take
and return NHWC tensors as the JAX ones do, and the Pallas kernels of the
JAX package are hand-written CUDA kernels here (`csrc/`, bound in `ops/`).

This package imports torch and numpy only (never jax, flax, ddnm_tpu, yaml,
PIL or tqdm), so it runs on a machine that has nothing else.

Ported so far: the simplified DDNM+ path (`main_torch.py --simplified`) on
the DDPM UNet. Other paths of the JAX package raise NotImplementedError.
"""

from ddnm_tpu_torch.runtime import resolve_device

__all__ = ["resolve_device"]
