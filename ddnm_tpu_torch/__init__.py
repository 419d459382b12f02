"""PyTorch/CUDA port of ddnm_tpu (DDNM / DDNM+ zero-shot image restoration).

A second package beside the JAX reference `ddnm_tpu`: module names mirror
the JAX package so each counterpart is easy to find, public functions take
and return NHWC tensors as the JAX ones do, and the Pallas kernels of the
JAX package are hand-written CUDA kernels here (`csrc/`, bound in `ops/`).

This package imports torch and numpy only (never jax, flax, ddnm_tpu, yaml,
PIL or tqdm), so it runs on a machine that has nothing else.

Ported: the main runner in both modes on the DDPM and ADM UNets
(`main_torch.py`, `evaluation_torch.py`), the hq Mask-Shift pipeline
(`hq_main_torch.py`), classifier guidance, the multistep solver
(`sampling/solvers.py`), the encoder cache (`sampling/accel.py`) and the
hq CLI's tile-granular `--resume`, the runner's host overlap with
`utils/observability.py` (`MetricsLogger`, `--trace_dir`) and online
serving (`server.py`, `serve_torch.py`), and the data long tail: numpy
decoders of every image format the JAX package reads through PIL
(`data/io.py`, `data/jpeg.py`, `data/webp.py`), the CelebA and LSUN lmdb datasets
(`data/extra_datasets.py`), the checkpoint registry (`data/checkpoints.py`)
and `hq_evaluation_torch.py`, and data parallelism (`parallel/`: the runner,
tiles and served groups sharded over a mesh of cards, `--dp`, one slice
of the dataset per process under torchrun), and spatial partitioning
(`--sp`, `make_mesh_2d` with sp > 1: a grid of processes, each UNet and
classifier holding a block of every tile's rows, guidance included).
Refused with ValueError: WebP (a real LSUN lmdb's values), progressive
and CMYK JPEG; the bench is absent.
"""

from ddnm_tpu_torch.runtime import resolve_device

__all__ = ["resolve_device"]
