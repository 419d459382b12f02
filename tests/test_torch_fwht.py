"""Port parity of the Walsh-Hadamard transform: the plain version of
`ddnm_tpu_torch.ops.fwht` against the JAX package's `fwht` (its XLA einsum
and its Pallas kernel in interpret mode, as tests/test_pallas_ops.py runs
it) and against a float64 butterfly, and the dispatch rules of the kernel
wrapper.

Tolerances: 1e-5 against JAX (the same fp32 einsum, summed in another
order); 1e-4 against the float64 butterfly (the bound of
tests/test_pallas_ops.py: fp32 sums of P terms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.ops import fwht as j_fwht
from ddnm_tpu.ops.fwht import _factor as j_factor
from ddnm_tpu.ops.fwht import hadamard_matrix as j_hadamard
from ddnm_tpu_torch import ops
from ddnm_tpu_torch.ops import fwht, hadamard_matrix
from ddnm_tpu_torch.ops.fwht import _factor

P_VALUES = [64, 256, 1024, 2048, 4096]  # 2048 = 64 x 32: a != b


def _butterfly(a: np.ndarray, norm: float) -> np.ndarray:
    """The reference's log2(P)-pass butterfly in float64."""
    shape = a.shape
    p = shape[-1]
    a = a.reshape(-1, p).astype(np.float64)
    h = 1
    while h < p:
        a = a.reshape(a.shape[0], -1, 2 * h)
        x, y = a[..., :h], a[..., h:]
        a = np.concatenate([x + y, x - y], axis=-1).reshape(a.shape[0], p)
        h *= 2
    return (a / norm).reshape(shape)


@pytest.mark.parametrize("p", [1, 2, 8, 64, 2048, 65536])
def test_factor_and_hadamard_match_jax(p):
    assert _factor(p) == j_factor(p)
    a, b = _factor(p)
    assert a >= b and a * b == p
    for n in (a, b):
        assert np.array_equal(hadamard_matrix(n), j_hadamard(n))


@pytest.mark.parametrize("jax_force", ["xla", "interpret"])
@pytest.mark.parametrize("shape", [(3, 1024), (2, 3, 2048), (1, 3, 4096)])
def test_plain_fwht_matches_jax(jax_force, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    norm = float(np.sqrt(shape[-1]))
    ref = np.asarray(j_fwht(jnp.asarray(x), norm, force=jax_force))
    ours = fwht(torch.from_numpy(x), norm)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("p", P_VALUES)
def test_plain_fwht_matches_float64_butterfly(p):
    x = np.random.default_rng(0).standard_normal((2, 3, p)).astype(np.float32)
    norm = float(np.sqrt(p))
    np.testing.assert_allclose(fwht(torch.from_numpy(x), norm).numpy(), _butterfly(x, norm),
                               atol=1e-4, rtol=1e-4)


def test_plain_fwht_is_self_inverse_and_takes_views():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 4096)).astype(np.float32))
    np.testing.assert_allclose(fwht(fwht(x, 64.0), 64.0).numpy(), x.numpy(), atol=1e-4)
    # a strided view and another dtype give the same transform as a copy
    view = x.reshape(2, 64, 64).transpose(1, 2).reshape(2, 4096)
    assert torch.equal(fwht(x.double(), 64.0), fwht(x, 64.0))
    assert torch.equal(fwht(view, 64.0), fwht(view.contiguous(), 64.0))


def test_kernel_on_a_cpu_tensor_raises_and_counts_nothing():
    x = torch.zeros(2, 3, 256)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fwht(x, 16.0, force="kernel")
    with pytest.raises(ValueError, match="force"):
        fwht(x, 16.0, force="pallas")
    assert ops.launch_counts()["fwht"] == 0
    fwht(x, 16.0)  # a CPU tensor takes the plain version
    assert ops.launch_counts()["fwht"] == 0


def test_plain_fwht_rejects_a_length_that_is_not_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        fwht(torch.zeros(2, 96), 1.0)
