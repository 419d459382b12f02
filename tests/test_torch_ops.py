"""Port parity: the plain versions of the port's kernels against the JAX
package's ops (XLA path and Pallas kernel in interpret mode), and the
dispatch rules of the kernel wrappers.

Tolerances: fp32 1e-5 (fp32 rounding in another summation order); bf16
2e-2 (one bf16 ulp at |y| <= 4 is 1.6e-2, and the two frameworks round the
normalised value at the same point but may land on neighbouring values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.ops import fused_attention as j_attention
from ddnm_tpu.ops import group_norm as j_group_norm
from ddnm_tpu_torch import ops
from ddnm_tpu_torch.ops import fused_attention, group_norm


def _gn_inputs(seed, shape, film):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = rng.standard_normal(C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    fs = ft = None
    if film:
        fs = (rng.standard_normal((B, C)) * 0.3).astype(np.float32)
        ft = (rng.standard_normal((B, C)) * 0.3).astype(np.float32)
    return x, scale, bias, fs, ft


@pytest.mark.parametrize("jax_force", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,swish,film", [
    ((2, 8, 8, 64), False, False),
    ((2, 8, 8, 96), True, False),   # C / 32 = 3: not a power of two
    ((1, 4, 6, 128), True, True),   # FiLM + SiLU
])
def test_group_norm_plain_matches_jax(jax_force, dtype, shape, swish, film):
    x, scale, bias, fs, ft = _gn_inputs(0, shape, film)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jkw = dict(film_scale=jnp.asarray(fs), film_shift=jnp.asarray(ft)) if film else {}
    ref = j_group_norm(jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias),
                       num_groups=32, eps=1e-6, swish=swish, force=jax_force, **jkw)
    tkw = dict(film_scale=torch.from_numpy(fs), film_shift=torch.from_numpy(ft)) if film else {}
    ours = group_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                      torch.from_numpy(bias), num_groups=32, eps=1e-6, swish=swish, **tkw)
    assert ours.dtype == tdt and tuple(ours.shape) == shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,swish,film", [
    ((2, 8, 8, 64), False, False),
    ((1, 4, 6, 96), True, True),
])
def test_group_norm_kernel_halves_plain_match_pallas_interpret(dtype, shape, swish, film):
    """The plain versions of the two kernels against the two Pallas kernels
    (interpret mode) with the JAX glue between them."""
    from ddnm_tpu.ops.groupnorm import _effective_affine, _pallas_group_norm, _pallas_stats
    from ddnm_tpu_torch.ops.groupnorm import _torch_apply, _torch_stats_affine

    x, scale, bias, fs, ft = _gn_inputs(3, shape, film)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    B, H, W, C = shape
    jx = jnp.asarray(x).astype(jdt)
    part = _pallas_stats(jx, True)
    ja, jb = _effective_affine(part[:, 0], part[:, 1], jnp.asarray(scale), jnp.asarray(bias),
                               32, 1e-6, H * W * (C // 32),
                               None if fs is None else jnp.asarray(fs),
                               None if ft is None else jnp.asarray(ft))
    tx = torch.from_numpy(x).to(tdt)
    ta, tb = _torch_stats_affine(tx, torch.from_numpy(scale), torch.from_numpy(bias), 32,
                                 1e-6, None if fs is None else torch.from_numpy(fs),
                                 None if ft is None else torch.from_numpy(ft))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    ref = _pallas_group_norm(jx, ja, jb, swish, True)
    ours = _torch_apply(tx, torch.from_numpy(np.asarray(ja)), torch.from_numpy(np.asarray(jb)),
                        swish)
    assert ours.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("jax_force", ["xla", "interpret"])
@pytest.mark.parametrize("b,t,c", [(2, 64, 64), (1, 16, 512), (3, 40, 96)])
def test_attention_plain_matches_jax(jax_force, b, t, c):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((b, t, c)).astype(np.float32) for _ in range(3))
    scale = c ** -0.5
    ref = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                      force=jax_force)
    ours = fused_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           scale)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_attention_plain_bf16_matches_jax_xla():
    """bf16: scores rounded to bf16 before the fp32 softmax on both sides."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 64, 64)).astype(np.float32) for _ in range(3))
    ref = j_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 0.125,
                      force="xla")
    ours = fused_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 0.125)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-2, rtol=0)


def test_kernel_force_on_cpu_raises_and_counts_nothing():
    ops.reset_launch_counts()
    x = torch.zeros(1, 4, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        group_norm(x, torch.ones(32), torch.zeros(32), force="kernel")
    q = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention(q, q, q, 1.0, force="kernel")
    with pytest.raises(ValueError, match="force"):
        group_norm(x, torch.ones(32), torch.zeros(32), force="xla")
    # the CPU default is the plain version, and it launches no kernel
    group_norm(x, torch.ones(32), torch.zeros(32))
    fused_attention(q, q, q, 1.0)
    assert ops.launch_counts() == {"groupnorm_stats": 0, "groupnorm_apply": 0,
                                   "gn_bwd_reduce": 0, "gn_bwd_dx": 0, "gn_bwd_sums": 0,
                                   "gn_bwd_param": 0, "attention": 0,
                                   "attn_bwd_dq": 0, "attn_bwd_dkdv": 0, "fwht": 0,
                                   "fused_gn_conv": 0}
