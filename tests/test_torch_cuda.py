"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: a CUDA kernel has no interpret mode, so on a host without
a card these tests skip (the decision is made inside the fixture, never at
import). On the card (whose Python has no jax, which tests/conftest.py imports):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
Tolerances as in chip_smoke.py, relative to max(1, max |plain|)."""

import pytest
import torch

from ddnm_tpu_torch import ops
from ddnm_tpu_torch.ops.attention import _torch_attention
from ddnm_tpu_torch.ops.fwht import _torch_fwht
from ddnm_tpu_torch.ops.groupnorm import (
    _apply,
    _stats_affine,
    _torch_apply,
    _torch_group_norm,
    _torch_stats_affine,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(2, 64, 64, 128), (8, 16, 16, 768), (3, 5, 7, 96)])
@pytest.mark.parametrize("swish,film", [(False, False), (True, True)])
def test_group_norm_kernel_matches_plain(gen, dtype, tol, shape, swish, film):
    B, H, W, C = shape
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    g, b = (torch.randn(C, device="cuda", generator=gen) for _ in range(2))
    kw = {}
    if film:
        kw = dict(film_scale=torch.randn(B, C, device="cuda", generator=gen) * 0.3,
                  film_shift=torch.randn(B, C, device="cuda", generator=gen) * 0.3)
    ops.reset_launch_counts()
    y = ops.group_norm(x, g, b, num_groups=32, eps=1e-6, swish=swish, **kw)
    ref = _torch_group_norm(x, g, b, 32, 1e-6, swish, **kw)
    assert ops.launch_counts()["groupnorm_stats"] == 1
    assert ops.launch_counts()["groupnorm_apply"] == 1
    assert y.dtype == dtype
    err = float((y.float() - ref.float()).abs().max())
    assert err <= tol * max(1.0, float(ref.float().abs().max()))
    # bit-reproducible: no atomics
    assert torch.equal(y, ops.group_norm(x, g, b, num_groups=32, eps=1e-6, swish=swish, **kw))
    # each kernel wrapper against its own plain version
    a_k, b_k = _stats_affine(x, g, b, 32, 1e-6, kw.get("film_scale"), kw.get("film_shift"))
    a_p, b_p = _torch_stats_affine(x, g, b, 32, 1e-6, kw.get("film_scale"),
                                   kw.get("film_shift"))
    for k, p in ((a_k, a_p), (b_k, b_p)):
        assert float((k - p).abs().max()) <= 1e-4 * max(1.0, float(p.abs().max()))
    y_k, y_p = _apply(x, a_p, b_p, swish), _torch_apply(x, a_p, b_p, swish)
    assert float((y_k.float() - y_p.float()).abs().max()) <= tol * max(
        1.0, float(y_p.float().abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape", [(8, 256, 512), (8, 64, 512), (2, 100, 64), (1, 1024, 64)])
def test_attention_kernel_matches_plain(gen, dtype, tol, shape):
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(3))
    ops.reset_launch_counts()
    out = ops.fused_attention(q, k, v, shape[-1] ** -0.5)
    ref = _torch_attention(q, k, v, shape[-1] ** -0.5)
    assert ops.launch_counts()["attention"] == 1
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol * max(1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("shape", [(2, 3, 65536), (8, 3, 65536), (3, 5, 2048), (4, 1, 64)])
def test_fwht_kernel_matches_plain(gen, shape):
    x = torch.randn(shape, device="cuda", generator=gen)
    norm = float(shape[-1]) ** 0.5
    ops.reset_launch_counts()
    out = ops.fwht(x, norm)
    assert ops.launch_counts()["fwht"] == 1
    ref = _torch_fwht(x, norm)
    assert out.dtype == torch.float32 and out.shape == x.shape
    err = float((out - ref).abs().max())
    assert err <= 1e-4 * max(1.0, float(ref.abs().max()))
    # bit-reproducible (no atomics), and a strided view gives the same bits
    assert torch.equal(out, ops.fwht(x, norm))
    view = x.transpose(0, 1).contiguous().transpose(0, 1)
    assert not view.is_contiguous() or shape[1] == 1
    assert torch.equal(out, ops.fwht(view, norm))


def test_kernels_raise_on_what_they_do_not_take(gen):
    x = torch.zeros(1, 4, 4, 30, device="cuda")
    with pytest.raises(ValueError, match="divisible"):
        ops.group_norm(x, torch.ones(30), torch.zeros(30))
    q = torch.zeros(1, 8, 1024, device="cuda")
    with pytest.raises(ValueError, match="C % 32"):
        ops.fused_attention(q, q, q, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 64, 8, device="cuda").transpose(1, 2)
        ops.fused_attention(t, t, t, 1.0)
    with pytest.raises(ValueError, match="power-of-two"):
        ops.fwht(torch.zeros(2, 96, device="cuda"), 1.0)
    with pytest.raises(ValueError, match="P <= 65536"):
        ops.fwht(torch.zeros(1, 131072, device="cuda"), 1.0)
