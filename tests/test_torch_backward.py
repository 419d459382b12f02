"""The port's GroupNorm and attention backward (ddnm_tpu_torch/ops) on the CPU:
the plain versions of the backward kernels against jax.vjp of the JAX
package's XLA GroupNorm and attention (what jax.grad differentiates under
classifier guidance), torch.autograd.gradcheck of GroupNormFunction and
AttentionFunction in float64, and the routing of models/nn.py: with grad
enabled and an input that requires grad, GroupNormF32 and attention() go
through the Functions, and under no_grad they do not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.ops import group_norm as j_group_norm
from ddnm_tpu.ops.attention import _xla_attention
from ddnm_tpu_torch.ops import attention as t_attention
from ddnm_tpu_torch.ops import groupnorm as t_groupnorm
from ddnm_tpu_torch.ops.attention import (
    AttentionFunction,
    _torch_attention,
    _torch_attention_backward,
    _torch_attn_bwd_dkdv,
    _torch_attn_bwd_dq,
)
from ddnm_tpu_torch.ops.groupnorm import (
    GroupNormFunction,
    _torch_bwd_dx,
    _torch_bwd_reduce,
    _torch_group_norm,
    _torch_group_norm_backward,
    _torch_stats_affine,
)
from tests._torch_port import one_torch_thread  # noqa: F401  (autouse)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 64), 32), ((3, 1, 1, 128), 32),
                                          ((1, 8, 8, 96), 32), ((2, 4, 4, 64), 8)])
@pytest.mark.parametrize("swish,film", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_group_norm_backward_matches_jax_vjp(shape, groups, swish, film):
    """dx of the plain GroupNorm backward against jax.vjp of
    ddnm_tpu.ops.group_norm(force="xla"), fp32, FiLM and SiLU on and off,
    a 1 x 1 map (spatial_v2's) included."""
    B, H, W, C = shape
    rs = np.random.RandomState(sum(shape) + 2 * swish + film)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    g, b = rs.randn(C).astype(np.float32), rs.randn(C).astype(np.float32)
    fs = ft = None
    if film:
        fs, ft = (rs.randn(B, C).astype(np.float32) * 0.3 for _ in range(2))
    kw = {} if fs is None else dict(film_scale=jnp.asarray(fs), film_shift=jnp.asarray(ft))
    _, vjp = jax.vjp(lambda z: j_group_norm(z, jnp.asarray(g), jnp.asarray(b),
                                            num_groups=groups, eps=1e-5, swish=swish,
                                            force="xla", **kw), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    tt = lambda a: None if a is None else torch.from_numpy(a)
    got = _torch_group_norm_backward(tt(x), tt(dy), tt(g), tt(b), groups, 1e-5, swish,
                                     tt(fs), tt(ft))
    assert got.dtype == torch.float32 and got.shape == shape
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("B,T,C", [(3, 17, 32), (2, 65, 64), (4, 1, 32), (2, 100, 64),
                                   (1, 257, 32)])
def test_attention_backward_matches_jax_vjp(B, T, C):
    """dq, dk, dv of the plain attention backward against jax.vjp of
    ddnm_tpu.ops.attention._xla_attention, fp32, ragged T (the attention
    pool's T + 1 tokens) and head dimensions 32 and 64."""
    rs = np.random.RandomState(B * T + C)
    q, k, v, do = (rs.randn(B, T, C).astype(np.float32) for _ in range(4))
    scale = C ** -0.5
    _, vjp = jax.vjp(lambda a, b_, c: _xla_attention(a, b_, c, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    got = _torch_attention_backward(tq, tk, tv, _torch_attention(tq, tk, tv, scale), tdo, scale)
    # relative to the largest of the three (at T = 1, dq is 0 up to rounding)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g_, w in zip(got, want):
        assert float(np.abs(g_.numpy() - np.asarray(w)).max()) <= 1e-5 * top


def test_the_two_backward_passes_compose_to_the_whole():
    """The plain versions of the two kernels of each backward, as the
    wrappers chain them, give the whole backward; the dq pass's LSE is each
    row's log-sum-exp and D the row sums of do * o."""
    rs = np.random.RandomState(0)
    x, dy = (torch.from_numpy(rs.randn(2, 3, 4, 64).astype(np.float32)) for _ in range(2))
    g, b = (torch.from_numpy(rs.randn(64).astype(np.float32)) for _ in range(2))
    a_, b_ = _torch_stats_affine(x, g, b, 32, 1e-5)
    coef = _torch_bwd_reduce(x, dy, g, 32, 1e-5, True, a_, b_)
    assert coef.shape == (3, 2, 64) and coef.dtype == torch.float32
    torch.testing.assert_close(_torch_bwd_dx(x, dy, coef, True, a_, b_),
                               _torch_group_norm_backward(x, dy, g, b, 32, 1e-5, True))
    q, k, v, do = (torch.from_numpy(rs.randn(3, 9, 32).astype(np.float32)) for _ in range(4))
    o = _torch_attention(q, k, v, 0.4)
    dq, lse, dsum = _torch_attn_bwd_dq(q, k, v, o, do, 0.4)
    torch.testing.assert_close(lse, torch.logsumexp(torch.einsum("btc,bsc->bts", q, k) * 0.4, -1))
    torch.testing.assert_close(dsum, (do * o).sum(-1))
    whole = _torch_attention_backward(q, k, v, o, do, 0.4)
    for a, w in zip((dq, *_torch_attn_bwd_dkdv(q, k, v, do, lse, dsum, 0.4)), whole):
        torch.testing.assert_close(a, w)


@pytest.mark.parametrize("swish,film,hw", [(False, False, (3, 5)), (True, True, (4, 4)),
                                           (True, False, (1, 1))])
def test_group_norm_function_gradcheck(swish, film, hw):
    torch.manual_seed(0)
    x = (torch.randn(2, *hw, 64, dtype=torch.float64) * 2 + 0.5).requires_grad_(True)
    g, b = (torch.randn(64, dtype=torch.float64) for _ in range(2))
    fs = ft = None
    if film:
        fs, ft = (torch.randn(2, 64, dtype=torch.float64) * 0.3 for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda z: GroupNormFunction.apply(z, g, b, fs, ft, 32, 1e-5, swish, "torch"), (x,))


@pytest.mark.parametrize("T,C", [(1, 32), (17, 32), (9, 64)])
def test_attention_function_gradcheck(T, C):
    torch.manual_seed(T)
    ins = [torch.randn(2, T, C, dtype=torch.float64, requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: AttentionFunction.apply(a, b, c, C ** -0.5, "torch"), ins)


def test_group_norm_function_refuses_a_parameter_that_requires_grad():
    """The spatial Function gives dx only and refuses an affine that
    requires grad (training under spatial shards is not ported); the
    unsharded one now returns that gradient (training), as autograd through
    the plain forward gives it; its kernel mode refuses a CPU tensor."""
    from ddnm_tpu_torch.ops.groupnorm import ShardedGroupNormFunction

    x = torch.randn(1, 2, 2, 64, requires_grad=True)
    w = torch.ones(64, requires_grad=True)
    with pytest.raises(ValueError, match="must not require grad"):
        ShardedGroupNormFunction.apply(x, w, torch.zeros(64), None, None, 32, 1e-5, False,
                                       "torch", None)
    GroupNormFunction.apply(x, w, torch.zeros(64), None, None, 32, 1e-5, False,
                            "torch").square().sum().backward()
    ref = torch.ones(64, requires_grad=True)
    _torch_group_norm(x.detach(), ref, torch.zeros(64), 32, 1e-5, False).square().sum().backward()
    assert torch.allclose(w.grad, ref.grad, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        GroupNormFunction.apply(x, w.detach(), torch.zeros(64), None, None, 32, 1e-5, False,
                                "kernel")


def test_nn_routes_through_the_functions_only_where_a_gradient_is_wanted(monkeypatch):
    """models/nn.py: GroupNormF32 and attention() call GroupNormFunction and
    AttentionFunction when grad is on and an input requires grad (a frozen
    module, as the classifier under guidance), and the forward alone under
    no_grad or when no input requires grad. The spy also checks the mode
    the Functions are handed (the plain route on a CPU tensor), and a module
    whose affine requires grad raises on the plain route as on the card."""
    from ddnm_tpu_torch.models import nn as t_nn

    seen = []
    real_gn, real_attn = GroupNormFunction.apply, AttentionFunction.apply
    monkeypatch.setattr(t_groupnorm.GroupNormFunction, "apply",
                        lambda *a: seen.append(("gn", a[-1])) or real_gn(*a))
    monkeypatch.setattr(t_attention.AttentionFunction, "apply",
                        lambda *a: seen.append(("attn", a[-1])) or real_attn(*a))
    norm = t_nn.GroupNormF32(64, swish=True).requires_grad_(False)
    x = torch.randn(2, 64, 3, 3).contiguous(memory_format=torch.channels_last)
    q = torch.randn(2, 5, 32)
    norm(x)
    t_nn.attention(q, q, q, 1.0)
    with torch.no_grad():
        norm(x.requires_grad_(True))
        t_nn.attention(q.requires_grad_(True), q, q, 1.0)
    assert seen == []
    y = norm(x)
    o = t_nn.attention(q, q, q, 1.0)
    assert seen == [("gn", "torch"), ("attn", "torch")]
    (y.sum() + o.sum()).backward()
    assert x.grad is not None and q.grad is not None
    # a module that is not frozen (training) enters the Function and its
    # affine gets its gradient, even where the input needs none
    live = t_nn.GroupNormF32(64)
    live(x.detach()).sum().backward()
    assert seen[-1] == ("gn", "torch") and live.weight.grad is not None
    assert live.bias.grad is not None
