"""The rounding model of the bf16 attention backward kernels on the CPU.

`attn_bwd_dq_mma_kernel` and `attn_bwd_dkdv_mma_kernel`
(ddnm_tpu_torch/csrc/attention.cu) take bf16 operands, accumulate every
product in fp32 and round two intermediates to bf16 because they are mma
operands: P (for dV = P^T dO) and dS (for dQ = dS K and dK = dS^T Q), dS
from the fp32 P. Their outputs are bf16. `_emulate_dq` / `_emulate_dkdv`
repeat that arithmetic in PyTorch, so this file shows before the card does
that the card's gates hold for that design:

  - against the plain versions (`_torch_attn_bwd_dq`, `_torch_attn_bwd_dkdv`,
    fp32 arithmetic) within the card's 1e-2 of max(1, max |plain|) per
    kernel and 5e-2 for the pair (chip_smoke.TOL), at the shapes of
    tests/test_torch_cuda.py and of chip_smoke.py phase 3 (the classifier's
    heads, with its C^-0.25 scale);
  - against the fp32 jax.vjp of ddnm_tpu.ops.attention._xla_attention, no
    farther than JAX's own bf16 jax.vjp is from it, the distance being
    ||got - ref|| / ||ref||. (The largest elementwise error of both sits at
    the floor of the bf16 outputs' own rounding, 2^-9 of the largest
    gradient, and which of the two is larger flips with the draw: over a
    sweep of seeds the emulation's was the larger for some draws in dq or
    dk, while its relative norm stayed below JAX's for every draw.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import TOL
from ddnm_tpu.ops.attention import _xla_attention
from ddnm_tpu_torch.ops.attention import (
    _torch_attention,
    _torch_attention_backward,
    _torch_attn_bwd_dkdv,
    _torch_attn_bwd_dq,
)
from tests._torch_port import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
SLABS = 4  # slabs a chunk: bounds the (B, T, T) fp32 intermediates
# tests/test_torch_cuda.py::test_attention_backward_kernels_match_plain, at
# the scale C^-0.5
CARD_SHAPES = ((8, 65, 64), (2, 257, 32), (32, 1024, 64), (64, 256, 64), (3, 17, 128),
               (2, 1, 32), (5, 100, 64), (4, 1024, 128), (2, 1025, 128))
# chip_smoke.py phase 3 at the scale C^-0.25: the 256 px classifier's four
# head shapes at batch 8 and the toy32 classifier's two
CLASSIFIER_SHAPES = ((32, 1024, 64), (64, 256, 64), (64, 64, 64), (64, 65, 64), (4, 256, 32),
                     (4, 257, 32))


def _by_slabs(fn, *ts):
    """fn over chunks of SLABS slabs of the (B, T, ...) tensors ts,
    concatenated along B."""
    outs = [fn(*(t[b:b + SLABS] for t in ts)) for b in range(0, ts[0].shape[0], SLABS)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _emulate_dq(q, k, v, o, do, scale):
    """(dq, lse, dsum) as attn_bwd_dq_mma_kernel computes them from bf16
    inputs: S and dP accumulated in fp32, LSE and D in fp32, dS = P o (dP -
    D) rounded to bf16, dq = (dS K) scale in fp32 rounded to bf16."""
    def chunk(q, k, v, o, do):
        qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
        s = torch.einsum("btc,bsc->bts", qf, kf) * scale
        lse = torch.logsumexp(s, dim=-1)
        dsum = (dof * of).sum(-1)
        p = torch.exp(s - lse[..., None])
        ds = (p * (torch.einsum("btc,bsc->bts", dof, vf) - dsum[..., None])).to(BF16).float()
        return (torch.einsum("bts,bsc->btc", ds, kf) * scale).to(BF16), lse, dsum

    return _by_slabs(chunk, q, k, v, o, do)


def _emulate_dkdv(q, k, v, do, lse, dsum, scale):
    """(dk, dv) as attn_bwd_dkdv_mma_kernel computes them: P from the given
    LSE, P and dS = P o (dP - D) each rounded to bf16, dV = P^T dO and dK =
    (dS^T Q) scale accumulated in fp32 and rounded to bf16."""
    def chunk(q, k, v, do, lse, dsum):
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        p = torch.exp(torch.einsum("btc,bsc->bts", qf, kf) * scale - lse[..., None])
        ds = p * (torch.einsum("btc,bsc->bts", dof, vf) - dsum[..., None])
        dk = torch.einsum("bts,btc->bsc", ds.to(BF16).float(), qf) * scale
        dv = torch.einsum("bts,btc->bsc", p.to(BF16).float(), dof)
        return dk.to(BF16), dv.to(BF16)

    return _by_slabs(chunk, q, k, v, do, lse, dsum)


def _rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in fp32 (the card's gate)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(BF16) for _ in range(4)]


@pytest.mark.parametrize("shape,scale_pow", [(s, -0.5) for s in CARD_SHAPES]
                         + [(s, -0.25) for s in CLASSIFIER_SHAPES])
def test_rounding_model_within_the_card_gates(shape, scale_pow):
    """Each emulated kernel against its plain version on the same bf16
    inputs (the dkdv kernel fed the plain LSE and D, as the card's checks
    feed it), and the emulated pair against the plain backward and autograd
    through the plain forward, within the card's tolerances."""
    q, k, v, do = _inputs(shape, sum(shape))
    scale = shape[-1] ** scale_pow
    o = _torch_attention(q, k, v, scale)
    dq, lse, dsum = _emulate_dq(q, k, v, o, do, scale)
    want = _torch_attn_bwd_dq(q, k, v, o, do, scale)
    assert dq.dtype == BF16
    for got, ref in zip((dq, lse, dsum), want):
        assert _rel_err(got, ref) <= TOL[("attn_bwd_dq", BF16)]
    for got, ref in zip(_emulate_dkdv(q, k, v, do, want[1], want[2], scale),
                        _torch_attn_bwd_dkdv(q, k, v, do, want[1], want[2], scale)):
        assert got.dtype == BF16
        assert _rel_err(got, ref) <= TOL[("attn_bwd_dkdv", BF16)]
    pair = (dq, *_emulate_dkdv(q, k, v, do, lse, dsum, scale))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(_torch_attention(*ins, scale), ins, do)
    for got, plain, ag in zip(pair, _torch_attention_backward(q, k, v, o, do, scale), auto):
        assert _rel_err(got, plain) <= TOL[("attn_bwd", BF16)]
        assert _rel_err(got, ag) <= TOL[("attn_bwd", BF16)]


@pytest.mark.parametrize("shape", [(4, 256, 64), (2, 65, 64), (3, 100, 32)])
def test_rounding_model_no_farther_from_jax_fp32_than_jax_bf16(shape):
    """dq, dk, dv of the emulated kernels (o from the plain bf16 forward)
    against the fp32 jax.vjp of _xla_attention on the same bf16-valued
    inputs, as a norm relative to the reference's: no farther than JAX's
    own bf16 jax.vjp, each gradient."""
    q, k, v, do = _inputs(shape, 7 * sum(shape))
    scale = shape[-1] ** -0.5
    as_j = lambda t, dt: jnp.asarray(t.float().numpy(), dtype=dt)
    ref = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, scale),
                  *(as_j(t, jnp.float32) for t in (q, k, v)))[1](as_j(do, jnp.float32))
    jbf = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, scale),
                  *(as_j(t, jnp.bfloat16) for t in (q, k, v)))[1](as_j(do, jnp.bfloat16))
    o = _torch_attention(q, k, v, scale)
    dq, lse, dsum = _emulate_dq(q, k, v, o, do, scale)
    ours = (dq, *_emulate_dkdv(q, k, v, do, lse, dsum, scale))
    for name, got, j, r in zip(("dq", "dk", "dv"), ours, jbf, ref):
        r = np.asarray(r, np.float64)
        norm = np.linalg.norm(r)
        err = np.linalg.norm(got.float().numpy() - r) / norm
        err_jax = np.linalg.norm(np.asarray(j, np.float64) - r) / norm
        assert err <= err_jax, f"{name}: emulated {err:.4g} > JAX bf16 {err_jax:.4g}"
