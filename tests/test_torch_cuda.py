"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: a CUDA kernel has no interpret mode, so on a host without
a card these tests skip (the decision is made inside the fixture, never at
import). On the card (whose Python has no jax, which tests/conftest.py imports):
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`.
Tolerances as in chip_smoke.py, relative to max(1, max |plain|)."""

import pytest
import torch

from ddnm_tpu_torch import ops
from ddnm_tpu_torch.ops.attention import WHOLE_ROW_MAX_T, _torch_attention
from ddnm_tpu_torch.ops.fused_gn_conv import _torch_fused_gn_conv
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
    # one launch, the same bits on a second call
    ops.reset_launch_counts()
    a_2, b_2 = _stats_affine(x, g, b, 32, 1e-6, kw.get("film_scale"), kw.get("film_shift"))
    assert ops.launch_counts()["groupnorm_stats"] == 1
    assert torch.equal(a_k, a_2) and torch.equal(b_k, b_2)
    y_k, y_p = _apply(x, a_p, b_p, swish), _torch_apply(x, a_p, b_p, swish)
    assert float((y_k.float() - y_p.float()).abs().max()) <= tol * max(
        1.0, float(y_p.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,offset", [
    ((2, 7, 5, 36), 4, 0),         # C / G = 9: no 16-byte loads, span 36
    ((2, 9, 9, 128), 32, 1),       # x one element past 16 bytes: 1-channel loads
    ((4, 128, 128, 64), 32, 0),    # several blocks an image, the last one finalises
    ((1, 64, 64, 8192), 4, 0),     # several blocks and two spans an image
    ((1, 3, 3, 2048), 1, 0),       # one group of 2048 channels
    ((1, 2, 2, 4096), 1, 0),       # the widest span, walked in slots
])
def test_group_norm_stats_plans_match_plain(gen, dtype, shape, groups, offset):
    """Each branch of `_stats_plan` against the plain stats, and the same
    bits on a second call (no atomics)."""
    B, H, W, C = shape
    n = B * H * W * C
    buf = (torch.randn(n + offset, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    x = buf[offset:].view(shape)
    g, b = (torch.randn(C, device="cuda", generator=gen) for _ in range(2))
    fs, ft = (torch.randn(B, C, device="cuda", generator=gen) * 0.3 for _ in range(2))
    a_k, b_k = _stats_affine(x, g, b, groups, 1e-6, fs, ft)
    a_p, b_p = _torch_stats_affine(x, g, b, groups, 1e-6, fs, ft)
    for k, p in ((a_k, a_p), (b_k, b_p)):
        assert float((k - p).abs().max()) <= 1e-4 * max(1.0, float(p.abs().max()))
    a_2, b_2 = _stats_affine(x, g, b, groups, 1e-6, fs, ft)
    assert torch.equal(a_k, a_2) and torch.equal(b_k, b_2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,groups,offset", [
    ((8, 64, 64, 128), 32, 0),   # 16-byte loads and stores
    ((2, 9, 9, 128), 32, 1),     # x one element past 16 bytes: 1-channel path
    ((2, 7, 5, 34), 2, 0),       # C not a multiple of the 16-byte width
    ((1, 2, 2, 4096), 32, 0),    # C / vec > 256 threads: blocks in units
])
@pytest.mark.parametrize("swish", [False, True])
def test_group_norm_apply_paths_match_plain(gen, dtype, tol, shape, groups, offset, swish):
    """The apply kernel on each path of `_apply_plan`, with and without its
    SiLU epilogue, against its plain version (on the same affine); one
    launch, the same bits on a second call."""
    B, H, W, C = shape
    buf = (torch.randn(B * H * W * C + offset, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    x = buf[offset:].view(shape)
    g, b = (torch.randn(C, device="cuda", generator=gen) for _ in range(2))
    a_p, b_p = _torch_stats_affine(x, g, b, groups, 1e-6)
    ops.reset_launch_counts()
    y = _apply(x, a_p, b_p, swish)
    assert ops.launch_counts()["groupnorm_apply"] == 1
    ref = _torch_apply(x, a_p, b_p, swish)
    assert y.dtype == dtype and y.shape == x.shape
    assert float((y.float() - ref.float()).abs().max()) <= tol * max(
        1.0, float(ref.float().abs().max()))
    assert torch.equal(y, _apply(x, a_p, b_p, swish))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_module_swish_route_matches_plain(gen, dtype):
    """GroupNormF32(swish=True), as the UNet's norm1 / norm2 / norm_out run
    it: two launches (stats, apply with the SiLU epilogue) against the
    plain route of the same module."""
    from ddnm_tpu_torch.models.nn import GroupNormF32

    m = GroupNormF32(256, num_groups=32, eps=1e-6, swish=True).cuda()
    with torch.no_grad():
        m.weight.normal_(generator=gen)
        m.bias.normal_(generator=gen)
    x = (torch.randn(4, 256, 32, 32, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    ops.reset_launch_counts()
    with torch.no_grad():
        y = m(x)
        assert ops.launch_counts()["groupnorm_apply"] == 1
        m.force = "torch"
        ref = m(x)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert float((y.float() - ref.float()).abs().max()) <= tol * max(
        1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape", [
    (8, 256, 512), (8, 64, 512), (2, 100, 64), (1, 1024, 64),  # the DDPM UNet's, ragged T
    (4, 1, 512), (3, 17, 512), (5, 33, 32),                    # T = 1, T = 17, C = 32
    (2, WHOLE_ROW_MAX_T, 512), (2, WHOLE_ROW_MAX_T + 1, 512),  # both sides of the online path
    (32, 64, 64), (32, 256, 64), (16, 1024, 64),               # ADM heads of 64 channels
    (16, 1024, 32),                                            # ADM heads of 32 channels
    (8, 1024, 64), (16, 256, 64), (16, 64, 64),                # the hq path's, one tile
])
def test_attention_kernel_matches_plain(gen, dtype, tol, shape):
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(3))
    ops.reset_launch_counts()
    out = ops.fused_attention(q, k, v, shape[-1] ** -0.5)
    ref = _torch_attention(q, k, v, shape[-1] ** -0.5)
    assert ops.launch_counts()["attention"] == 1
    assert out.dtype == dtype and out.shape == q.shape
    err = float((out.float() - ref.float()).abs().max())
    assert err <= tol * max(1.0, float(ref.float().abs().max()))
    assert torch.equal(out, ops.fused_attention(q, k, v, shape[-1] ** -0.5))


@pytest.mark.parametrize("shape", [
    (2, 3, 65536), (8, 3, 65536), (3, 5, 2048), (4, 1, 64),  # the SVD paths, small P
    (1, 1, 65536), (25, 65536), (64, 3, 65536),  # one cluster, a ragged count, > L2
    (8, 3, 1024), (8, 3, 4096), (8, 3, 16384),   # the toy32, mid64 and 128 px tiers
    (7, 1), (5, 3, 2),                           # P = 1 and 2: ragged 16-byte tails
])
def test_fwht_kernel_matches_plain(gen, shape):
    """One launch a call (a cluster of CTAs where a slab is wider than one),
    against the plain einsum, the same bits twice and on a strided view."""
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


@pytest.mark.parametrize("mode", ["full", "conv", "act"])
@pytest.mark.parametrize("shape", [(8, 256, 256, 128), (2, 32, 32, 64), (3, 20, 36, 96),
                                   (1, 8, 8, 512), (2, 16, 16, 128), (1, 5, 3, 32),
                                   (8, 16, 16, 512), (2, 17, 33, 224), (1, 1, 1, 160)])
def test_fused_gn_conv_kernel_matches_plain(gen, mode, shape):
    """bf16 out: both sides sum the same bf16 products in fp32 (in another
    order) and round once, so they may land one bf16 ulp (<= 2^-7 relative)
    apart; the plain conv runs in fp32 with TF32 off. Inputs with a non-zero
    mean and random gamma, beta: an unmasked border would show. Shapes: the
    experiment's, the UNet's C = 512 at 16 px (64-wide N tiles), ragged H,
    W and N tiles, C % 64 != 0 (32-channel chunks, the 64-byte swizzle)."""
    torch.backends.cudnn.allow_tf32 = False
    B, H, W, C = shape
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).bfloat16()
    w = (torch.randn(3, 3, C, C, device="cuda", generator=gen) * 0.05).bfloat16()
    g = 1 + 0.1 * torch.randn(C, device="cuda", generator=gen)
    b = 0.1 * torch.randn(C, device="cuda", generator=gen)
    ops.reset_launch_counts()
    y = ops.fused_gn_conv(x, w, g, b, mode=mode)
    assert ops.launch_counts() == dict(dict.fromkeys(ops.launch_counts(), 0),
                                       groupnorm_stats=int(mode != "conv"), fused_gn_conv=1)
    ref = _torch_fused_gn_conv(x, w, g, b, 32, 1e-5, mode)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    err = float((y.float() - ref.float()).abs().max())
    assert err <= 1e-2 * max(1.0, float(ref.float().abs().max()))
    # bit-reproducible: no atomics
    assert torch.equal(y, ops.fused_gn_conv(x, w, g, b, mode=mode))


def test_kernels_raise_on_what_they_do_not_take(gen):
    x = torch.zeros(1, 4, 4, 30, device="cuda")
    with pytest.raises(ValueError, match="divisible"):
        ops.group_norm(x, torch.ones(30), torch.zeros(30))
    q = torch.zeros(1, 8, 1024, device="cuda")
    with pytest.raises(ValueError, match="C % 32"):
        ops.fused_attention(q, q, q, 1.0)
    with pytest.raises(ValueError, match="C % 32"):
        q = torch.zeros(1, 8, 48, device="cuda", dtype=torch.bfloat16)
        ops.fused_attention(q, q, q, 1.0)
    with pytest.raises(ValueError, match="C / G"):
        ops.group_norm(torch.zeros(1, 2, 2, 8194, device="cuda"), torch.ones(8194),
                       torch.zeros(8194), num_groups=1)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 64, 8, device="cuda").transpose(1, 2)
        ops.fused_attention(t, t, t, 1.0)
    with pytest.raises(ValueError, match="power-of-two"):
        ops.fwht(torch.zeros(2, 96, device="cuda"), 1.0)
    with pytest.raises(ValueError, match="P <= 65536"):
        ops.fwht(torch.zeros(1, 131072, device="cuda"), 1.0)
    xb = torch.zeros(1, 4, 4, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C % 32"):
        ops.fused_gn_conv(xb, torch.zeros(3, 3, 48, 48, device="cuda", dtype=torch.bfloat16),
                          torch.ones(48), torch.zeros(48), num_groups=16)
    with pytest.raises(ValueError, match="bf16"):
        ops.fused_gn_conv(xb.float(), None, torch.ones(48), torch.zeros(48), mode="act")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_adm_forward_kernels_match_plain(gen, dtype, tol):
    """The toy32 ADM UNet (tests/fixtures/toy_adm32.pt) and a small
    class-conditional one with random weights: the forward through the
    kernels against the forward through the plain versions; every
    GroupNorm (FiLM included) and attention of a forward launches its
    kernels once."""
    import json
    from pathlib import Path

    from ddnm_tpu_torch.models import ADMUNet, cast_torso
    from ddnm_tpu_torch.models.nn import GroupNormF32
    from ddnm_tpu_torch.models.unet_adm import AttentionBlock
    from ddnm_tpu_torch.models.unet_ddpm import set_op_force
    from ddnm_tpu_torch.runner import load_checkpoint

    fixtures = Path(__file__).resolve().parent / "fixtures"
    toy = ADMUNet(**json.loads((fixtures / "toy_adm32.json").read_text())["adm_kw"])
    load_checkpoint(toy, fixtures / "toy_adm32.pt")
    torch.manual_seed(0)  # torch's default init: every layer live
    cc = ADMUNet(image_size=64, model_channels=64, channel_mult=(1, 2, 2),
                 num_res_blocks=1, attention_resolutions=(2, 4), num_head_channels=64,
                 num_classes=10)
    for m, size, labels in ((toy, 32, ()), (cc, 64, (torch.tensor([1, 7], device="cuda"),))):
        m = m.cuda().eval()
        if dtype == torch.bfloat16:
            cast_torso(m, dtype)
        x = torch.randn(2, size, size, 3, device="cuda", generator=gen)
        t = torch.tensor([10.0, 900.0], device="cuda")
        with torch.no_grad():
            ops.reset_launch_counts()
            y = m(x, t, *labels)
            counts = ops.launch_counts()
            set_op_force(m, "torch")
            ref = m(x, t, *labels)
            set_op_force(m, None)
        n_gn = sum(isinstance(mod, GroupNormF32) for mod in m.modules())
        n_attn = sum(isinstance(mod, AttentionBlock) for mod in m.modules())
        assert counts["groupnorm_stats"] == counts["groupnorm_apply"] == n_gn
        assert counts["attention"] == n_attn
        assert y.dtype == torch.float32 and torch.isfinite(y).all()
        err = float((y - ref).abs().max())
        assert err <= tol * max(1.0, float(ref.abs().max()))


def _rel_err(got, want):
    """max |got - want| over max(1, max |want|), in fp32."""
    return float((got.float() - want.float()).abs().max()) / max(1.0, float(want.float().abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,groups", [((2, 16, 16, 128), 32), ((8, 1, 1, 2048), 32),
                                          ((2, 64, 64, 256), 32), ((3, 5, 7, 96), 32),
                                          ((1, 32, 32, 512), 32)])
@pytest.mark.parametrize("swish,film", [(False, False), (True, True), (True, False)])
def test_group_norm_backward_kernels_match_plain(gen, dtype, tol, shape, groups, swish, film):
    """gn_bwd_reduce and gn_bwd_dx each against its plain version (same
    bits on a second call: no float atomics), and the Function's dx
    against autograd through the plain forward. (2, 64, 64, 256) is read
    by several blocks an image; (8, 1, 1, 2048) is spatial_v2's 1 x 1 map."""
    from ddnm_tpu_torch.ops.groupnorm import (
        GroupNormFunction, _bwd_dx, _bwd_reduce, _torch_bwd_dx, _torch_bwd_reduce)

    B, H, W, C = shape
    x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    g, b = (torch.randn(C, device="cuda", generator=gen) for _ in range(2))
    fs = ft = None
    if film:
        fs, ft = (torch.randn(B, C, device="cuda", generator=gen) * 0.3 for _ in range(2))
    a_, b_ = _torch_stats_affine(x, g, b, groups, 1e-5, fs, ft)
    ops.reset_launch_counts()
    coef = _bwd_reduce(x, dy, g, groups, 1e-5, swish, a_, b_, fs)
    assert torch.equal(coef, _bwd_reduce(x, dy, g, groups, 1e-5, swish, a_, b_, fs))
    assert _rel_err(coef, _torch_bwd_reduce(x, dy, g, groups, 1e-5, swish, a_, b_, fs)) <= 1e-4
    dx = _bwd_dx(x, dy, coef, swish, a_, b_)
    assert dx.dtype == dtype
    assert _rel_err(dx, _torch_bwd_dx(x, dy, coef, swish, a_, b_)) <= tol
    assert ops.launch_counts()["gn_bwd_reduce"] == 2 and ops.launch_counts()["gn_bwd_dx"] == 1
    xg = x.clone().requires_grad_(True)
    GroupNormFunction.apply(xg, g, b, fs, ft, groups, 1e-5, swish, "kernel").backward(dy)
    xp = x.clone().requires_grad_(True)
    _torch_group_norm(xp, g, b, groups, 1e-5, swish, fs, ft).backward(dy)
    assert _rel_err(xg.grad, xp.grad) <= (1e-3 if dtype == torch.float32 else 3e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(8, 65, 64), (2, 257, 32), (32, 1024, 64), (64, 256, 64),
                                   (3, 17, 128), (2, 1, 32), (5, 100, 64)])
def test_attention_backward_kernels_match_plain(gen, dtype, tol, shape):
    """attn_bwd_dq and attn_bwd_dkdv each against its plain version (the
    dq kernel's LSE and D too), and the Function's gradients against
    autograd through the plain forward; ragged T included."""
    from ddnm_tpu_torch.ops.attention import (
        AttentionFunction, _attn_bwd_dkdv, _attn_bwd_dq, _torch_attn_bwd_dkdv,
        _torch_attn_bwd_dq)

    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
    scale = shape[-1] ** -0.5
    o = _torch_attention(q, k, v, scale)
    ops.reset_launch_counts()
    got = _attn_bwd_dq(q, k, v, o, do, scale)
    want = _torch_attn_bwd_dq(q, k, v, o, do, scale)
    assert got[0].dtype == dtype
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= tol
    got = _attn_bwd_dkdv(q, k, v, do, want[1], want[2], scale)
    for a, b in zip(got, _torch_attn_bwd_dkdv(q, k, v, do, want[1], want[2], scale)):
        assert _rel_err(a, b) <= tol
    assert ops.launch_counts()["attn_bwd_dq"] == ops.launch_counts()["attn_bwd_dkdv"] == 1
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    AttentionFunction.apply(*ins, scale, "kernel").backward(do)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    _torch_attention(*ref, scale).backward(do)
    for a, b in zip(ins, ref):
        assert _rel_err(a.grad, b.grad) <= (1e-3 if dtype == torch.float32 else 5e-2)


def test_backward_kernels_raise_on_what_they_do_not_take(gen):
    from ddnm_tpu_torch.ops.attention import _attn_bwd_dq
    from ddnm_tpu_torch.ops.groupnorm import GroupNormFunction

    q = torch.zeros(2, 8, 96, device="cuda")
    with pytest.raises(ValueError, match="C in"):
        _attn_bwd_dq(q, q, q, q, q, 1.0)
    t = torch.zeros(2, 64, 32, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        _attn_bwd_dq(t, t, t, t, t, 1.0)
    x = torch.zeros(1, 4, 4, 64, device="cuda", requires_grad=True)
    w = torch.ones(64, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="must not require grad"):
        GroupNormFunction.apply(x, w, torch.zeros(64, device="cuda"), None, None, 32, 1e-5,
                                False, "kernel")
