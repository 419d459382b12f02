"""The UNet's norm -> swish pairs through the GroupNorm SiLU epilogue.

`GroupNormF32(swish=True)` (the port's ResnetBlock norm1 / norm2 and the
UNet's norm_out) against the JAX package's `group_norm(..., swish=True)`,
through its Pallas kernels in interpret mode and its XLA path, and against
the two-pass route it replaces (the norm, then `swish`). Inputs from a seed
with numpy.

Tolerances: fp32 1e-5 (fp32 rounding in another summation order); bf16
one bf16 ulp of the larger value per element: both sides round the
normalised value to bf16 at the same point and the SiLU once, so only a
rounding that lands on the neighbouring value may differ (and the two-pass
route rounds the sigmoid and then the product, one rounding more)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.ops import group_norm as j_group_norm
from ddnm_tpu_torch.models.nn import GroupNormF32, swish
from ddnm_tpu_torch.models.unet_ddpm import AttnBlock, DDPMUNet, ResnetBlock
from tests._torch_port import TIERS, jax_model, port_model


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(C)).astype(np.float32)
    return x, scale, bias


def _norm(scale, bias, swish_on):
    m = GroupNormF32(scale.shape[0], num_groups=32, eps=1e-6, swish=swish_on)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
    return m


def _run(m, x_nhwc):
    """NHWC numpy -> the module's NCHW (channels_last memory) -> NHWC."""
    with torch.no_grad():
        y = m(x_nhwc.permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1)


def _within_one_bf16_ulp(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    mag = np.maximum(np.maximum(np.abs(ours), np.abs(ref)), np.float32(2.0 ** -126))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return np.abs(ours - ref) <= ulp


@pytest.mark.parametrize("jax_force", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 4, 6, 96), (2, 3, 5, 128)])
def test_groupnorm_swish_matches_jax(jax_force, dtype, shape):
    x, scale, bias = _inputs(1, shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = np.asarray(j_group_norm(jnp.asarray(x).astype(jdt), jnp.asarray(scale),
                                  jnp.asarray(bias), num_groups=32, eps=1e-6, swish=True,
                                  force=jax_force), np.float32)
    ours = _run(_norm(scale, bias, True), torch.from_numpy(x).to(tdt))
    assert ours.dtype == tdt and tuple(ours.shape) == shape
    ours = ours.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    else:
        assert _within_one_bf16_ulp(ours, ref).all()


@pytest.mark.parametrize("dtype,close", [
    (torch.float32, lambda a, b: np.abs(a - b) <= 1e-5),
    (torch.bfloat16, _within_one_bf16_ulp),
])
def test_groupnorm_swish_matches_the_two_pass_route(dtype, close):
    """One pass with the SiLU epilogue against the norm followed by
    `swish` (x * sigmoid(x) on the norm's output, as the UNet ran it)."""
    x, scale, bias = _inputs(2, (2, 8, 8, 64))
    xt = torch.from_numpy(x).to(dtype)
    fused = _run(_norm(scale, bias, True), xt)
    with torch.no_grad():
        two_pass = swish(_run(_norm(scale, bias, False), xt))
    assert close(fused.float().numpy(), two_pass.float().numpy()).all()


def test_unet_routes_its_three_norm_swish_pairs_through_the_epilogue():
    """ResnetBlock norm1 and norm2 and the output norm end in the SiLU; the
    attention norms do not (no swish follows them)."""
    model = DDPMUNet(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                     attn_resolutions=(8,), resolution=16)
    blocks = [m for m in model.modules() if isinstance(m, ResnetBlock)]
    attns = [m for m in model.modules() if isinstance(m, AttnBlock)]
    assert blocks and attns
    assert all(b.norm1.swish and b.norm2.swish for b in blocks)
    assert not any(a.norm.swish for a in attns)
    assert model.norm_out.swish
    n_swish = sum(m.swish for m in model.modules() if isinstance(m, GroupNormF32))
    assert n_swish == 2 * len(blocks) + 1


def test_toy32_unet_with_the_route_matches_jax():
    """The toy32 UNet, whose ResnetBlocks and output head now run the SiLU
    inside the norm, against the JAX UNet (norm, then swish) at the port's
    fp32 UNet tolerance (1e-4: two frameworks' fp32 convolutions sum in
    different orders through ~20 layers)."""
    tier = TIERS["toy32"]
    fn, params = jax_model(tier)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, tier.res, tier.res, 3)).astype(np.float32)
    t = rng.uniform(0, 999, 2).astype(np.float32)
    ref = np.asarray(fn(params, jnp.asarray(x), jnp.asarray(t)))
    model = port_model(tier)
    assert model.norm_out.swish
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)
