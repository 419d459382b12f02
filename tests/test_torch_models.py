"""Port parity: the DDPM UNet of ddnm_tpu_torch against ddnm_tpu's, with
the weights of the committed golden fixtures, loaded directly from the .pt
and carried across from the JAX parameter tree (params_from_flax).

Tolerance: fp32 eps within 1e-4 (two frameworks' fp32 convolutions sum in
different orders through ~20 layers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.models.nn import timestep_embedding_ddpm as j_temb
from ddnm_tpu_torch.models import cast_torso, params_from_flax
from ddnm_tpu_torch.models.nn import nearest_upsample, timestep_embedding_ddpm
from ddnm_tpu_torch.models.unet_ddpm import AttnBlock
from ddnm_tpu_torch.models.nn import GroupNormF32
from tests._torch_port import TIERS, jax_model, port_model


def _inputs(res, n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, res, res, 3)).astype(np.float32)
    t = rng.uniform(0, 999, n).astype(np.float32)
    return x, t


@pytest.mark.parametrize("tier_name", ["toy32", "mid64"])
def test_unet_eps_matches_jax(tier_name):
    tier = TIERS[tier_name]
    fn, params = jax_model(tier)
    x, t = _inputs(tier.res)
    ref = np.asarray(fn(params, jnp.asarray(x), jnp.asarray(t)))

    direct = port_model(tier)
    carried = port_model(tier, params_from_flax(params))
    for model in (direct, carried):
        with torch.no_grad():
            ours = model(torch.from_numpy(x), torch.from_numpy(t))
        assert ours.dtype == torch.float32 and ours.shape == x.shape
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=0)
    sd_direct, sd_carried = direct.state_dict(), carried.state_dict()
    assert sd_direct.keys() == sd_carried.keys()
    for k in sd_direct:
        assert torch.equal(sd_direct[k], sd_carried[k]), k


def test_bf16_torso_keeps_groupnorm_fp32():
    tier = TIERS["toy32"]
    model = cast_torso(port_model(tier), torch.bfloat16)
    for m in model.modules():
        if isinstance(m, GroupNormF32):
            assert m.weight.dtype == m.bias.dtype == torch.float32
    assert model.conv_in.weight.dtype == torch.bfloat16
    x, t = _inputs(tier.res)
    with torch.no_grad():
        eps = model(torch.from_numpy(x), torch.from_numpy(t))
        ref = port_model(tier)(torch.from_numpy(x), torch.from_numpy(t))
    assert eps.dtype == torch.float32 and torch.isfinite(eps).all()
    assert float((eps - ref).abs().max()) < 0.1  # bf16 torso vs fp32


def test_time_embedding_and_upsample_match_jax():
    # sin/cos of fp32 arguments up to 999, where one ulp of the argument is
    # 6e-5: the two frameworks' exp may differ by an ulp in the frequency
    t = np.array([0.0, 1.0, 17.0, 999.0], np.float32)
    for dim in (32, 128, 33):
        ours = timestep_embedding_ddpm(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(ours, np.asarray(j_temb(jnp.asarray(t), dim)),
                                   atol=1e-4, rtol=0)
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    up = nearest_upsample(x, 2)
    ref = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                                          mode="nearest").permute(0, 2, 3, 1)
    assert torch.equal(up, ref)


def test_attn_block_takes_any_memory_format():
    block = AttnBlock(64).eval()
    x = torch.randn(2, 64, 8, 8)
    with torch.no_grad():
        a = block(x)
        b = block(x.contiguous(memory_format=torch.channels_last))
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
