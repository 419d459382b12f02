"""The port's threefry keys (ddnm_tpu_torch/sampling/threefry.py) against
jax.random on the CPU: `random_bits` and `split` bit for bit, `normal`
within 1e-5 (the erfinv formulas of XLA and of the port round apart below
1e-6), the key-batch map per image as ddnm_tpu/sampling/rng.py
`draw_noise` does it, and the samplers' `KeyNoise` against the JAX
samplers' split-then-draw order."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.sampling.rng import default_noise, draw_noise, split_key
from ddnm_tpu_torch.sampling import threefry
from ddnm_tpu_torch.sampling.rng import default_noise as port_default_noise
from ddnm_tpu_torch.sampling.rng import draw_noise as port_draw_noise
from tests._torch_port import one_torch_thread  # noqa: F401

SEEDS = (0, 7, 42, 123456789, 2**31 - 1)
SHAPES = ((2, 5, 3), (1,), (7,), (3, 5), (2, 3, 4, 5), (2, 32, 32, 3))
NORMAL_TOL = 1e-5


def key_data(seed: int) -> np.ndarray:
    return np.array(jax.random.key_data(jax.random.PRNGKey(seed)), np.uint32)


def key_batch(*seeds) -> np.ndarray:
    return np.stack([key_data(s) for s in seeds])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_match_jax(seed, shape):
    key = key_data(seed)
    want = np.asarray(jax.random.bits(jax.random.wrap_key_data(key), shape, jnp.uint32))
    got = threefry.random_bits(torch.from_numpy(key), shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_random_bits_of_a_raw_key_of_high_words():
    """Words at the top of the uint32 range (any key data, not only
    PRNGKey's (0, seed)), as uint32 and as the int32 of the same bits."""
    key = np.array([0xFFFFFFFF, 0x80000001], np.uint32)
    want = np.asarray(jax.random.bits(jax.random.wrap_key_data(key), (4, 6), jnp.uint32))
    for k in (torch.from_numpy(key), torch.from_numpy(key.view(np.int32))):
        np.testing.assert_array_equal(threefry.random_bits(k, (4, 6)).numpy(),
                                      want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    key = key_data(seed)
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.wrap_key_data(key))))
    np.testing.assert_array_equal(threefry.split(torch.from_numpy(key)).numpy(),
                                  want.astype(np.int64))
    want3 = np.asarray(jax.random.key_data(jax.random.split(jax.random.wrap_key_data(key), 3)))
    np.testing.assert_array_equal(threefry.split(torch.from_numpy(key), 3).numpy(),
                                  want3.astype(np.int64))


def test_split_of_a_key_batch_matches_split_key():
    """A (B, 2) batch splits key by key (ddnm_tpu/sampling/rng.py split_key)."""
    keys = key_batch(7, 8, 9)
    a, b = split_key(jnp.asarray(keys))
    got = threefry.split(torch.from_numpy(keys))
    assert tuple(got.shape) == (3, 2, 2)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(a).astype(np.int64))
    np.testing.assert_array_equal(got[:, 1].numpy(), np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_normal_matches_jax(seed, shape):
    key = key_data(seed)
    want = np.asarray(jax.random.normal(jax.random.wrap_key_data(key), shape, jnp.float32))
    got = threefry.normal(torch.from_numpy(key), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMAL_TOL)


def test_normal_of_a_key_batch_is_per_image():
    """Image i of a (B, 2) batch draws normal(key[i], shape[1:]): JAX's
    draw_noise under a key batch, and the same rows in any batch."""
    keys = key_batch(7, 8, 11)
    want = np.asarray(draw_noise(default_noise, jnp.asarray(keys), (3, 8, 8, 3)))
    got = threefry.normal(torch.from_numpy(keys), (8, 8, 3))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMAL_TOL)
    alone = threefry.normal(torch.from_numpy(keys[1:2]), (8, 8, 3))
    assert torch.equal(alone[0], got[1])


@pytest.mark.parametrize("batched", [False, True], ids=["one key", "key batch"])
def test_key_noise_follows_the_jax_samplers(batched):
    """KeyNoise draws as the JAX scan does: key, k = split(key) before every
    step, then noise from k; the port's draw_noise takes it in place of the
    generators (and no noise_fn but the default)."""
    keys = key_batch(7, 8) if batched else key_data(7)
    shape = (2, 4, 4, 3)
    src = threefry.KeyNoise(torch.from_numpy(keys))
    jkey = jnp.asarray(keys)
    for _ in range(3):
        jkey, k = split_key(jkey)
        want = np.asarray(draw_noise(default_noise, k, shape))
        got = port_draw_noise(port_default_noise, src, shape, torch.device("cpu"))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMAL_TOL)
    np.testing.assert_array_equal(src.key.numpy(), np.asarray(jkey).astype(np.int64))
    with pytest.raises(ValueError, match="noise_fn"):
        port_draw_noise(lambda gens, s: torch.zeros(s), src, shape, torch.device("cpu"))


def test_key_noise_refuses_a_batch_of_another_size():
    src = threefry.KeyNoise(torch.from_numpy(key_batch(7, 8)))
    with pytest.raises(ValueError, match="2 keys for a batch of 3"):
        src.draw((3, 4, 4, 3))


def test_a_key_has_two_words():
    with pytest.raises(ValueError, match="2 words"):
        threefry.normal(torch.zeros(3, dtype=torch.int64), (4,))
