"""JAX's threefry2x32 random keys in plain torch integer ops.

The port's own copy of what `jax.random` does for raw uint32 keys (the key
data of `jax.random.PRNGKey(seed)`, shape (2,), or a batch of them, shape
(B, 2)) under `jax_threefry_partitionable=True`, the default since JAX
0.5:

  - `threefry2x32(k1, k2, x1, x2)`: 20 rounds of 32-bit adds, rotates and
    xors (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3");
  - `random_bits(key, shape)`: `jax.random.bits`: the counters are the
    flat index of each element, split into its high and low 32-bit
    words, and the two output words are xor'ed;
  - `split(key)`: `jax.random.split(key)`: the two new keys are the
    output word pairs at counters 0 and 1;
  - `uniform(key, shape, minval, maxval)`: `jax.random.uniform` in
    float32: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    times (maxval - minval) plus minval (one fused multiply-add, as XLA
    emits it), at least minval;
  - `randint(key, shape, minval, maxval)`: `jax.random.randint` in int32:
    the key split in two, 32 random bits from each (high, low), and
    minval + (high mod span * (2^32 mod span) + low mod span) mod span in
    uint32 arithmetic (span = maxval - minval);
  - `normal(key, shape)`: `jax.random.normal` in float32: the top 23 bits
    as the mantissa of a float in [1, 2), minus 1, mapped onto
    [nextafter(-1, 0), 1), then sqrt(2) erfinv(u), erfinv by XLA's own
    float32 formula (Giles' polynomials, `_erfinv`).

Every word lives in int64 and is masked to 32 bits where a shift needs it
(torch's uint32 has too few ops to rely on), so `random_bits` and `split`
give JAX's bits exactly. `normal` agrees with JAX's float32 to below 1e-6
on the CPU: the polynomial runs in float64 where XLA rounds each of its
fused multiply-adds to float32, and log1p differs in its last bit between
the two libraries. (torch.erfinv is closer to the true erfinv than XLA's
formula, and so farther from JAX: up to 2e-5 in the tails.)

A key batch (B, 2) maps per image, as ddnm_tpu/sampling/rng.py
`draw_noise` does: image i draws `normal(key[i], shape[1:])`, the same
values whatever batch it is in. This is plain torch, not a kernel: in JAX
threefry is an XLA operation, not a Pallas kernel. It traces under
torch.export (no host sync), so an exported sampler draws JAX's noise from
JAX's keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["threefry2x32", "random_bits", "split", "uniform", "randint", "normal",
           "is_key_batch", "as_key", "prng_key", "KeyNoise"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jax.random.normal's uniform draw in float32: its low bound nextafter(-1, 0)
# and its span 1 - nextafter(-1, 0), which rounds to 2 in float32 (exact
# values: a scalar is cast to float32 by the op that takes it)
_LO = -(1.0 - 2.0**-24)
_SPAN = 2.0
# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
# coefficients of w = -log1p(-x^2) < 5 and of w >= 5, highest power first
_ERFINV_SMALL = tuple(float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_LARGE = tuple(float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds of the 32-bit words k1, k2 (the key)
    and x1, x2 (the counters), broadcast together; int64 tensors holding
    uint32 values in, the two output words out.

    x1 is masked only at the end: its low 32 bits are the 32-bit sum's,
    and it grows by less than 2^6 over the rounds. x2 is masked after each
    round's xor (which takes x1's low bits and the rotation's, leaving the
    rotation's spill above bit 31) and after each key injection, so that
    every rotation starts from 32 bits. Six ops a round, where masking
    every add would take seven: the traced graph of a step is mostly
    these ops (serving.py)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = x1 + ks[0]
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & _MASK
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + (ks[(i + 2) % 3] + (i + 1))) & _MASK
    return x1 & _MASK, x2


def as_key(key) -> torch.Tensor:
    """Key data (any integer dtype, uint32 values; a numpy array too) as
    int64 words in [0, 2^32)."""
    key = torch.as_tensor(key)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a raw threefry key has 2 words in its last axis, got "
                         f"{tuple(key.shape)}")
    return key.to(torch.int64) & _MASK


def prng_key(seed: int, device=None) -> torch.Tensor:
    """The key data of `jax.random.PRNGKey(seed)`, [0, seed] in int64 on
    `device`, for a seed in [0, 2^32) (JAX without x64 keeps 32 bits)."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"prng_key takes a seed in [0, 2^32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def is_key_batch(key) -> bool:
    """True if `key` carries a leading per-image axis ((B, 2), not (2,))."""
    return key.ndim >= 2


def _counters(shape, device):
    """The flat index of each element of `shape` as (high, low) 32-bit words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (idx >> 32).reshape(shape), (idx & _MASK).reshape(shape)


def _per_key(key, shape):
    """k1, k2 of a (2,) key, or of a (B, 2) batch broadcast over `shape`."""
    key = as_key(key)
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    return key[..., 0].reshape(*lead, *pad), key[..., 1].reshape(*lead, *pad)


def random_bits(key, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32 values in int64). A (B, 2)
    key batch gives (B, *shape): row i the bits of key[i]."""
    shape = tuple(shape)
    k1, k2 = _per_key(key, shape)
    c1, c2 = _counters(shape, k1.device)
    b1, b2 = threefry2x32(k1, k2, c1, c2)
    return b1 ^ b2


def split(key, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: (num, 2) keys, or (B, num, 2) for a
    (B, 2) batch (each key split on its own)."""
    k1, k2 = _per_key(key, (num,))
    c1, c2 = _counters((num,), k1.device)
    b1, b2 = threefry2x32(k1, k2, c1, c2)
    return torch.stack([b1, b2], dim=-1)


def _unit_float(bits):
    """[0, 1) float32 of the top 23 of 32 random bits (jax.random's map)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)` bit for
    bit (float32 bounds; scalars or tensors that broadcast to `shape`)."""
    shape = tuple(shape)
    f = _unit_float(random_bits(key, shape))
    lo = torch.as_tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=f.device)
    # XLA fuses f * span + lo into one fused multiply-add: the product is
    # exact in float64, so one float64 add and one rounding to float32 give
    # the fma's value (but where the float64 sum falls exactly halfway
    # between two float32 values: never in the tests' draws)
    y = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, y)


def randint(key, shape, minval, maxval) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32, the
    default without x64) bit for bit, as int64 values; integer bounds."""
    shape = tuple(shape)
    k = split(key)
    hi_bits, lo_bits = random_bits(k[..., 0, :], shape), random_bits(k[..., 1, :], shape)
    lo = torch.as_tensor(minval, dtype=torch.int64, device=hi_bits.device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=hi_bits.device)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _MASK)
    mult = ((((1 << 16) % span) ** 2) & _MASK) % span  # uint32: 2^32 wraps to 0
    offset = ((((hi_bits % span) * mult) & _MASK) + lo_bits % span) & _MASK
    return lo + offset % span


def _erfinv(x):
    """erfinv of float32 x in (-1, 1) by XLA's formula: w = -log1p(-x^2) in
    float32, both polynomials in float64 (their float32 coefficients), the
    one of w's range rounded to float32."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    ws, wl = (w - 2.5).double(), (torch.sqrt(w) - 3.0).double()
    ps, pl = _ERFINV_SMALL[0], _ERFINV_LARGE[0]
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        ps, pl = ps * ws + cs, pl * wl + cl
    return torch.where(small, ps, pl).float() * x


def _uniform_bits_to_normal(bits):
    """jax.random.normal's float32 map of 32 random bits."""
    u = torch.clamp(_unit_float(bits) * _SPAN + _LO, min=_LO)
    return _erfinv(u) * math.sqrt(2.0)


def normal(key, shape) -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)`, to below 1e-6 (`_erfinv`).
    A (B, 2) key batch gives (B, *shape), image i from key[i]: what
    ddnm_tpu/sampling/rng.py `draw_noise` gives under a key batch for the
    shape (B, *shape)."""
    return _uniform_bits_to_normal(random_bits(key, shape))


class KeyNoise:
    """The noise of a sampler driven by a threefry key, as the JAX
    samplers draw it: before every step, travel steps included, `key, k =
    split(key)` (each key of a (B, 2) batch on its own) and the step's
    noise is `normal(k, shape)`, per image under a key batch
    (ddnm_tpu/sampling/ddnm.py `_run_scan`, posterior.py `_run_scan`).

    Samplers take it in place of the per-image generators (sampling/ddnm.py
    `sample_simplified`, posterior.py `sample_posterior`): `draw(shape)`
    returns the next step's noise on the key's device."""

    def __init__(self, key):
        self.key = as_key(key)

    def skip(self) -> None:
        """Split the key as a step that draws nothing: JAX's multistep
        solver splits its carried key at every step, travel or not
        (ddnm_tpu/sampling/solvers.py `_run_scan_ms`, `_run_scan_pms`)."""
        self.key = split(self.key)[..., 0, :]

    def draw(self, shape) -> torch.Tensor:
        ks = split(self.key)
        self.key, k = ks[..., 0, :], ks[..., 1, :]
        shape = tuple(shape)
        if is_key_batch(k):
            if k.shape[0] != shape[0]:
                raise ValueError(f"{k.shape[0]} keys for a batch of {shape[0]}")
            return normal(k, shape[1:])
        return normal(k, shape)
