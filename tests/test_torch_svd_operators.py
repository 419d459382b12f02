"""Port parity: the SVD operators of ddnm_tpu_torch against ddnm_tpu's, on
the 10 tasks of `build_svd_operator` and a dense GeneralA, at C = 3 and
D = 32 (BlockCS on 32-px patches at ratio 0.25, GeneralA 10 x 20).

  - the constant tables (perms, gather indices, masks, SVD factors, singular
    tables) equal the JAX operator's exactly: both come from the same numpy
    float64 code;
  - every runtime method on the same random inputs is within 1e-5 of JAX,
    relative to max |JAX| (fp32 matmuls and Walsh-Hadamard sums in another
    order);
  - the DDNM+ coefficient tables agree within 1e-6 relative (the same
    elementwise fp32 formulas), the sigma_y = 0 and a = 0 gates included.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.operators import base as jbase
from ddnm_tpu.operators import svd_ops as jsvd
from ddnm_tpu_torch.operators import base as tbase
from ddnm_tpu_torch.operators import svd_ops as tsvd
from tests._golden import toy_mask, toy_perm

D = 32
TASKS = ["cs_walshhadamard", "cs_blockbased", "inpainting", "denoising", "colorization",
         "sr_averagepooling", "sr_bicubic", "deblur_uni", "deblur_gauss", "deblur_aniso",
         "general_a"]
# (a, sigma_y, sigma_t, eta): both Eq. 17 branches, and the sigma_y = 0 gate
COEFFS = [(0.8, 0.1, 0.5, 0.85), (0.95, 0.3, 0.2, 0.85), (0.9, 0.0, 0.4, 0.85)]


@functools.lru_cache(maxsize=None)
def _ops(task):
    """(JAX operator, port operator) of one task, built once per process."""
    if task == "general_a":
        A = np.random.default_rng(3).standard_normal((10, 20))
        return jsvd.GeneralA(A), tsvd.GeneralA(A)
    kw = dict(channels=3, image_size=D,
              deg_scale=0.25 if task.startswith("cs_") else 4.0,
              mask=toy_mask(D) if task == "inpainting" else None,
              perm=toy_perm(D) if task == "cs_walshhadamard" else None)
    return jsvd.build_svd_operator(task, **kw), tsvd.build_svd_operator(task, **kw)


def _inputs(task, n=3, seed=0):
    """n random fp32 (2, N) image vectors and n (2, M) measurements y = A(x')
    of other random vectors, as the sampler receives them. (A y outside A's
    range makes A_pinv(y) grow as 1/s_min, ~1e3 for the thresholded blurs,
    and its fp32 rounding would then be held against outputs of order 1.)"""
    jop, _ = _ops(task)
    rng = np.random.default_rng(seed)
    N = 20 if task == "general_a" else 3 * D * D
    xs = [rng.standard_normal((2, N)).astype(np.float32) for _ in range(2 * n)]
    ys = [np.array(jop.A(jnp.asarray(x)), np.float32) for x in xs[n:]]
    return xs[:n], ys


def _close(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err


def _both(task, fn_jax, fn_torch):
    jop, top = _ops(task)
    return fn_jax(jop), fn_torch(top)


def _scalars(a, sigma_t):
    return (jnp.float32(a), jnp.float32(sigma_t)), (torch.tensor(a), torch.tensor(sigma_t))


@pytest.mark.parametrize("task", TASKS)
def test_constant_tables_equal_jax(task):
    jop, top = _ops(task)
    assert type(top).__name__ == type(jop).__name__
    assert top.measurement_image == jop.measurement_image
    for name, want in vars(jop).items():
        got = getattr(top, name)
        if isinstance(got, torch.Tensor):
            got = got.numpy()
        if isinstance(want, (np.ndarray, jnp.ndarray)) or isinstance(got, np.ndarray):
            want = np.asarray(want)
            assert got.shape == want.shape, name
            assert got.dtype.kind == want.dtype.kind, name
            assert np.array_equal(got, want), name
        else:
            assert got == want, name
    _close(top.singulars(), jop.singulars())


@pytest.mark.parametrize("task", TASKS)
def test_A_matches_jax(task):
    (x, *_), _ = _inputs(task)
    j, t = _both(task, lambda o: o.A(jnp.asarray(x)), lambda o: o.A(torch.from_numpy(x)))
    _close(t, j)


@pytest.mark.parametrize("task", TASKS)
def test_At_matches_jax(task):
    _, (y, *_) = _inputs(task)
    j, t = _both(task, lambda o: o.At(jnp.asarray(y)), lambda o: o.At(torch.from_numpy(y)))
    _close(t, j)


@pytest.mark.parametrize("task", TASKS)
def test_A_pinv_matches_jax(task):
    _, (y, *_) = _inputs(task)
    j, t = _both(task, lambda o: o.A_pinv(jnp.asarray(y)),
                 lambda o: o.A_pinv(torch.from_numpy(y)))
    _close(t, j)


@pytest.mark.parametrize("task", TASKS)
def test_A_pinv_eta_matches_jax(task):
    _, (y, *_) = _inputs(task)
    j, t = _both(task, lambda o: o.A_pinv_eta(jnp.asarray(y), 0.3),
                 lambda o: o.A_pinv_eta(torch.from_numpy(y), 0.3))
    _close(t, j)


@pytest.mark.parametrize("task", TASKS)
def test_prepare_measurement_matches_jax(task):
    _, (y, *_) = _inputs(task)
    j, t = _both(task, lambda o: o.prepare_measurement(jnp.asarray(y)),
                 lambda o: o.prepare_measurement(torch.from_numpy(y)))
    _close(t, j)


@pytest.mark.parametrize("task", TASKS)
def test_range_correction_matches_jax(task):
    (x, *_), (y, *_) = _inputs(task)
    j, t = _both(
        task,
        lambda o: o.range_correction(jnp.asarray(x), o.prepare_measurement(jnp.asarray(y))),
        lambda o: o.range_correction(torch.from_numpy(x),
                                     o.prepare_measurement(torch.from_numpy(y))))
    _close(t, j)


@pytest.mark.parametrize("task", TASKS)
def test_noisy_update_matches_jax(task):
    jop, top = _ops(task)
    (x, noise, et), (y, *_) = _inputs(task)
    for a, sigma_y, sigma_t, eta in COEFFS[:2]:  # noisy_update runs only with sigma_y > 0
        (ja, js), (ta, ts) = _scalars(a, sigma_t)
        j = jop.noisy_update(jnp.asarray(x), jop.prepare_measurement(jnp.asarray(y)), ja,
                             sigma_y, js, eta, jnp.asarray(noise), jnp.asarray(et))
        t = top.noisy_update(torch.from_numpy(x), top.prepare_measurement(torch.from_numpy(y)),
                             ta, sigma_y, ts, eta, torch.from_numpy(noise), torch.from_numpy(et))
        for ours, ref in zip(t, j):
            _close(ours, ref)


@pytest.mark.parametrize("task", TASKS)
def test_Lambda_matches_jax(task):
    (x, *_), _ = _inputs(task)
    for a, sigma_y, sigma_t, eta in COEFFS:
        (ja, js), (ta, ts) = _scalars(a, sigma_t)
        j, t = _both(task, lambda o: o.Lambda(jnp.asarray(x), ja, sigma_y, js, eta),
                     lambda o: o.Lambda(torch.from_numpy(x), ta, sigma_y, ts, eta))
        _close(t, j)


@pytest.mark.parametrize("task", TASKS)
def test_Lambda_noise_matches_jax(task):
    (x, e, _), _ = _inputs(task)
    for a, sigma_y, sigma_t, eta in COEFFS:
        (ja, js), (ta, ts) = _scalars(a, sigma_t)
        j, t = _both(
            task, lambda o: o.Lambda_noise(jnp.asarray(x), ja, sigma_y, js, eta, jnp.asarray(e)),
            lambda o: o.Lambda_noise(torch.from_numpy(x), ta, sigma_y, ts, eta,
                                     torch.from_numpy(e)))
        _close(t, j)


@pytest.mark.parametrize("a,sigma_y,sigma_t,eta", COEFFS + [(0.0, 0.2, 0.5, 0.85),
                                                           (0.7, 0.05, 0.6, 0.0)])
def test_ddnm_plus_coefficients_match_jax(a, sigma_y, sigma_t, eta):
    rng = np.random.default_rng(1)
    s = np.abs(rng.standard_normal(64)).astype(np.float32) * 3
    s[::5] = 0.0  # null-space slots
    (ja, js), (ta, ts) = _scalars(a, sigma_t)
    want = [jbase.ddnm_plus_lambda(jnp.asarray(s), ja, sigma_y, js, eta),
            *jbase.ddnm_plus_noise_coeffs(jnp.asarray(s), ja, sigma_y, js, eta)]
    got = [tbase.ddnm_plus_lambda(torch.from_numpy(s), ta, sigma_y, ts, eta),
           *tbase.ddnm_plus_noise_coeffs(torch.from_numpy(s), ta, sigma_y, ts, eta)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_perm_helpers_match_jax():
    rng = np.random.default_rng(2)
    sim = rng.permutation(np.arange(0, 12))  # 0 marks a zero-filled slot
    idx = tbase.invert_perm_sim(sim)
    assert np.array_equal(idx, jbase.invert_perm_sim(sim))
    x = rng.standard_normal((2, 12)).astype(np.float32)
    for i in (idx, np.abs(idx)):
        np.testing.assert_array_equal(tbase.apply_perm_with_zeros(torch.from_numpy(x), i).numpy(),
                                      np.asarray(jbase.apply_perm_with_zeros(jnp.asarray(x), i)))
