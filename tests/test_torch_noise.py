"""The port's measurement noise (ddnm_tpu_torch/data/noise.py) against the
JAX package's formulas, and --add_noise through the port's Runner.

torch's generators do not reproduce JAX's threefry bits, so the noise is
held to its moments and to the invariances the JAX suite checks:

  - each type's mean and variance on a constant measurement, at
    sigma 0.05 and 0.2, over 400,000 draws: means within 6 standard errors,
    standard deviations within 2% of the formula's (the sample standard
    deviation's relative standard error is ~0.11% here);
  - the JAX function's own moments on the same inputs, held to the same
    bounds, so both packages implement one distribution;
  - sigma <= 0 returns y itself; an unknown type raises ValueError;
  - a run is batch-size invariant with the noise on (batch 1 against batch
    2: the same noisy measurement, images within 1 count) in simplified and
    SVD mode, and the noise changes the measurement."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddnm_tpu.data.noise import add_noise as j_add_noise
from ddnm_tpu_torch.data.io import decode_png
from ddnm_tpu_torch.data.noise import NOISE_TYPES, add_noise
from tests._torch_port import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
N = 400_000


def _expected(noise_type: str, y: float, sigma: float) -> tuple[float, float]:
    """(mean, standard deviation) of one noisy value of measurement y."""
    if noise_type in ("gaussian", "3d_gaussian"):
        return y, sigma
    if noise_type == "poisson":
        y01 = (y + 1.0) / 2.0
        return y, 2.0 * sigma * np.sqrt(y01)  # var (2 / lam)^2 * lam * y01
    return y, abs(y) * sigma


def _check_moments(sample: np.ndarray, noise_type: str, y: float, sigma: float):
    mean, std = _expected(noise_type, y, sigma)
    assert abs(sample.mean() - mean) <= 6.0 * std / np.sqrt(N), (sample.mean(), mean)
    assert abs(sample.std() / std - 1.0) <= 0.02, (sample.std(), std)


@pytest.mark.parametrize("sigma", [0.05, 0.2])
@pytest.mark.parametrize("noise_type", NOISE_TYPES)
def test_noise_moments_match_the_formulas_and_jax(noise_type, sigma):
    for i, y in enumerate((-0.5, 0.3)):
        gen = torch.Generator().manual_seed(i)
        ours = add_noise(gen, torch.full((N,), y), sigma, noise_type)
        assert ours.shape == (N,) and ours.dtype == torch.float32
        _check_moments(ours.double().numpy(), noise_type, y, sigma)
        ref = j_add_noise(jax.random.PRNGKey(i), jnp.full((N,), y, jnp.float32), sigma,
                          noise_type)
        _check_moments(np.asarray(ref, np.float64), noise_type, y, sigma)


@pytest.mark.parametrize("noise_type", NOISE_TYPES + ("unknown",))
def test_zero_sigma_is_the_identity(noise_type):
    y = torch.linspace(-1, 1, 12).reshape(3, 4)
    for sigma in (0.0, -0.1):
        assert add_noise(torch.Generator().manual_seed(0), y, sigma, noise_type) is y


def test_unknown_noise_type_raises():
    with pytest.raises(ValueError, match="unknown noise type"):
        add_noise(torch.Generator(), torch.zeros(4), 0.1, "salt_and_pepper")


def test_noise_is_drawn_from_the_generator_alone():
    y = torch.zeros(2, 8, 8, 3)
    for noise_type in NOISE_TYPES:
        a = add_noise(torch.Generator().manual_seed(3), y + 0.2, 0.1, noise_type)
        b = add_noise(torch.Generator().manual_seed(3), y + 0.2, 0.1, noise_type)
        c = add_noise(torch.Generator().manual_seed(4), y + 0.2, 0.1, noise_type)
        assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("mode,deg,scale", [("simplified", "sr_averagepooling", "4"),
                                            ("svd", "cs_walshhadamard", "0.25")])
def test_runner_with_noise_is_batch_size_invariant(tmp_path, mode, deg, scale):
    import main_torch

    def run(batch, name, noisy=True):
        main_torch.main(["--config", "configs/toy32.yml", "--exp", str(REPO / "exp"),
                         "--path_y", "toy32", "--deg", deg, "--deg_scale", scale,
                         "--sigma_y", "0.05", *(["--add_noise", "-n", "poisson"] if noisy
                                                else []),
                         *(["--simplified"] if mode == "simplified" else []),
                         "--ckpt", str(REPO / "tests" / "fixtures" / "toy_ddpm32.pt"),
                         "--t_sampling", "4", "--max_images", "2", "--batch_size", batch,
                         "-i", str(tmp_path / name), "--ni", "--device", "cpu",
                         "--verbose", "warning"])
        return [decode_png((tmp_path / name / sub).read_bytes()).astype(int)
                for sub in ("Apy/Apy_0.png", "Apy/Apy_1.png", "0_0.png", "1_0.png")]

    one, two, quiet = run("1", "b1"), run("2", "b2"), run("2", "quiet", noisy=False)
    # the noisy measurement A+ y is the same bits whatever the batch; the
    # restored images agree to 1 count of 8-bit quantisation (the UNet's
    # convolutions may sum in another order at another batch size), the
    # bound of the JAX CLI's batch-size invariance test
    for i in range(2):
        assert np.array_equal(one[i], two[i]), f"measurement {i} differs across batch size"
        assert np.abs(one[2 + i] - two[2 + i]).max() <= 1, f"image {i} differs"
        assert np.abs(one[i] - quiet[i]).max() > 1  # the noise reached the measurement
