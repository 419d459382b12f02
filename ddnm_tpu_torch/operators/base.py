"""Matrix-free SVD operator protocol and the shared DDNM+ spectral
coefficients (port of ddnm_tpu/operators/base.py).

An operator represents A = U diag(s) V^T without materialising A. Runtime
methods take and return flattened batches (B, N) in the channel-major
(NCHW-flatten) vector layout. Constants are built on the host with numpy
at construction and live on the operator's device as torch tensors.

`a` and `sigma_t` may be 0-dim tensors on the device (the sampler passes
them so); `sigma_y` and `eta` are Python floats (per-run configuration).
Nothing here reads a tensor back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SVDOperator",
    "ddnm_plus_lambda",
    "ddnm_plus_noise_coeffs",
    "apply_perm_with_zeros",
    "invert_perm_sim",
]


def _inv_nonzero(s: torch.Tensor) -> torch.Tensor:
    """1/s where s != 0, else 0."""
    return torch.where(s == 0, 0.0, 1.0 / torch.where(s == 0, 1.0, s))


def ddnm_plus_lambda(singulars, a, sigma_y, sigma_t, eta):
    """Per-singular Eq. 17 range-space scaling lambda_i.

    lambda_i = s_i sigma_t sqrt(1-eta^2) / (a sigma_y) where s_i > 0 and
    sigma_t < a sigma_y / s_i, and 1 elsewhere (including s_i == 0)."""
    s = torch.as_tensor(singulars)
    change = sigma_t < a * sigma_y * _inv_nonzero(s)  # False wherever s == 0
    scaled = s * sigma_t * (1 - eta**2) ** 0.5 / (a * sigma_y)
    return torch.where(change, scaled, 1.0)


def ddnm_plus_noise_coeffs(singulars, a, sigma_y, sigma_t, eta):
    """Per-singular Eq. 51 noise coefficients (d1 for fresh gaussian noise,
    d2 for the predicted epsilon), with the reference's three-case masking
    (strict inequalities; the equality case keeps the DDIM defaults)."""
    s = torch.as_tensor(singulars)
    zeros = torch.zeros_like(s)
    d1_default = zeros + sigma_t * eta
    d2_default = zeros + sigma_t * (1 - eta**2) ** 0.5
    # the reference masks only under `a != 0 and sigma_y != 0`; without the
    # gate, sigma_y = 0 would collapse to d1 = sigma_t, d2 = 0
    if sigma_y == 0:
        return d1_default, d2_default
    inv_s = _inv_nonzero(s)

    lt = (sigma_t < a * sigma_y * inv_s) & (s > 0)
    gt = (sigma_t > a * sigma_y * inv_s) & (s > 0)
    zero = s == 0

    # sigma_t < a sigma_y / s: pure eta-noise in d1, no epsilon term
    d1 = torch.where(lt, sigma_t * eta, d1_default)
    d2 = torch.where(lt, 0.0, d2_default)
    # sigma_t > a sigma_y / s: residual variance after range-space consistency
    resid = torch.sqrt(torch.clamp(sigma_t**2 - a**2 * sigma_y**2 * inv_s**2, min=0.0))
    d1 = torch.where(gt, resid, d1)
    d2 = torch.where(gt, 0.0, d2)
    # s == 0 (pure null space): DDIM defaults
    d1 = torch.where(zero, d1_default, d1)
    d2 = torch.where(zero, d2_default, d2)
    gate = torch.as_tensor(a, device=s.device) != 0
    d1 = torch.where(gate, d1, d1_default)
    d2 = torch.where(gate, d2, d2_default)
    return d1, d2


def invert_perm_sim(sim_out: np.ndarray) -> np.ndarray:
    """Given `sim_out = layout(arange(1, N+1))` (0 marking zero-filled slots),
    return gather indices with -1 for zero slots: out = x[idx] (idx >= 0)
    else 0."""
    return sim_out.astype(np.int64) - 1


def apply_perm_with_zeros(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """out[..., i] = x[..., idx[i]] where idx[i] >= 0, else 0."""
    idx = np.asarray(idx)
    if (idx >= 0).all():
        return x[..., torch.as_tensor(idx, device=x.device)]
    safe = torch.as_tensor(np.where(idx < 0, 0, idx), device=x.device)
    keep = torch.as_tensor(idx >= 0, device=x.device)
    return torch.where(keep, x[..., safe], 0.0)


class SVDOperator:
    """Base class: concrete ops define V/Vt/U/Ut/singulars/add_zeros on
    flattened (B, N) batches; the DDNM compositions come from here."""

    # How the measurement y relates to an image: "rgb" (channel-major RGB),
    # "gray" (one plane), or None (not an image). Declared per operator.
    measurement_image: str | None = None

    # --- abstract spectral pieces -----------------------------------------
    def V(self, vec):
        raise NotImplementedError

    def Vt(self, vec):
        raise NotImplementedError

    def U(self, vec):
        raise NotImplementedError

    def Ut(self, vec):
        raise NotImplementedError

    def singulars(self) -> torch.Tensor:
        raise NotImplementedError

    def add_zeros(self, vec):
        raise NotImplementedError

    # --- compositions ------------------------------------------------------
    def A(self, vec):
        temp = self.Vt(vec)
        s = self.singulars()
        return self.U(s * temp[:, : s.shape[0]])

    def At(self, vec):
        temp = self.Ut(vec)
        s = self.singulars()
        return self.V(self.add_zeros(s * temp[:, : s.shape[0]]))

    def _pinv_spectrum(self, vec, factors):
        temp = self.Ut(vec).clone()
        temp[:, : factors.shape[0]] *= factors
        return self.V(self.add_zeros(temp))

    def A_pinv(self, vec):
        return self._pinv_spectrum(vec, _inv_nonzero(self.singulars()))

    def A_pinv_eta(self, vec, eta):
        s = self.singulars()
        return self._pinv_spectrum(vec, s / (s * s + eta))

    # --- fused DDNM projection ----------------------------------------------
    # A_pinv(A x - y) = (A_pinv A) x - A_pinv y = range_project(x) - A_pinv y:
    # `prepare_measurement` hoists the per-image constant out of the
    # sampling loop, `range_project` is the per-step remainder
    # P = V 1{s>0} Vt. Concrete ops override these where the algebra
    # collapses further (the spectral-ordering permutations inside Vt/V
    # cancel in P, so the overrides skip those gathers).

    def prepare_measurement(self, y):
        """The per-image constant A_pinv(y). Compute once, outside the loop."""
        return self.A_pinv(y)

    def range_project(self, x_vec):
        """P x = A_pinv(A x) = V(add_zeros(1{s>0} * Vt(x)[:M]))."""
        s = self.singulars()
        spec_x = self.Vt(x_vec)[:, : s.shape[0]]
        return self.V(self.add_zeros(torch.where(s == 0, 0.0, spec_x)))

    def range_correction(self, x_vec, apy):
        """A_pinv(A x - y), given apy = prepare_measurement(y)."""
        return self.range_project(x_vec) - apy

    def noisy_update(self, x0_vec, prepared, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        """The two operator-dependent pieces of the noisy DDNM+ step:
        (Lambda(A_pinv(A x0 - y)), Lambda_noise(noise, ..., et)). `prepared`
        is this op's prepare_measurement(y). Ops override it with fused
        forms in their natural spectral layout."""
        corr = self.range_correction(x0_vec, prepared)
        lam_corr = self.Lambda(corr, a, sigma_y, sigma_t, eta)
        noise_term = self.Lambda_noise(noise_vec, a, sigma_y, sigma_t, eta, et_vec)
        return lam_corr, noise_term

    # --- DDNM+ hooks ---------------------------------------------------------
    # Eq. 17 / Eq. 51 are diagonal in the SVD basis, so V diag(coef(s)) Vt is
    # exact for any operator of this protocol; concrete ops override where
    # the reference has op-specific quirks to reproduce.

    def _singulars_full(self) -> torch.Tensor:
        """Singular values on the full spectral axis (zeros in the null
        space), in the op's own add_zeros layout."""
        s = self.singulars()
        return self.add_zeros(s[None])[0]

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        lam = ddnm_plus_lambda(self._singulars_full(), a, sigma_y, sigma_t, eta)
        return self.V(lam[None] * self.Vt(vec))

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        d1, d2 = ddnm_plus_noise_coeffs(self._singulars_full(), a, sigma_y, sigma_t, eta)
        return self.V(d1[None] * self.Vt(vec) + d2[None] * self.Vt(epsilon))
