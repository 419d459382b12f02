"""Concrete SVD degradation operators (port of ddnm_tpu/operators/svd_ops.py).

Each operator realises A = U diag(s) V^T matrix-free over flattened (B, N)
batches in the channel-major vector layout. Construction runs on the host
in numpy (float64 SVDs, permutation and gather tables) exactly as the JAX
package builds them, so both packages hold the same constant tables; the
tables then live on the operator's `device`. Runtime methods are torch:
reshapes and transposes for the patch and needle choreography, small fp32
matmuls for the V/U factors, gathers with int64 index tensors kept on the
device, and the Walsh-Hadamard transform through `ddnm_tpu_torch.ops.fwht`
(the hand-written CUDA kernel on a CUDA tensor).

The factor matmuls must stay full fp32: SRConv's and Deblurring's small
factors are parity-critical. `torch.matmul` is fp32 unless TF32 is switched
on (`torch.backends.cuda.matmul.allow_tf32`, off by default).

REFERENCE-QUIRK (replicated as the JAX package does): `Deblurring.singulars()`
and `Deblurring2D.singulars()` tile the D^2 singular values 3x channel-major
while their Vt output layout is pixel-major channel-interleaved, so the
effective diagonal is scrambled and A is not the separable blur. The
pipeline is self-consistent (y comes from the same A), so parity requires
replicating the layout, not fixing it. `Deblurring.Lambda` uses the
interleave-consistent per-pixel layout, also as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from ddnm_tpu_torch.operators.base import (
    SVDOperator,
    ddnm_plus_lambda,
    ddnm_plus_noise_coeffs,
)
from ddnm_tpu_torch.ops import fwht as _fwht

__all__ = [
    "Denoising",
    "Colorization",
    "Inpainting",
    "SuperResolution",
    "SRConv",
    "Deblurring",
    "Deblurring2D",
    "WalshHadamardCS",
    "BlockCS",
    "GeneralA",
    "bicubic_kernel",
    "build_svd_operator",
]


def _t(a, device) -> torch.Tensor:
    """A host constant (numpy) as a tensor on `device`."""
    return torch.as_tensor(np.asarray(a), device=device)


def _interleave(x):
    """(B, C, P) -> (B, P*C) pixel-major channel-interleaved flatten."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def _np_svd(a: np.ndarray):
    """Full SVD with V returned column-major like torch.svd (A = U s V^T)."""
    u, s, vh = np.linalg.svd(a.astype(np.float64), full_matrices=True)
    return (
        u.astype(np.float32),
        s.astype(np.float32),
        vh.T.astype(np.float32),
    )


def _zero_pad(vec, n):
    """(B, ...) flattened into the first columns of a (B, n) zero array."""
    r = vec.reshape(vec.shape[0], -1)
    out = r.new_zeros((vec.shape[0], n))
    out[:, : r.shape[1]] = r
    return out


# ---------------------------------------------------------------------------
# Denoising (A = I)
# ---------------------------------------------------------------------------
class Denoising(SVDOperator):
    """Identity operator; Lambda/Lambda_noise reduce to scalar Eq. 19/51
    branches."""

    measurement_image = 'rgb'

    def __init__(self, channels: int, img_dim: int, device=None):
        self.channels = channels
        self.img_dim = img_dim
        self._singulars = torch.ones(channels * img_dim**2, device=device)

    def V(self, vec):
        return vec.reshape(vec.shape[0], -1)

    Vt = V
    U = V
    Ut = V
    add_zeros = V
    range_project = V  # A+ A = I

    def singulars(self):
        return self._singulars

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        factor = torch.where(
            sigma_t < a * sigma_y, sigma_t * (1 - eta**2) ** 0.5 / (a * sigma_y), 1.0
        )
        return vec * factor

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        factor = torch.where(
            sigma_t >= a * sigma_y,
            torch.sqrt(torch.clamp(sigma_t**2 - a**2 * sigma_y**2, min=0.0)),
            sigma_t * eta,
        )
        return vec * factor


# ---------------------------------------------------------------------------
# Colorization (per-pixel 1x3 averaging)
# ---------------------------------------------------------------------------
class Colorization(SVDOperator):
    """Per-pixel "needle" operator: SVD of [[0.3333, 0.3334, 0.3333]]."""

    measurement_image = 'gray'

    def __init__(self, img_dim: int, device=None):
        self.channels = 3
        self.img_dim = img_dim
        u, s, v = _np_svd(np.array([[0.3333, 0.3334, 0.3333]]))
        self._u00 = float(u[0, 0])
        self._s_small = _t(s, device)  # (1,)
        self._v_small = _t(v, device)  # (3, 3)
        # spectral-component singulars padded to needle length
        self._s_needle = _t(np.array([s[0], 0.0, 0.0], np.float32), device)

    def _needles(self, vec):
        return vec.reshape(vec.shape[0], self.channels, -1).transpose(1, 2)

    def _unneedle(self, needles, b):
        return needles.transpose(1, 2).reshape(b, -1)

    def V(self, vec):
        return self._unneedle(self._needles(vec) @ self._v_small.T, vec.shape[0])

    def Vt(self, vec):
        return self._unneedle(self._needles(vec) @ self._v_small, vec.shape[0])

    def U(self, vec):
        return self._u00 * vec.reshape(vec.shape[0], -1)

    Ut = U

    def singulars(self):
        return self._s_small.repeat(self.img_dim**2)

    def add_zeros(self, vec):
        return _zero_pad(vec, self.channels * self.img_dim**2)

    def range_project(self, vec):
        # P = per-needle projection onto the v0 direction (s0 > 0 always)
        n = self._needles(vec)
        v0 = self._v_small[:, 0]
        return self._unneedle((n @ v0)[..., None] * v0, vec.shape[0])

    def noisy_update(self, x0_vec, apy, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        # the correction is v0-component-only, so Lambda reduces to its s0
        # scalar; Lambda_noise's two needle transforms merge into one
        corr = self.range_project(x0_vec) - apy
        lam0 = ddnm_plus_lambda(self._s_needle[:1], a, sigma_y, sigma_t, eta)[0]
        d1, d2 = ddnm_plus_noise_coeffs(self._s_needle, a, sigma_y, sigma_t, eta)
        nv = self._needles(noise_vec)
        ne = self._needles(et_vec)
        out = (nv * d1.reshape(1, 1, -1) + ne * d2.reshape(1, 1, -1)) @ self._v_small.T
        return lam0 * corr, self._unneedle(out, x0_vec.shape[0])

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        needles = self._needles(vec) @ self._v_small
        lam = ddnm_plus_lambda(self._s_needle, a, sigma_y, sigma_t, eta)
        needles = (needles * lam.reshape(1, 1, -1)) @ self._v_small.T
        return self._unneedle(needles, vec.shape[0])

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        nv = self._needles(vec)
        ne = self._needles(epsilon)
        d1, d2 = ddnm_plus_noise_coeffs(self._s_needle, a, sigma_y, sigma_t, eta)
        nv = (nv * d1.reshape(1, 1, -1)) @ self._v_small.T
        ne = (ne * d2.reshape(1, 1, -1)) @ self._v_small.T
        return self._unneedle(nv + ne, vec.shape[0])


# ---------------------------------------------------------------------------
# Inpainting (pixel-selection permutation)
# ---------------------------------------------------------------------------
class Inpainting(SVDOperator):
    """Permutation operator over channel-interleaved coordinates.
    `missing_indices` are interleaved (pixel*3 + c)."""

    def __init__(self, channels: int, img_dim: int, missing_indices: np.ndarray,
                 device=None):
        self.channels = channels
        self.img_dim = img_dim
        n = channels * img_dim**2
        missing = np.asarray(missing_indices, dtype=np.int64)
        mask = np.ones(n, dtype=bool)
        mask[missing] = False
        kept = np.nonzero(mask)[0]
        self._n_kept = len(kept)
        sel = np.concatenate([kept, missing])
        self._sel = _t(sel, device)  # Vt gather
        self._inv_sel = _t(np.argsort(sel), device)  # V gather
        self._singulars = torch.ones(self._n_kept, device=device)
        s_full = np.zeros(n, np.float32)
        s_full[: self._n_kept] = 1.0
        self._s_full = _t(s_full, device)
        # kept-coordinate indicator remapped interleaved -> C-major layout
        self._kept_cmajor = _t(
            mask.reshape(-1, channels).T.reshape(1, -1).astype(np.float32), device
        )
        self._one = torch.ones(1, device=device)
        self._one_zero = _t(np.array([1.0, 0.0], np.float32), device)

    def _from_interleaved(self, t):
        """(B, P*C) interleaved -> (B, C*P) C-major."""
        return t.reshape(t.shape[0], -1, self.channels).transpose(1, 2).reshape(t.shape[0], -1)

    def V(self, vec):
        return self._from_interleaved(vec.reshape(vec.shape[0], -1)[:, self._inv_sel])

    def Vt(self, vec):
        temp = _interleave(vec.reshape(vec.shape[0], self.channels, -1))
        return temp[:, self._sel]

    def U(self, vec):
        return vec.reshape(vec.shape[0], -1)

    Ut = U

    def singulars(self):
        return self._singulars

    def add_zeros(self, vec):
        return _zero_pad(vec, self.channels * self.img_dim**2)

    def range_project(self, vec):
        # V and Vt are permutations, so P collapses to the kept-pixel mask
        return vec.reshape(vec.shape[0], -1) * self._kept_cmajor

    def noisy_update(self, x0_vec, apy, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        # the correction is zero on missing coords, so Lambda reduces to its
        # s=1 scalar; the noise coefficients select s=1 (kept) vs s=0
        # (missing) per coordinate: elementwise, no gathers
        corr = self.range_project(x0_vec) - apy
        lam1 = ddnm_plus_lambda(self._one, a, sigma_y, sigma_t, eta)[0]
        d1, d2 = ddnm_plus_noise_coeffs(self._one_zero, a, sigma_y, sigma_t, eta)
        m = self._kept_cmajor
        nv = noise_vec.reshape(noise_vec.shape[0], -1)
        ev = et_vec.reshape(et_vec.shape[0], -1)
        noise_term = (m * d1[0] + (1 - m) * d1[1]) * nv + (
            m * d2[0] + (1 - m) * d2[1]
        ) * ev
        return lam1 * corr, noise_term

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        t = _interleave(vec.reshape(vec.shape[0], self.channels, -1))[:, self._sel]
        lam = ddnm_plus_lambda(self._s_full, a, sigma_y, sigma_t, eta)
        t = t * lam.reshape(1, -1)
        return self._from_interleaved(t[:, self._inv_sel])

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        tv = _interleave(vec.reshape(vec.shape[0], self.channels, -1))[:, self._sel]
        te = _interleave(epsilon.reshape(vec.shape[0], self.channels, -1))[:, self._sel]
        d1, d2 = ddnm_plus_noise_coeffs(self._s_full, a, sigma_y, sigma_t, eta)
        out = (tv * d1.reshape(1, -1) + te * d2.reshape(1, -1))[:, self._inv_sel]
        return self._from_interleaved(out)


# ---------------------------------------------------------------------------
# Patch helpers (SuperResolution, BlockCS)
# ---------------------------------------------------------------------------
def _patchize(vec, channels, img_dim, r):
    """(B, C*D*D) -> (B, C, y*y, r*r) non-overlapping r x r patches."""
    B, y = vec.shape[0], img_dim // r
    x = vec.reshape(B, channels, y, r, y, r).permute(0, 1, 2, 4, 3, 5)
    return x.reshape(B, channels, y * y, r * r)


def _unpatchize(patches, channels, img_dim, r):
    B, y = patches.shape[0], img_dim // r
    x = patches.reshape(B, channels, y, y, r, r).permute(0, 1, 2, 4, 3, 5)
    return x.reshape(B, channels * img_dim**2)


# ---------------------------------------------------------------------------
# SuperResolution (average pooling, patch-based SVD)
# ---------------------------------------------------------------------------
class SuperResolution(SVDOperator):
    """SVD of the ratio^2 -> 1 averaging row, applied per non-overlapping
    patch."""

    measurement_image = 'rgb'

    def __init__(self, channels: int, img_dim: int, ratio: int, device=None):
        assert img_dim % ratio == 0
        self.channels = channels
        self.img_dim = img_dim
        self.ratio = ratio
        self.y_dim = img_dim // ratio
        r2 = ratio**2
        u, s, v = _np_svd(np.full((1, r2), 1.0 / r2))
        self._u00 = float(u[0, 0])
        self._s_small = _t(s, device)  # (1,)
        self._v_small = _t(v, device)  # (r2, r2)
        s_patch = np.zeros(r2, np.float32)
        s_patch[0] = s[0]
        self._s_patch = _t(s_patch, device)

        # spectral reorder: out position -> index into the (C, y^2, r^2)
        # C-major flat patch array
        C, y2 = channels, self.y_dim**2
        src = np.arange(C * y2 * r2).reshape(C, y2, r2)
        order = np.zeros(C * self.img_dim**2, dtype=np.int64)
        order[: C * y2] = src[:, :, 0].reshape(-1)
        for idx in range(r2 - 1):
            order[C * y2 + idx :: r2 - 1] = src[:, :, idx + 1].reshape(-1)
        self._vt_order = _t(order, device)
        self._v_order = _t(np.argsort(order), device)

    def _patchize(self, vec):
        return _patchize(vec, self.channels, self.img_dim, self.ratio)

    def _unpatchize(self, patches):
        return _unpatchize(patches, self.channels, self.img_dim, self.ratio)

    def V(self, vec):
        p = vec.reshape(vec.shape[0], -1)[:, self._v_order]
        p = p.reshape(vec.shape[0], self.channels, self.y_dim**2, self.ratio**2)
        return self._unpatchize(p @ self._v_small.T)

    def Vt(self, vec):
        p = self._patchize(vec) @ self._v_small
        return p.reshape(vec.shape[0], -1)[:, self._vt_order]

    def U(self, vec):
        return self._u00 * vec.reshape(vec.shape[0], -1)

    Ut = U

    def singulars(self):
        return self._s_small.repeat(self.channels * self.y_dim**2)

    def add_zeros(self, vec):
        r = vec.reshape(vec.shape[0], -1)
        return _zero_pad(r, r.shape[1] * self.ratio**2)

    def range_project(self, vec):
        # P projects every patch onto v0 (for average pooling v0 = 1/r *
        # ones: broadcast the patch mean); s0 = 1/r > 0
        p = self._patchize(vec)
        v0 = self._v_small[:, 0]
        return self._unpatchize((p @ v0)[..., None] * v0)

    def noisy_update(self, x0_vec, apy, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        # the correction lives on the v0 component only, so Lambda reduces
        # to its s0 scalar; Lambda_noise's two patch transforms merge
        corr = self.range_project(x0_vec) - apy
        lam0 = ddnm_plus_lambda(self._s_patch[:1], a, sigma_y, sigma_t, eta)[0]
        d1, d2 = ddnm_plus_noise_coeffs(self._s_patch, a, sigma_y, sigma_t, eta)
        pn = self._patchize(noise_vec)
        pe = self._patchize(et_vec)
        noise_term = self._unpatchize(
            (pn * d1.reshape(1, 1, 1, -1) + pe * d2.reshape(1, 1, 1, -1))
            @ self._v_small.T
        )
        return lam0 * corr, noise_term

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        p = self._patchize(vec) @ self._v_small
        lam = ddnm_plus_lambda(self._s_patch, a, sigma_y, sigma_t, eta)
        return self._unpatchize((p * lam.reshape(1, 1, 1, -1)) @ self._v_small.T)

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        pv = self._patchize(vec)
        pe = self._patchize(epsilon)
        d1, d2 = ddnm_plus_noise_coeffs(self._s_patch, a, sigma_y, sigma_t, eta)
        pv = (pv * d1.reshape(1, 1, 1, -1)) @ self._v_small.T
        pe = (pe * d2.reshape(1, 1, 1, -1)) @ self._v_small.T
        return self._unpatchize(pv) + self._unpatchize(pe)


# ---------------------------------------------------------------------------
# SRConv (strided 1-D conv SR, Kronecker-factored)
# ---------------------------------------------------------------------------
def bicubic_kernel(factor: int, a: float = -0.5) -> np.ndarray:
    """The bicubic kernel the reference runner builds inline, normalised to
    sum 1."""

    def phi(x):
        x = abs(x)
        if x <= 1:
            return (a + 2) * x**3 - (a + 3) * x**2 + 1
        if x < 2:
            return a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a
        return 0.0

    k = np.zeros(factor * 4)
    for i in range(factor * 4):
        x = (1 / factor) * (i - np.floor(factor * 4 / 2) + 0.5)
        k[i] = phi(x)
    return (k / k.sum()).astype(np.float32)


def _conv_matrix(kernel: np.ndarray, img_dim: int, stride: int, reflective: bool):
    """1-D convolution matrix built row by row as the reference does
    (strided + reflective for SRConv, dense + zero-padded for Deblurring)."""
    klen = len(kernel)
    if stride > 1 or reflective:
        small_dim = img_dim // stride
        A = np.zeros((small_dim, img_dim), np.float64)
        for i in range(stride // 2, img_dim + stride // 2, stride):
            for j in range(i - klen // 2, i + klen // 2):
                j_eff = j
                if j_eff < 0:
                    j_eff = -j_eff - 1
                if j_eff >= img_dim:
                    j_eff = (img_dim - 1) - (j_eff - img_dim)
                A[i // stride, j_eff] += kernel[j - i + klen // 2]
        return A
    A = np.zeros((img_dim, img_dim), np.float64)
    for i in range(img_dim):
        for j in range(i - klen // 2, i + klen // 2):
            if j < 0 or j >= img_dim:
                continue
            A[i, j] = kernel[j - i + klen // 2]
    return A


def _sandwich(x, channels, dim, left, right):
    """left @ X @ right for each (B*C) plane X of x: (B, C, dim^2)."""
    B = x.shape[0]
    img = x.reshape(B * channels, dim, dim)
    return (left @ img @ right).reshape(B, channels, -1)


class SRConv(SVDOperator):
    """Strided-conv SR: Kronecker SVD of the 1-D strided conv matrix. The
    reference has no Lambda hooks for it; noisy mode runs the fused generic
    form (an extension of the JAX package, kept)."""

    measurement_image = 'rgb'

    def __init__(self, kernel: np.ndarray, channels: int, img_dim: int, stride: int = 1,
                 device=None):
        self.channels = channels
        self.img_dim = img_dim
        self.ratio = stride
        sd = img_dim // stride
        self.small_dim = sd
        A_small = _conv_matrix(np.asarray(kernel, np.float64), img_dim, stride, True)
        u, s, v = _np_svd(A_small)
        ZERO = 3e-2
        s = np.where(s < ZERO, 0.0, s)
        self._u_small = _t(u, device)  # (sd, sd)
        self._v_small = _t(v, device)  # (D, D)
        s_big = np.outer(s, s).reshape(-1).astype(np.float32)  # (sd^2,)
        self._singulars_np = s_big
        self._singulars = _t(np.repeat(s_big, 3), device)
        # P_1 permutation, length sd*D
        perm = np.array(
            [img_dim * i + j for i in range(sd) for j in range(sd)]
            + [img_dim * i + j for i in range(sd) for j in range(sd, img_dim)],
            dtype=np.int64,
        )
        n = len(perm)
        D2 = img_dim**2
        # Vt gather: out[:n] = x[perm], out[n:] = x[n:]
        self._vt_idx = _t(np.concatenate([perm, np.arange(n, D2)]), device)
        # V gather with zero-fill: simulate the two scatter assignments
        sim = np.zeros(D2, np.int64)
        src = np.arange(1, D2 + 1)
        sim[perm] = src[:n]
        sim[n:] = src[n:]
        self._v_idx = _t(sim - 1, device)  # -1 => zero-fill
        self._v_zero = _t(sim == 0, device)
        self._v_safe = _t(np.where(sim == 0, 0, sim - 1), device)
        # natural-layout range mask on the (V (x) V) Kronecker grid
        m1 = (s > 0).astype(np.float32)  # (sd,), s is post-threshold
        mask2d = np.zeros((img_dim, img_dim), np.float32)
        mask2d[:sd, :sd] = np.outer(m1, m1)
        self._range_mask = _t(mask2d.reshape(1, 1, -1), device)
        # natural-layout singular values on the Kronecker grid
        v2d = np.zeros((img_dim, img_dim), np.float64)
        v2d[:sd, :sd] = np.outer(s, s)
        self._s_nat = _t(v2d.reshape(1, 1, -1).astype(np.float32), device)

    def _by_v(self, x, left, right, dim):
        return _sandwich(x, self.channels, dim, left, right)

    def _spec(self, x):
        """(V (x) V)^T x per channel plane: (B, C, D^2)."""
        return self._by_v(x, self._v_small.T, self._v_small, self.img_dim)

    def _unspec(self, t):
        return self._by_v(t, self._v_small, self._v_small.T, self.img_dim)

    def V(self, vec):
        B = vec.shape[0]
        x = vec.reshape(B, self.img_dim**2, self.channels)
        t = torch.where(self._v_zero[None, :, None], 0.0, x[:, self._v_safe, :])
        return self._unspec(t.transpose(1, 2)).reshape(B, -1)

    def Vt(self, vec):
        B = vec.shape[0]
        t = self._spec(vec)[:, :, self._vt_idx]
        return t.transpose(1, 2).reshape(B, -1)

    def U(self, vec):
        B = vec.shape[0]
        t = vec.reshape(B, self.small_dim**2, self.channels).transpose(1, 2)
        out = self._by_v(t, self._u_small, self._u_small.T, self.small_dim)
        return out.reshape(B, -1)

    def Ut(self, vec):
        B = vec.shape[0]
        t = self._by_v(vec, self._u_small.T, self._u_small, self.small_dim)
        return t.transpose(1, 2).reshape(B, -1)

    def singulars(self):
        return self._singulars

    def add_zeros(self, vec):
        r = vec.reshape(vec.shape[0], -1)
        return _zero_pad(r, r.shape[1] * self.ratio**2)

    def range_project(self, vec):
        # P_1 and its inverse cancel; P = (V (x) V) mask (V (x) V)^T
        return self._unspec(self._spec(vec) * self._range_mask).reshape(vec.shape[0], -1)

    def prepare_measurement(self, y):
        return self._spec(SVDOperator.prepare_measurement(self, y))

    def range_correction(self, x_vec, spec_y):
        t = self._spec(x_vec)
        return self._unspec(t * self._range_mask - spec_y).reshape(x_vec.shape[0], -1)

    def noisy_update(self, x0_vec, spec_y, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        # fused form of the base class's generic Lambda/Lambda_noise, with
        # the coefficients evaluated on the natural Kronecker grid
        B = x0_vec.shape[0]
        corr_spec = self._spec(x0_vec) * self._range_mask - spec_y
        lam = ddnm_plus_lambda(self._s_nat, a, sigma_y, sigma_t, eta)
        lam_corr = self._unspec(corr_spec * lam).reshape(B, -1)
        d1, d2 = ddnm_plus_noise_coeffs(self._s_nat, a, sigma_y, sigma_t, eta)
        sn = self._spec(noise_vec)
        se = self._spec(et_vec)
        noise_term = self._unspec(sn * d1 + se * d2).reshape(B, -1)
        return lam_corr, noise_term


# ---------------------------------------------------------------------------
# Deblurring (dense 1-D conv, separable SVD)
# ---------------------------------------------------------------------------
def _quirk_natural(vals_sorted: np.ndarray, order: np.ndarray, channels: int):
    """Map a TILED per-singular table into the natural (pre-sort) spectral
    layout, per channel: (C, D^2) numpy.

    REFERENCE-QUIRK: the Deblurring family exposes singulars in a tiled
    channel layout while Vt's output is channel-interleaved, so a composed
    per-singular table addresses spectral slots through a shifted,
    channel-dependent lookup: the flat interleaved index of natural slot q
    in channel c is pos(q)*C + c, and the tiled table's value there is
    vals_sorted[(pos(q)*C + c) mod D^2]."""
    D2 = len(vals_sorted)
    pos = np.argsort(order)  # natural slot -> sorted position
    f = pos[None, :] * channels + np.arange(channels)[:, None]  # (C, D^2)
    return vals_sorted[f % D2]


def _deblur_range_mask(s_big_nat: np.ndarray, order: np.ndarray, channels: int,
                       device=None):
    """Effective A+ A mask of the Deblurring family in the natural layout,
    per channel: (1, C, D^2). See _quirk_natural."""
    m = _quirk_natural((s_big_nat[order] > 0).astype(np.float32), order, channels)
    return _t(m[None], device)


class _Separable(SVDOperator):
    """Shared runtime of Deblurring and Deblurring2D: V = V1 (x) V2 and
    U = U1 (x) U2 on each channel plane, then the sort permutation over the
    D^2 spectral slots, interleaved over channels."""

    measurement_image = 'rgb'

    def _by_mat(self, x, left, right):
        return _sandwich(x, self.channels, self.img_dim, left, right)

    def _unsort(self, vec):
        """(B, D^2*C) interleaved sorted spectrum -> (B, C, D^2) natural."""
        x = vec.reshape(vec.shape[0], self.img_dim**2, self.channels)[:, self._inv_perm, :]
        return x.transpose(1, 2)

    def _sort(self, t):
        """(B, C, D^2) natural -> (B, D^2*C) interleaved sorted spectrum."""
        return t[:, :, self._perm].transpose(1, 2).reshape(t.shape[0], -1)

    def V(self, vec):
        return self._by_mat(self._unsort(vec), self._v1, self._v2.T).reshape(vec.shape[0], -1)

    def Vt(self, vec):
        return self._sort(self._by_mat(vec, self._v1.T, self._v2))

    def U(self, vec):
        return self._by_mat(self._unsort(vec), self._u1, self._u2.T).reshape(vec.shape[0], -1)

    def Ut(self, vec):
        return self._sort(self._by_mat(vec, self._u1.T, self._u2))

    def singulars(self):
        # REFERENCE-QUIRK: tiled (not interleaved) channel layout
        return self._singulars

    def add_zeros(self, vec):
        return vec.reshape(vec.shape[0], -1)

    def _spec(self, x):
        return self._by_mat(x, self._v1.T, self._v2)

    def _unspec(self, t):
        return self._by_mat(t, self._v1, self._v2.T)

    def range_project(self, vec):
        return self._unspec(self._spec(vec) * self._range_mask).reshape(vec.shape[0], -1)

    def prepare_measurement(self, y):
        # natural-spectral measurement (B, C, D^2) for the fused step
        return self._spec(SVDOperator.prepare_measurement(self, y))

    def range_correction(self, x_vec, spec_y):
        t = self._spec(x_vec)
        return self._unspec(t * self._range_mask - spec_y).reshape(x_vec.shape[0], -1)


class Deblurring(_Separable):
    """Separable deblurring via the SVD of the 1-D conv matrix. See the
    module's REFERENCE-QUIRK note on the tiled singular layout."""

    def __init__(
        self,
        kernel: np.ndarray,
        channels: int,
        img_dim: int,
        ZERO: float = 3e-2,
        perm: np.ndarray | None = None,
        device=None,
    ):
        self.channels = channels
        self.img_dim = img_dim
        A_small = _conv_matrix(np.asarray(kernel, np.float64), img_dim, 1, False)
        u, s, v = _np_svd(A_small)
        s_orig = s.copy()
        s = np.where(s < ZERO, 0.0, s)
        self._u_small = _t(u, device)
        self._v_small = _t(v, device)
        self._u1 = self._u2 = self._u_small
        self._v1 = self._v2 = self._v_small
        s_big = np.outer(s, s).reshape(-1)
        s_big_orig = np.outer(s_orig, s_orig).reshape(-1)
        # descending sort over massively tied products: any tie order gives a
        # self-consistent operator; `perm` lets tests inject another one
        order = np.argsort(-s_big, kind="stable") if perm is None else np.asarray(perm)
        self._perm = _t(order, device)
        self._inv_perm = _t(np.argsort(order), device)
        self._singulars_np = s_big[order].astype(np.float32)
        self._singulars = _t(np.tile(self._singulars_np, 3), device)
        self._singulars_orig = _t(s_big_orig[order].astype(np.float32), device)
        self._singulars_orig_nat = _t(s_big_orig.astype(np.float32), device)
        self._range_mask = _deblur_range_mask(s_big, order, channels, device)

    def noisy_update(self, x0_vec, spec_y, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        # Lambda's coefficients are channel-independent functions of the
        # PRE-threshold singulars, evaluated in the natural (pre-sort) layout
        # so the sort permutation cancels; Lambda_noise's two V legs merge.
        # 3 Kronecker sandwiches per step, no gathers.
        B = x0_vec.shape[0]
        corr_spec = self._spec(x0_vec) * self._range_mask - spec_y
        lam = ddnm_plus_lambda(self._singulars_orig_nat, a, sigma_y, sigma_t, eta)
        lam_corr = self._unspec(corr_spec * lam.reshape(1, 1, -1)).reshape(B, -1)
        d1, d2 = ddnm_plus_noise_coeffs(self._singulars_orig_nat, a, sigma_y, sigma_t, eta)
        nv = noise_vec.reshape(B, self.channels, -1)
        ev = et_vec.reshape(B, self.channels, -1)
        noise_term = self._unspec(
            nv * d1.reshape(1, 1, -1) + ev * d2.reshape(1, 1, -1)
        ).reshape(B, -1)
        return lam_corr, noise_term

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        B = vec.shape[0]
        t = self._spec(vec)[:, :, self._perm].transpose(1, 2)  # (B, D^2, C)
        lam = ddnm_plus_lambda(self._singulars_orig, a, sigma_y, sigma_t, eta)
        t = (t * lam.reshape(1, -1, 1)).transpose(1, 2)[:, :, self._inv_perm]
        return self._unspec(t).reshape(B, -1)

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        B = vec.shape[0]
        d1, d2 = ddnm_plus_noise_coeffs(self._singulars_orig, a, sigma_y, sigma_t, eta)

        def side(x, d):
            t = x.reshape(B, self.channels, -1)[:, :, self._perm]
            t = (t.transpose(1, 2) * d.reshape(1, -1, 1)).transpose(1, 2)
            return self._unspec(t[:, :, self._inv_perm]).reshape(B, -1)

        return side(vec, d1) + side(epsilon, d2)


# ---------------------------------------------------------------------------
# Deblurring2D (anisotropic)
# ---------------------------------------------------------------------------
class Deblurring2D(_Separable):
    """Anisotropic deblurring: separate 1-D kernels per axis. The reference
    has no Lambda hooks for it; noisy mode runs the fused generic form."""

    def __init__(
        self,
        kernel1: np.ndarray,
        kernel2: np.ndarray,
        channels: int,
        img_dim: int,
        perm: np.ndarray | None = None,
        device=None,
    ):
        self.channels = channels
        self.img_dim = img_dim
        A1 = _conv_matrix(np.asarray(kernel1, np.float64), img_dim, 1, False)
        A2 = _conv_matrix(np.asarray(kernel2, np.float64), img_dim, 1, False)
        u1, s1, v1 = _np_svd(A1)
        u2, s2, v2 = _np_svd(A2)
        ZERO = 3e-2
        s1 = np.where(s1 < ZERO, 0.0, s1)
        s2 = np.where(s2 < ZERO, 0.0, s2)
        self._u1, self._v1 = _t(u1, device), _t(v1, device)
        self._u2, self._v2 = _t(u2, device), _t(v2, device)
        s_big = np.outer(s1, s2).reshape(-1)
        order = np.argsort(-s_big, kind="stable") if perm is None else np.asarray(perm)
        self._perm = _t(order, device)
        self._inv_perm = _t(np.argsort(order), device)
        self._singulars_np = s_big[order].astype(np.float32)
        self._singulars = _t(np.tile(self._singulars_np, 3), device)
        self._range_mask = _deblur_range_mask(s_big, order, channels, device)
        # quirk-natural singular matrix (1, C, D^2): what the generic
        # Lambda/Lambda_noise coefficients effectively see per slot
        self._squirk_nat = _t(_quirk_natural(self._singulars_np, order, channels)[None],
                              device)

    def noisy_update(self, x0_vec, spec_y, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        # fused form of the generic Lambda/Lambda_noise: coefficients on the
        # quirk-natural singular matrix, so the sort permutation cancels
        B = x0_vec.shape[0]
        corr_spec = self._spec(x0_vec) * self._range_mask - spec_y
        lam = ddnm_plus_lambda(self._squirk_nat, a, sigma_y, sigma_t, eta)
        lam_corr = self._unspec(corr_spec * lam).reshape(B, -1)
        d1, d2 = ddnm_plus_noise_coeffs(self._squirk_nat, a, sigma_y, sigma_t, eta)
        sn = self._spec(noise_vec)
        se = self._spec(et_vec)
        noise_term = self._unspec(sn * d1 + se * d2).reshape(B, -1)
        return lam_corr, noise_term


# ---------------------------------------------------------------------------
# Walsh-Hadamard compressive sensing
# ---------------------------------------------------------------------------
class WalshHadamardCS(SVDOperator):
    """Compressive sensing in the Walsh-Hadamard basis with a random pixel
    permutation. The transform is self-inverse with the 1/img_dim
    normalisation, and runs through `ddnm_tpu_torch.ops.fwht`."""

    # route of every transform: None (the kernel for a CUDA tensor, the
    # plain version for a CPU tensor), "kernel" or "torch"
    force: str | None = None

    def __init__(self, channels: int, img_dim: int, ratio: int, perm: np.ndarray,
                 device=None):
        self.channels = channels
        self.img_dim = img_dim
        self.ratio = ratio
        perm = np.asarray(perm, dtype=np.int64)
        self._perm = _t(perm, device)
        self._inv_perm = _t(np.argsort(perm), device)
        n_kept = channels * img_dim**2 // ratio
        self._singulars = torch.ones(n_kept, device=device)
        s_full = np.zeros(channels * img_dim**2, np.float32)
        s_full[:n_kept] = 1.0
        self._s_full = _t(s_full, device)
        # kept WH coefficients in the unpermuted transform layout: the pixel
        # permutation cancels inside P = A+ A
        wh_mask = np.zeros(img_dim**2, np.float32)
        wh_mask[perm[: img_dim**2 // ratio]] = 1.0
        self._wh_mask = _t(wh_mask.reshape(1, 1, -1), device)
        self._one = torch.ones(1, device=device)
        self._one_zero = _t(np.array([1.0, 0.0], np.float32), device)

    def fwht(self, a):
        """(B, C, P) -> (B, C, P), normalised by 1/img_dim."""
        return _fwht(a, float(self.img_dim), force=self.force)

    def _planes(self, vec):
        return vec.reshape(vec.shape[0], self.channels, -1)

    def V(self, vec):
        B = vec.shape[0]
        x = vec.reshape(B, -1, self.channels).transpose(1, 2)
        return self.fwht(x[:, :, self._inv_perm]).reshape(B, -1)

    def Vt(self, vec):
        t = self.fwht(self._planes(vec))[:, :, self._perm]
        return t.transpose(1, 2).reshape(vec.shape[0], -1)

    def U(self, vec):
        return vec.reshape(vec.shape[0], -1)

    Ut = U

    def singulars(self):
        return self._singulars

    def add_zeros(self, vec):
        return _zero_pad(vec, self.channels * self.img_dim**2)

    def range_project(self, vec):
        t = self.fwht(self._planes(vec))
        return self.fwht(t * self._wh_mask).reshape(vec.shape[0], -1)

    def prepare_measurement(self, y):
        # natural-WH-layout spectral measurement (B, C, D^2), consumed by
        # range_correction / noisy_update below
        apy = SVDOperator.prepare_measurement(self, y)
        return self.fwht(self._planes(apy)) * self._wh_mask

    def range_correction(self, x_vec, spec_y):
        spec_x = self.fwht(self._planes(x_vec))
        return self.fwht(spec_x * self._wh_mask - spec_y).reshape(x_vec.shape[0], -1)

    def noisy_update(self, x0_vec, spec_y, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        # the pixel permutation cancels; Lambda reduces to its s=1 scalar on
        # the range-space-only correction spectrum, and Lambda_noise's two V
        # transforms merge into one by linearity: 3 transforms per step
        B = x0_vec.shape[0]
        corr_spec = self.fwht(self._planes(x0_vec)) * self._wh_mask - spec_y
        lam1 = ddnm_plus_lambda(self._one, a, sigma_y, sigma_t, eta)[0]
        lam_corr = self.fwht(lam1 * corr_spec).reshape(B, -1)
        d1, d2 = ddnm_plus_noise_coeffs(self._one_zero, a, sigma_y, sigma_t, eta)
        m = self._wh_mask
        d1m = m * d1[0] + (1 - m) * d1[1]
        d2m = m * d2[0] + (1 - m) * d2[1]
        noise_term = self.fwht(d1m * self._planes(noise_vec)
                               + d2m * self._planes(et_vec)).reshape(B, -1)
        return lam_corr, noise_term

    def _scale_to_image(self, planes, d):
        """V(d * spectrum) for a (B, C, P) WH spectrum in natural order and a
        spectral table d (N,) in the permuted interleaved layout."""
        B = planes.shape[0]
        t = planes[:, :, self._perm].transpose(1, 2).reshape(B, -1) * d.reshape(1, -1)
        t = t.reshape(B, -1, self.channels).transpose(1, 2)
        return self.fwht(t[:, :, self._inv_perm]).reshape(B, -1)

    def Lambda(self, vec, a, sigma_y, sigma_t, eta):
        lam = ddnm_plus_lambda(self._s_full, a, sigma_y, sigma_t, eta)
        return self._scale_to_image(self.fwht(self._planes(vec)), lam)

    def Lambda_noise(self, vec, a, sigma_y, sigma_t, eta, epsilon):
        # as the reference: the isotropic noise and epsilon enter as spectra
        # already (no Vt leg), only V rotates them back
        d1, d2 = ddnm_plus_noise_coeffs(self._s_full, a, sigma_y, sigma_t, eta)
        return (self._scale_to_image(self._planes(vec), d1)
                + self._scale_to_image(self._planes(epsilon), d2))


# ---------------------------------------------------------------------------
# Block-based compressive sensing
# ---------------------------------------------------------------------------
class BlockCS(SVDOperator):
    """32x32-patch random Gaussian measurement. The measurement basis comes
    from the SVD of a random 1024x1024 matrix, drawn from a seeded numpy
    generator unless `matrix` is given."""

    def __init__(self, channels: int, img_dim: int, ratio: float,
                 matrix: np.ndarray | None = None, seed: int = 1234, device=None):
        self.channels = channels
        self.img_dim = img_dim
        self.patch = 32
        self.y_dim = img_dim // 32
        if matrix is None:
            matrix = np.random.default_rng(seed).standard_normal((1024, 1024))
        _, _, v = _np_svd(np.asarray(matrix, np.float64))
        self._v_small = _t(v, device)  # (1024, 1024)
        self.cs_size = int(32 * 32 * ratio)
        self._singulars = torch.ones(self.cs_size, device=device)
        self._v_kept = self._v_small[:, : self.cs_size]

        C, y2, r2 = channels, self.y_dim**2, 1024
        src = np.arange(C * y2 * r2).reshape(C, y2, r2)
        order = np.concatenate(
            [src[:, :, : self.cs_size].reshape(-1), src[:, :, self.cs_size :].reshape(-1)]
        )
        self._vt_order = _t(order, device)
        self._v_order = _t(np.argsort(order), device)
        self._one = torch.ones(1, device=device)
        self._one_zero = _t(np.array([1.0, 0.0], np.float32), device)
        self._kept_comp = torch.arange(1024, device=device) < self.cs_size

    def _patchize(self, vec):
        return _patchize(vec, self.channels, self.img_dim, self.patch)

    def _unpatchize(self, patches):
        return _unpatchize(patches, self.channels, self.img_dim, self.patch)

    def V(self, vec):
        p = vec.reshape(vec.shape[0], -1)[:, self._v_order]
        p = p.reshape(vec.shape[0], self.channels, self.y_dim**2, 1024)
        return self._unpatchize(p @ self._v_small.T)

    def Vt(self, vec):
        p = self._patchize(vec) @ self._v_small
        return p.reshape(vec.shape[0], -1)[:, self._vt_order]

    def U(self, vec):
        return vec.reshape(vec.shape[0], -1)

    Ut = U

    def singulars(self):
        return self._singulars.repeat(self.channels * self.y_dim**2)

    def add_zeros(self, vec):
        return _zero_pad(vec, self.channels * self.img_dim**2)

    def range_project(self, vec):
        # per-patch projection onto the first cs_size measurement directions
        return self._unpatchize(self._patchize(vec) @ self._v_kept @ self._v_kept.T)

    def prepare_measurement(self, y):
        # kept-component patch spectrum of A_pinv(y), (B, C, y^2, cs_size)
        return self._patchize(SVDOperator.prepare_measurement(self, y)) @ self._v_kept

    def range_correction(self, x_vec, spec_y):
        p = self._patchize(x_vec) @ self._v_kept
        return self._unpatchize((p - spec_y) @ self._v_kept.T)

    def noisy_update(self, x0_vec, spec_y, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        # fused form of the generic Lambda/Lambda_noise: singulars are 1 on
        # the kept components and 0 elsewhere, so Lambda reduces to its s=1
        # scalar and the noise coefficients split kept vs dropped components
        corr_spec = self._patchize(x0_vec) @ self._v_kept - spec_y
        lam1 = ddnm_plus_lambda(self._one, a, sigma_y, sigma_t, eta)[0]
        lam_corr = self._unpatchize((lam1 * corr_spec) @ self._v_kept.T)
        d1, d2 = ddnm_plus_noise_coeffs(self._one_zero, a, sigma_y, sigma_t, eta)
        d1v = torch.where(self._kept_comp, d1[0], d1[1])
        d2v = torch.where(self._kept_comp, d2[0], d2[1])
        sn = self._patchize(noise_vec) @ self._v_small
        se = self._patchize(et_vec) @ self._v_small
        noise_term = self._unpatchize((sn * d1v + se * d2v) @ self._v_small.T)
        return lam_corr, noise_term


# ---------------------------------------------------------------------------
# GeneralA (dense)
# ---------------------------------------------------------------------------
class GeneralA(SVDOperator):
    """Explicit dense SVD of an arbitrary A."""

    def __init__(self, A: np.ndarray, device=None):
        u, s, v = _np_svd(np.asarray(A, np.float64))
        s = np.where(s < 1e-3, 0.0, s)
        self._u, self._v = _t(u, device), _t(v, device)
        self._s = _t(s.astype(np.float32), device)

    def _mat_by_vec(self, M, v):
        return v.reshape(v.shape[0], -1) @ M.T

    def V(self, vec):
        return self._mat_by_vec(self._v, vec)

    def Vt(self, vec):
        return self._mat_by_vec(self._v.T, vec)

    def U(self, vec):
        return self._mat_by_vec(self._u, vec)

    def Ut(self, vec):
        return self._mat_by_vec(self._u.T, vec)

    def singulars(self):
        return self._s

    def A(self, vec):
        # tall A (rows > cols): the spectral vector is zero-padded to the
        # row count before the full-U rotation
        k = self._s.shape[0]
        spec = self._s[None] * self.Vt(vec).reshape(vec.shape[0], -1)[:, :k]
        return self.U(_zero_pad(spec, self._u.shape[0]))

    def add_zeros(self, vec):
        # sliced to the true spectral size, so tall A works too
        k = self._s.shape[0]
        return _zero_pad(vec.reshape(vec.shape[0], -1)[:, :k], self._v.shape[0])

    # --- fused spectral forms (stay in V's coordinate basis per step) ------
    def _s_full(self):
        n, m = self._v.shape[0], self._s.shape[0]
        return torch.cat([self._s, self._s.new_zeros(n - m)])

    def prepare_measurement(self, y):
        """Spectral-space pinv of y on the full V axis (zeros in the null
        space); Ut(y) is sliced to the singular count so tall A works."""
        s = self._s
        inv = torch.where(s == 0, 0.0, 1.0 / torch.where(s == 0, 1.0, s))
        uty = self.Ut(y).reshape(y.shape[0], -1)[:, : s.shape[0]]
        return self.add_zeros(inv[None] * uty)

    def range_project(self, vec):
        return self.V(torch.where(self._s_full() == 0, 0.0, self.Vt(vec)))

    def range_correction(self, x_vec, spec_y):
        spec = torch.where(self._s_full() == 0, 0.0, self.Vt(x_vec))
        return self.V(spec - spec_y)

    def noisy_update(self, x0_vec, spec_y, a, sigma_y, sigma_t, eta,
                     noise_vec, et_vec):
        # one spectral round trip per term; the two noise legs merge into one
        # V by linearity
        s_full = self._s_full()
        corr_spec = torch.where(s_full == 0, 0.0, self.Vt(x0_vec)) - spec_y
        lam = ddnm_plus_lambda(s_full, a, sigma_y, sigma_t, eta)
        lam_corr = self.V(lam[None] * corr_spec)
        d1, d2 = ddnm_plus_noise_coeffs(s_full, a, sigma_y, sigma_t, eta)
        noise_term = self.V(d1[None] * self.Vt(noise_vec) + d2[None] * self.Vt(et_vec))
        return lam_corr, noise_term


# ---------------------------------------------------------------------------
# Factory mirroring the reference runner's task dispatch
# ---------------------------------------------------------------------------
def build_svd_operator(
    deg: str,
    *,
    channels: int = 3,
    image_size: int = 256,
    deg_scale: float = 4.0,
    mask: np.ndarray | None = None,
    perm: np.ndarray | None = None,
    seed: int = 1234,
    device: str | torch.device | None = None,
) -> SVDOperator:
    """Map a task string to a configured operator on `device`.

    `mask` (H, W) binary for inpainting; `perm` pixel permutation for
    cs_walshhadamard (drawn from `seed` if omitted)."""
    dev = {"device": device}
    if deg == "cs_walshhadamard":
        compress_by = round(1 / deg_scale)
        if perm is None:
            perm = np.random.default_rng(seed).permutation(image_size**2)
        return WalshHadamardCS(channels, image_size, compress_by, perm, **dev)
    if deg == "cs_blockbased":
        return BlockCS(channels, image_size, deg_scale, seed=seed, **dev)
    if deg == "inpainting":
        if mask is None:
            raise ValueError("inpainting requires a mask")
        flat = np.asarray(mask).reshape(-1)
        missing_r = np.nonzero(flat == 0)[0] * 3
        missing = np.concatenate([missing_r, missing_r + 1, missing_r + 2])
        return Inpainting(channels, image_size, missing, **dev)
    if deg == "denoising":
        return Denoising(channels, image_size, **dev)
    if deg == "colorization":
        return Colorization(image_size, **dev)
    if deg == "sr_averagepooling":
        return SuperResolution(channels, image_size, int(deg_scale), **dev)
    if deg == "sr_bicubic":
        factor = int(deg_scale)
        k = bicubic_kernel(factor)
        return SRConv(k / k.sum(), channels, image_size, stride=factor, **dev)
    if deg == "deblur_uni":
        return Deblurring(np.full(9, 1 / 9, np.float32), channels, image_size, **dev)
    if deg == "deblur_gauss":
        sigma = 10.0
        k = np.exp(-0.5 * (np.array([-2, -1, 0, 1, 2]) / sigma) ** 2)
        return Deblurring((k / k.sum()).astype(np.float32), channels, image_size, **dev)
    if deg == "deblur_aniso":
        x = np.arange(-4, 5)
        k2 = np.exp(-0.5 * (x / 20.0) ** 2)
        k1 = np.exp(-0.5 * (x / 1.0) ** 2)
        return Deblurring2D(
            (k1 / k1.sum()).astype(np.float32),
            (k2 / k2.sum()).astype(np.float32),
            channels,
            image_size,
            **dev,
        )
    raise ValueError(f"degradation type {deg} not supported")
