"""Multi-view Wiener deconvolution — closed-form spectral inversion.

Not present in the reference (its only family is iterative RL); added
because on an accelerator the whole solve is a handful of batched FFT-space ops:

    psi_hat = sum_v conj(K_v) * Phi_v  /  (sum_v |K_v|^2 + nsr)

with nsr the noise-to-signal regularizer.  Uses the same wrapped-kernel
spectrum convention as the RL path (inc/padd_utils.h:11-40 centering), so
results are directly comparable.  Serves as a fast preview or an RL
initializer (psi0 = wiener(...) typically halves the RL iterations needed).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core.fft import irfft3, rfft3
from ..deconv.rl import prepare_spectra
from ..deconv.workspace import MultiViewData


@dataclasses.dataclass
class WienerFilter:
    nsr: float = 1e-3  # noise-to-signal ratio (Tikhonov-style floor)
    clip_min: float = 0.0  # clamp negatives (intensities are non-negative)

    def run(self, data: MultiViewData) -> jnp.ndarray:
        return wiener_deconvolve(data, self.nsr, self.clip_min)


@jax.jit
def _wiener(views, k_hat, nsr, clip_min):
    v_hat = rfft3(views)
    num = jnp.sum(jnp.conj(k_hat) * v_hat, axis=0)
    den = jnp.sum(jnp.abs(k_hat) ** 2, axis=0) + nsr
    out = irfft3(num / den, views.shape[-3:])
    return jnp.maximum(out, clip_min)


def wiener_deconvolve(
    data: MultiViewData, nsr: float = 1e-3, clip_min: float = 0.0
) -> jnp.ndarray:
    """One-shot multi-view Wiener estimate from the stacked views."""
    spatial = tuple(data.views.shape[-3:])
    k_hat = prepare_spectra(data.kernel1, spatial)
    return _wiener(data.views, k_hat, jnp.float32(nsr), jnp.float32(clip_min))
