"""Elementwise RL kernel tests vs the float64 reference semantics.

Ports /root/reference/tests/test_gpu_kernels_impl.cu's structure (device
kernels vs CPU kernels, :21-487): here the JAX f32 kernels are checked
against the numpy mirror, including NaN/Inf/zero clamping edge cases.
"""

import numpy as np
import pytest

from libmultiviewnative_jax.core.kernels import (
    compute_quotient,
    final_values,
    regularized_final_values,
)
from libmultiviewnative_jax.reference.numpy_ref import (
    np_final_values,
    np_regularized_final_values,
)


def _data(rng, n=256):
    psi = rng.gamma(2.0, 5.0, n).astype(np.float32)
    integral = rng.gamma(2.0, 0.5, n).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return psi, integral, weights


def test_compute_quotient(rng):
    view, integral, _ = _data(rng)
    out = np.asarray(compute_quotient(view, integral))
    np.testing.assert_allclose(out, view / integral, rtol=1e-5)


def test_compute_quotient_div_by_zero_yields_inf():
    view = np.ones(4, np.float32)
    integral = np.zeros(4, np.float32)
    out = np.asarray(compute_quotient(view, integral))
    assert np.all(np.isinf(out))


def test_final_values_matches_reference(rng):
    psi, integral, weights = _data(rng)
    ours = np.asarray(final_values(psi, integral, weights, 1e-4))
    ref = np_final_values(
        psi.astype(np.float64), integral.astype(np.float64), weights, 1e-4
    )
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_final_values_clamps_nan_inf_nonpositive():
    psi = np.array([1.0, 1.0, 1.0, 1.0, 0.0], np.float32)
    integral = np.array([np.nan, np.inf, -1.0, 0.0, 5.0], np.float32)
    weights = np.ones(5, np.float32)
    out = np.asarray(final_values(psi, integral, weights, 1e-4))
    # all these map to minValue per inc/cpu_kernels.h:41-49; the blend
    # w*(min - psi) + psi re-rounds in f32, hence the small atol
    np.testing.assert_allclose(out, np.full(5, 1e-4, np.float32), atol=5e-8)


def test_final_values_weight_blend():
    psi = np.full(3, 2.0, np.float32)
    integral = np.full(3, 3.0, np.float32)  # new value = 6
    weights = np.array([0.0, 0.5, 1.0], np.float32)
    out = np.asarray(final_values(psi, integral, weights, 1e-4))
    np.testing.assert_allclose(out, [2.0, 4.0, 6.0], rtol=1e-6)


def test_regularized_final_values_matches_reference(rng):
    psi, integral, weights = _data(rng)
    lam = 0.006  # golden-data lambda, tiff_fixtures.hpp:449
    ours = np.asarray(regularized_final_values(psi, integral, weights, lam, 1e-4))
    ref = np_regularized_final_values(
        psi.astype(np.float64), integral.astype(np.float64), weights, lam, 1e-4
    )
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_regularized_reduces_to_plain_at_small_lambda(rng):
    # (sqrt(1+2*lam*v)-1)/lam -> v as lam -> 0.  lam can't go below ~1e-4 in
    # f32 (catastrophic cancellation in sqrt(1+x)-1), so check the limit at
    # 1e-4 with a tolerance covering both the O(lam*v) expansion term and
    # the f32 rounding.
    psi, integral, weights = _data(rng)
    lam = 1e-4
    reg = np.asarray(regularized_final_values(psi, integral, weights, lam, 1e-4))
    plain = np.asarray(final_values(psi, integral, weights, 1e-4))
    np.testing.assert_allclose(reg, plain, rtol=2e-2, atol=1e-3)
