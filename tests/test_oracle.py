"""Self-tests for the brute-force oracle — the analog of the reference's
test_discrete_convolve.cpp:255-414 (the oracle itself is verified against
hand-built expectations before it is trusted to judge the engines)."""

import numpy as np
import pytest

from libmultiviewnative_jax.reference.oracle import (
    direct_convolve,
    l1norm,
    l2norm,
    l2norm_within_limits,
    rms,
    rms_within_limits,
)


def test_identity_kernel():
    img = np.arange(27.0).reshape(3, 3, 3)
    k = np.zeros((3, 3, 3))
    k[1, 1, 1] = 1.0
    np.testing.assert_array_equal(direct_convolve(img, k, "zero"), img)
    np.testing.assert_array_equal(direct_convolve(img, k, "wrap"), img)


def test_shift_kernel_zero_boundary():
    # kernel with weight at (1,1,2) => out[p] = img[p + c - j] = img[z,y,x-1]
    img = np.zeros((1, 1, 5))
    img[0, 0, 2] = 1.0
    k = np.zeros((1, 1, 3))
    k[0, 0, 2] = 1.0  # j = 2, c = 1 -> shift x by -1... out[p]=img[x+1-2]
    out = direct_convolve(img, k, "zero")
    want = np.zeros((1, 1, 5))
    want[0, 0, 3] = 1.0
    np.testing.assert_array_equal(out, want)


def test_wrap_vs_zero_differ_only_at_edges():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(6, 6, 6))
    k = np.ones((3, 3, 3)) / 27.0
    a = direct_convolve(img, k, "zero")
    b = direct_convolve(img, k, "wrap")
    interior = (slice(1, -1),) * 3
    np.testing.assert_allclose(a[interior], b[interior], rtol=1e-12)
    assert not np.allclose(a, b)


def test_sum_preservation_wrap():
    # circular convolution with a kernel of mass m scales the total sum by m
    rng = np.random.default_rng(1)
    img = rng.uniform(1, 2, (5, 5, 5))
    k = rng.uniform(0, 1, (3, 3, 3))
    out = direct_convolve(img, k, "wrap")
    np.testing.assert_allclose(out.sum(), img.sum() * k.sum(), rtol=1e-10)


def test_norms():
    a = np.zeros((10, 10, 10))
    b = np.ones((10, 10, 10)) * 2.0
    # reference semantics: raw SUM of squared diffs (test_algorithms.hpp:88-99)
    assert l2norm(a, b) == pytest.approx(4.0 * a.size)
    assert rms(a, b) == pytest.approx(2.0)
    assert l1norm(a, b) == pytest.approx(2.0)
    # central crop norm sees only the middle
    c = a.copy()
    c[0, 0, 0] = 100.0  # corner disturbance invisible to the central crop
    assert l2norm_within_limits(c, a, 0.3, 0.7) == 0.0
    assert rms_within_limits(c, a, 0.3, 0.7) == 0.0
    assert l2norm(c, a) > 0
    # crop norm counts the same voxels as an explicit central slice
    d = np.arange(1000, dtype=np.float64).reshape(10, 10, 10)
    sl = (slice(3, 7),) * 3
    assert l2norm_within_limits(d, a, 0.3, 0.7) == pytest.approx(
        np.sum(d[sl] ** 2)
    )
