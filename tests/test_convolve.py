"""Tier-2 tests: FFT + direct convolution engines vs the analytic fixture.

Ports the expectations of /root/reference/tests/test_fftw_convolve.cpp
(:271-1110) and test_cpu_{symm,asymm}_convolve.cpp: FFT convolution of the
ramp image by each analytic kernel must match the brute-force oracle
(zero-boundary via the linear path, wrap-boundary via the circular path);
odd AND even kernel dims are covered (the asymm (K+1)×K×(K-1) kernel,
test_fixtures.hpp:112-117).
"""

import numpy as np
import pytest

from libmultiviewnative_jax.core.convolve import (
    convolve_spectrum,
    direct_convolve3d,
    fft_convolve3d,
)
from libmultiviewnative_jax.core.fft import forward_kernel_spectrum
from libmultiviewnative_jax.reference.oracle import direct_convolve, rms

from fixtures import convolution_fixture_3d

IMAGE, ONE, KERNELS, EXPECTED = convolution_fixture_3d(K=3, N=8)
KNAMES = sorted(KERNELS)


@pytest.mark.parametrize("kname", KNAMES)
def test_fft_convolve_linear_matches_oracle(kname):
    out = np.asarray(fft_convolve3d(IMAGE, KERNELS[kname], mode="linear"))
    # float32 FFT vs float64 oracle; values up to ~512*27 -> atol scaled
    assert rms(out, EXPECTED[kname]) < 1e-2
    np.testing.assert_allclose(out, EXPECTED[kname], rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("kname", KNAMES)
def test_fft_convolve_circular_matches_wrap_oracle(kname):
    out = np.asarray(fft_convolve3d(IMAGE, KERNELS[kname], mode="circular"))
    want = direct_convolve(IMAGE, KERNELS[kname], boundary="wrap")
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-2)


@pytest.mark.parametrize("kname", KNAMES)
@pytest.mark.parametrize("mode", ["circular", "linear"])
def test_direct_convolve_matches_oracle(kname, mode):
    out = np.asarray(direct_convolve3d(IMAGE, KERNELS[kname], mode=mode))
    boundary = "wrap" if mode == "circular" else "zero"
    want = direct_convolve(IMAGE, KERNELS[kname], boundary=boundary)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-2)


def test_spectrum_path_equals_oneshot():
    # half_inplace contract (inc/cpu_convolve.h:217-291): precomputed kernel
    # spectrum path == one-shot path
    k = KERNELS["all1"]
    k_hat = forward_kernel_spectrum(k, IMAGE.shape)
    a = np.asarray(convolve_spectrum(IMAGE, k_hat))
    b = np.asarray(fft_convolve3d(IMAGE, k, mode="circular"))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3)


def test_batched_convolve_matches_loop():
    # leading batch axis == the reference's batched many-fold workload
    # (bench/bench_cpu_many_nd_folds.cpp)
    rng = np.random.default_rng(7)
    batch = rng.normal(size=(4, 8, 8, 8)).astype(np.float32)
    k = KERNELS["horizontal"]
    k_hat = forward_kernel_spectrum(k, (8, 8, 8))
    out = np.asarray(convolve_spectrum(batch, k_hat))
    for i in range(4):
        single = np.asarray(convolve_spectrum(batch[i], k_hat))
        np.testing.assert_allclose(out[i], single, rtol=1e-5, atol=1e-5)


def test_identity_kernel_is_noop():
    out = np.asarray(fft_convolve3d(IMAGE, KERNELS["identity"], mode="circular"))
    np.testing.assert_allclose(out, IMAGE, rtol=1e-5, atol=5e-3)


@pytest.mark.parametrize(
    "shape",
    [(8, 8, 8), (9, 9, 9), (7, 8, 9), (13, 13, 13), (16, 8, 4)],
)
def test_fft_roundtrip_stability(shape):
    # numerical-stability envelope of test_fftw_numerical_stability.cpp:
    # fft -> ifft of a ramp must reproduce the input closely for 2^n and
    # prime shapes alike
    from libmultiviewnative_jax.core.fft import irfft3, rfft3

    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    back = np.asarray(irfft3(rfft3(x), shape))
    assert rms(back, x) < 1e-3 * x.mean()
