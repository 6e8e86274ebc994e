"""Dense-DFT engine tests: numerical parity with numpy rfftn and with the
XLA-FFT convolution engine, across the reference's shape families (2^n,
odd, primes, mixed — the envelope of the reference's
tests/test_fftw_numerical_stability.cpp:30-671)."""

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.core.convolve import fft_convolve3d
from libmultiviewnative_jax.core.dft import (
    dft3,
    dft_convolve_spectrum,
    idft3,
    kernel_spectrum_split,
    make_plan,
)
from libmultiviewnative_jax.deconv.rl import deconvolve_jit
from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.reference.oracle import rms
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


@pytest.mark.parametrize(
    "shape", [(8, 8, 8), (7, 9, 13), (16, 8, 4), (27, 25, 49), (13, 13, 13)]
)
def test_dft3_matches_numpy_rfftn(shape, rng):
    x = rng.normal(size=shape).astype(np.float32)
    re, im = dft3(jnp.asarray(x), make_plan(shape))
    got = np.asarray(re) + 1j * np.asarray(im)
    want = np.fft.rfftn(x.astype(np.float64))
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 1e-5


@pytest.mark.parametrize("shape", [(8, 8, 8), (7, 9, 13), (32, 16, 8)])
def test_dft_roundtrip(shape, rng):
    x = rng.normal(size=shape).astype(np.float32)
    plan = make_plan(shape)
    re, im = dft3(jnp.asarray(x), plan)
    back = np.asarray(idft3(re, im, plan))
    assert rms(back, x) < 1e-5


def test_dft_convolve_matches_fft_engine(rng):
    x = rng.normal(size=(12, 12, 12)).astype(np.float32)
    k = rng.normal(size=(5, 4, 3)).astype(np.float32)
    kre, kim = kernel_spectrum_split(k, (12, 12, 12))
    got = np.asarray(dft_convolve_spectrum(jnp.asarray(x), kre, kim))
    want = np.asarray(fft_convolve3d(x, k, mode="circular"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dft_convolve_batched(rng):
    x = rng.normal(size=(3, 12, 12, 12)).astype(np.float32)
    k = gaussian_kernel((5, 5, 5), 1.0)
    kre, kim = kernel_spectrum_split(jnp.asarray(k), (12, 12, 12))
    got = np.asarray(dft_convolve_spectrum(jnp.asarray(x), kre, kim))
    for i in range(3):
        single = np.asarray(fft_convolve3d(x[i], k, mode="circular"))
        np.testing.assert_allclose(got[i], single, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "shape", [(4, 8, 288), (272, 4, 8), (4, 320, 8), (6, 300, 8)]
)
def test_mixed_radix_full_mode_matches_numpy(shape, rng):
    # axes > 256 trigger the FullDFTPlan (split Cooley-Tukey stage)
    from libmultiviewnative_jax.core.dft import FullDFTPlan

    x = rng.normal(size=shape).astype(np.float32)
    plan = make_plan(shape)
    assert isinstance(plan, FullDFTPlan)
    re, im = dft3(jnp.asarray(x), plan)
    got = np.asarray(re) + 1j * np.asarray(im)
    want = np.fft.fftn(x.astype(np.float64))
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) < 1e-5
    back = np.asarray(idft3(re, im, plan))
    assert np.abs(back - x).max() < 1e-4


def test_mixed_radix_convolve_matches_fft_engine(rng):
    x = rng.normal(size=(8, 8, 280)).astype(np.float32)
    k = rng.normal(size=(3, 3, 5)).astype(np.float32)
    kre, kim = kernel_spectrum_split(jnp.asarray(k), (8, 8, 280))
    got = np.asarray(dft_convolve_spectrum(jnp.asarray(x), kre, kim))
    want = np.asarray(fft_convolve3d(x, k, mode="circular"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pick_split_prefers_mxu_m():
    from libmultiviewnative_jax.core.dft import _pick_split

    assert _pick_split(512) == (4, 128)
    assert _pick_split(384) == (3, 128)
    assert _pick_split(521) is None  # prime beyond the table -> dense


def test_deconvolve_dft_algorithm_matches_fft(rng):
    shape = (16, 16, 16)
    V = 2
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(V)])
    data = MultiViewData(
        views=jnp.asarray(views),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
        weights=jnp.full((V,) + shape, 1.0 / V, jnp.float32),
    )
    psi0 = jnp.full(shape, float(np.mean(views)), jnp.float32)
    a = np.asarray(deconvolve_jit(psi0.copy(), data, 3, algorithm="fft"))
    b = np.asarray(deconvolve_jit(psi0.copy(), data, 3, algorithm="dft"))
    assert rms(a, b) < 1e-3


def test_deconvolve_direct_algorithm_matches_fft(rng):
    shape = (16, 16, 16)
    V = 2
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(V)])
    data = MultiViewData(
        views=jnp.asarray(views),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
        weights=jnp.full((V,) + shape, 1.0 / V, jnp.float32),
    )
    psi0 = jnp.full(shape, float(np.mean(views)), jnp.float32)
    a = np.asarray(deconvolve_jit(psi0.copy(), data, 2, algorithm="fft"))
    b = np.asarray(deconvolve_jit(psi0.copy(), data, 2, algorithm="direct"))
    assert rms(a, b) < 1e-3


@pytest.mark.parametrize("shape", [(8, 160, 12), (160, 8, 12), (12, 144, 16)])
def test_compact_convolve_with_split_yz_stage(shape, rng):
    # y/z axes > 128 engage the in-compact Cooley-Tukey stage; result must
    # match the plain FFT engine
    x = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(5, 5, 5)).astype(np.float32)
    kre, kim = kernel_spectrum_split(jnp.asarray(k), shape)
    got = np.asarray(dft_convolve_spectrum(jnp.asarray(x), kre, kim))
    want = np.asarray(fft_convolve3d(x, k, mode="circular"))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
