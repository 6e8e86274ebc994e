"""FFT/DFT numerical-stability envelope — the tolerance contract.

Port of the reference's stability suite
(reference tests/test_fftw_numerical_stability.cpp:30-671): forward
-> inverse roundtrip error across shape families (primes, 2^n/3^n/5^n/7^n,
mixed radix) up to 512/axis, for BOTH engines (XLA FFT op and the dense
einsum DFT, including the FullDFTPlan mixed-radix split that engages above
256/axis).  Long axes ride thin companion dims so the ladder stays fast.

Measured envelope (CPU pocketfft and the H100, f32, random normal
volumes, docs/STABILITY.md): relative L2 roundtrip error < 4e-7.
Gate: 5e-6 — an order of headroom for platform twiddle differences, yet
3+ orders below any real defect (an indexing/twiddle bug costs >= 1e-3).

Convolve-vs-oracle closes the loop at representative odd/prime shapes:
the full circular convolution against the float64 brute-force oracle.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.core import dft
from libmultiviewnative_jax.core.convolve import fft_convolve3d
from libmultiviewnative_jax.core.dft import dft_convolve_spectrum, kernel_spectrum_split
from libmultiviewnative_jax.core.fft import irfft3, rfft3
from libmultiviewnative_jax.reference.oracle import direct_convolve
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

RTOL = 5e-6

FAMILIES = [
    ("pow2", 8), ("pow2", 64), ("pow2", 256), ("pow2", 512),
    ("pow3", 27), ("pow3", 243),
    ("pow5", 25), ("pow5", 125),
    ("pow7", 49), ("pow7", 343),
    ("prime", 13), ("prime", 127), ("prime", 251), ("prime", 509),
    ("mixed", 96), ("mixed", 160), ("mixed", 320), ("mixed", 384),
]


def _rel_err(back: np.ndarray, ref64: np.ndarray) -> float:
    return float(
        np.linalg.norm(back - ref64) / np.linalg.norm(ref64)
    )


def _volume(shape, seed=0):
    return (
        np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    )


@pytest.mark.parametrize("family,n", FAMILIES, ids=lambda v: str(v))
def test_fft_engine_roundtrip(family, n):
    shape = (n, 4, 8)
    x = _volume(shape)
    back = np.asarray(irfft3(rfft3(jnp.asarray(x)), shape))
    assert _rel_err(back, x.astype(np.float64)) < RTOL


@pytest.mark.parametrize("family,n", FAMILIES, ids=lambda v: str(v))
def test_dft_engine_roundtrip(family, n):
    shape = (n, 4, 8)
    x = _volume(shape)
    plan = dft.make_plan(shape)
    re, im = dft.dft3(jnp.asarray(x), plan)
    back = np.asarray(dft.idft3(re, im, plan))
    assert _rel_err(back, x.astype(np.float64)) < RTOL


@pytest.mark.parametrize(
    "shape",
    [(512, 4, 8), (509, 4, 8), (384, 4, 8)],
    ids=str,
)
def test_dft_long_axis_uses_full_plan(shape):
    """The >256/axis cases must actually exercise the FullDFTPlan split
    machinery (guard against the ladder silently testing the compact
    path)."""
    assert isinstance(dft.make_plan(shape), dft.FullDFTPlan)


@pytest.mark.parametrize("shape", [(64, 64, 64), (40, 36, 32), (33, 17, 29)], ids=str)
def test_cube_roundtrip_both_engines(shape):
    x = _volume(shape, seed=3)
    ref = x.astype(np.float64)
    back_fft = np.asarray(irfft3(rfft3(jnp.asarray(x)), shape))
    assert _rel_err(back_fft, ref) < RTOL
    plan = dft.make_plan(shape)
    re, im = dft.dft3(jnp.asarray(x), plan)
    back_dft = np.asarray(dft.idft3(re, im, plan))
    assert _rel_err(back_dft, ref) < RTOL


@pytest.mark.parametrize("n", [127, 251, 320], ids=str)
def test_convolve_vs_oracle_long_axis(n):
    """Full circular convolution against the float64 brute-force oracle at
    prime/mixed long-axis shapes — the end-to-end accuracy contract the
    roundtrip alone can't give."""
    shape = (n, 6, 10)
    x = _volume(shape, seed=n)
    k = gaussian_kernel((5, 3, 3), 1.0)
    want = direct_convolve(x, k, boundary="wrap")
    got_fft = np.asarray(
        fft_convolve3d(jnp.asarray(x), jnp.asarray(k), mode="circular")
    )
    assert _rel_err(got_fft, want) < RTOL
    k_re, k_im = kernel_spectrum_split(jnp.asarray(k), shape)
    got_dft = np.asarray(dft_convolve_spectrum(jnp.asarray(x), k_re, k_im))
    assert _rel_err(got_dft, want) < RTOL
