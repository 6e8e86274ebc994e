"""Tests for the flat C-ABI-parity API (libmultiviewnative_jax.api).

Structure mirrors the reference's API-level tests
(test_cpu_symm_convolve.cpp / test_gpu_deconvolve_single_stepped.cu): the
flat entry points must agree with the library-internal path and the float64
reference."""

import numpy as np
import pytest

from libmultiviewnative_jax import api
from libmultiviewnative_jax.reference.numpy_ref import (
    np_deconvolve,
    np_rl_view_step,
    np_wrap_kernel,
)
from libmultiviewnative_jax.reference.oracle import rms
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


def _views(num=2, shape=(12, 12, 12), seed=9):
    rng = np.random.default_rng(seed)
    imgs = [rng.gamma(2.0, 20.0, shape).astype(np.float32) for _ in range(num)]
    k1s = [gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(num)]
    k2s = [np.flip(k).copy() for k in k1s]
    ws = [np.full(shape, 1.0 / num, np.float32) for _ in range(num)]
    return imgs, k1s, k2s, ws


def test_deconvolve_flat_matches_reference():
    imgs, k1s, k2s, ws = _views()
    psi0 = np.full(imgs[0].shape, float(np.mean(imgs)), np.float32)
    out = api.deconvolve_flat(psi0, imgs, k1s, k2s, ws, num_iterations=2, lambda_=0.0)
    gold = np_deconvolve(psi0, imgs, k1s, k2s, ws, num_iterations=2, lam=0.0)
    assert rms(out, gold) < 1e-2


def test_convolution3d_identity():
    rng = np.random.default_rng(2)
    img = rng.normal(size=(8, 8, 8)).astype(np.float32)
    k = np.zeros((3, 3, 3), np.float32)
    k[1, 1, 1] = 1.0
    out = api.convolution3d(img, k)
    np.testing.assert_allclose(out, img, rtol=1e-4, atol=1e-4)


def test_quotient_and_final_values_flat():
    rng = np.random.default_rng(3)
    a = rng.gamma(2.0, 5.0, (4, 4, 4)).astype(np.float32)
    b = rng.gamma(2.0, 5.0, (4, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(api.quotient_flat(a, b), a / b, rtol=1e-5)
    w = np.full((4, 4, 4), 0.5, np.float32)
    out = api.final_values_flat(a, b, w, lambda_=0.0)
    assert out.shape == a.shape and np.all(np.isfinite(out))
    out_t = api.final_values_flat(a, b, w, lambda_=0.006)
    assert not np.allclose(out, out_t)  # Tikhonov branch engaged


def test_iterate_fft_plain_matches_reference_step():
    imgs, k1s, k2s, ws = _views(num=1)
    psi0 = np.full(imgs[0].shape, float(np.mean(imgs)), np.float32)
    out = api.iterate_fft_plain(psi0, imgs[0], k1s[0], k2s[0], ws[0])
    shape = psi0.shape
    gold = np_rl_view_step(
        psi0.astype(np.float64),
        imgs[0].astype(np.float64),
        np.fft.rfftn(np_wrap_kernel(k1s[0], shape)),
        np.fft.rfftn(np_wrap_kernel(k2s[0], shape)),
        ws[0].astype(np.float64),
        0.0,
        1e-4,
    )
    assert rms(out, gold) < 1e-2


def test_iterate_fft_tikhonov_runs():
    imgs, k1s, k2s, ws = _views(num=1)
    psi0 = np.full(imgs[0].shape, 10.0, np.float32)
    out = api.iterate_fft_tikhonov(psi0, imgs[0], k1s[0], k2s[0], ws[0], lambda_=0.006)
    assert np.all(np.isfinite(out))


def test_native_entry_iterate_output_write_only():
    """Bridge-level iterate_fft_* must start psi from the INPUT buffer; the
    output buffer is write-only (src/multiviewnative.cu:463-465) — garbage
    in the caller's out-buffer must not leak into the result."""
    from libmultiviewnative_jax import native_entry

    rng = np.random.default_rng(7)
    view = rng.gamma(2.0, 20.0, (8, 8, 8)).astype(np.float32)
    kernel = gaussian_kernel((3, 3, 3), 1.0)

    def run(fill):
        out = np.full(view.shape, fill, np.float32)
        native_entry.iterate_fft_plain(
            view.ctypes.data, kernel.ctypes.data, out.ctypes.data,
            view.shape, kernel.shape,
        )
        return out

    a = run(np.nan)  # uninitialized-style garbage
    b = run(123.0)
    np.testing.assert_array_equal(a, b)
    assert np.all(np.isfinite(a))
    # and it equals the documented psi0 = view semantics
    want = api.iterate_fft_plain(
        view.copy(), view, kernel, np.flip(kernel).copy(), np.ones_like(view)
    )
    np.testing.assert_array_equal(a, want)

    out_t = np.full(view.shape, np.nan, np.float32)
    native_entry.iterate_fft_tikhonov(
        view.ctypes.data, kernel.ctypes.data, out_t.ctypes.data,
        view.shape, kernel.shape, 1e-4, 0.006,
    )
    assert np.all(np.isfinite(out_t))


def test_device_queries():
    assert api.get_num_devices() >= 1
    assert isinstance(api.get_device_name(), str)
    info = api.get_device_info()
    assert info["platform"] in ("cpu", "gpu")
    assert api.select_device() == info["id"]


def test_deconvolve_flat_heterogeneous_kernel_shapes():
    imgs, k1s, k2s, ws = _views(num=2)
    k1s[1] = gaussian_kernel((3, 3, 3), 0.8)  # smaller than view 0's 5^3
    psi0 = np.full(imgs[0].shape, float(np.mean(imgs)), np.float32)
    out = api.deconvolve_flat(psi0, imgs, k1s, k2s, ws, num_iterations=1)
    assert out.shape == psi0.shape and np.all(np.isfinite(out))
