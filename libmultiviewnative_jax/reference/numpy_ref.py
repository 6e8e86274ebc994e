"""Float64 numpy mirror of the RL pipeline — golden-data generator.

Implements exactly the math of the reference CPU driver
(reference src/multiviewnative.cpp:101-240 and inc/cpu_kernels.h:16-126)
in double precision with host FFTs (scipy's pocketfft on all cores, numpy's
where scipy is absent), independent of JAX.  Used to (a) regenerate golden psi_i data in place
of the external Fiji TIFF pack and (b) cross-check the JAX implementation's
numerics within the tolerance envelope of
/root/reference/tests/test_cpu_deconvolve.cpp:53-105.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

try:
    import scipy.fft as _fft

    _FFT_KW = {"workers": -1}
except ImportError:  # pragma: no cover - scipy is a test dependency
    _fft = np.fft
    _FFT_KW = {}


def np_rfftn(x: np.ndarray) -> np.ndarray:
    """Float64 real forward transform over every axis."""
    return _fft.rfftn(np.asarray(x, np.float64), **_FFT_KW)


def np_irfftn(x_hat: np.ndarray, shape) -> np.ndarray:
    return _fft.irfftn(x_hat, s=tuple(shape), **_FFT_KW)


def np_wrap_kernel(kernel: np.ndarray, extents: Sequence[int]) -> np.ndarray:
    """Embed kernel with its center voxel at the origin, wrapping negatives.

    Mirror of /root/reference/inc/padd_utils.h:11-40.
    """
    extents = tuple(int(e) for e in extents)
    buf = np.zeros(extents, np.float64)
    k = np.asarray(kernel, np.float64)
    buf[tuple(slice(0, s) for s in k.shape)] = k
    center = tuple(s // 2 for s in k.shape)
    return np.roll(buf, [-c for c in center], axis=range(k.ndim))


def np_convolve_spectrum(x: np.ndarray, k_hat: np.ndarray) -> np.ndarray:
    """Circular convolution via precomputed rfftn kernel spectrum."""
    return np_irfftn(np_rfftn(x) * k_hat, x.shape)


def np_final_values(
    psi: np.ndarray,
    integral: np.ndarray,
    weights: np.ndarray,
    min_value: float,
) -> np.ndarray:
    """Mirror of ser::final_values (inc/cpu_kernels.h:29-54)."""
    value = psi * integral
    value = np.where(value > 0.0, value, min_value)
    nxt = np.where(
        np.isnan(value) | np.isinf(value), min_value, np.maximum(value, min_value)
    )
    return weights * (nxt - psi) + psi


def np_regularized_final_values(
    psi: np.ndarray,
    integral: np.ndarray,
    weights: np.ndarray,
    lam: float,
    min_value: float,
) -> np.ndarray:
    """Mirror of ser::regularized_final_values (inc/cpu_kernels.h:59-90)."""
    value = psi * integral
    with np.errstate(invalid="ignore"):
        tik = (np.sqrt(1.0 + 2.0 * lam * value) - 1.0) / lam
    value = np.where(value > 0.0, tik, min_value)
    nxt = np.where(
        np.isnan(value) | np.isinf(value), min_value, np.maximum(value, min_value)
    )
    return weights * (nxt - psi) + psi


def np_rl_view_step(
    psi: np.ndarray,
    view: np.ndarray,
    k1_hat: np.ndarray,
    k2_hat: np.ndarray,
    weights: np.ndarray,
    lam: float,
    min_value: float,
) -> np.ndarray:
    """One view's update — mirror of src/multiviewnative.cpp:191-228."""
    integral = np_convolve_spectrum(psi, k1_hat)
    with np.errstate(divide="ignore", invalid="ignore"):
        integral = view * (1.0 / integral)
    integral = np_convolve_spectrum(integral, k2_hat)
    if lam > 0.0:
        return np_regularized_final_values(psi, integral, weights, lam, min_value)
    return np_final_values(psi, integral, weights, min_value)


def np_deconvolve(
    psi: np.ndarray,
    views: Sequence[np.ndarray],
    kernels1: Sequence[np.ndarray],
    kernels2: Sequence[np.ndarray],
    weights: Sequence[np.ndarray],
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    record_iterations: bool = False,
):
    """Sequential multi-view RL, float64.  Returns final psi, or the list of
    per-iteration psi snapshots (the psi_i golden convention,
    /root/reference/tests/tiff_fixtures.hpp:453-462) when
    ``record_iterations``.
    """
    psi = np.asarray(psi, np.float64).copy()
    shape = psi.shape
    k1_hat = [np_rfftn(np_wrap_kernel(k, shape)) for k in kernels1]
    k2_hat = [np_rfftn(np_wrap_kernel(k, shape)) for k in kernels2]
    snapshots: List[np.ndarray] = []
    for _ in range(num_iterations):
        for v in range(len(views)):
            psi = np_rl_view_step(
                psi,
                np.asarray(views[v], np.float64),
                k1_hat[v],
                k2_hat[v],
                np.asarray(weights[v], np.float64),
                lam,
                min_value,
            )
        if record_iterations:
            snapshots.append(psi.copy())
    return snapshots if record_iterations else psi
