"""Brute-force convolution oracle and norms (host, numpy).

Mirrors the reference test utilities:
  * ``convolve``            /root/reference/tests/test_algorithms.hpp:9-58
    (direct spatial-domain sum — the truth FFT convolution is checked against)
  * ``l2norm``              :87-100
  * ``l2norm_within_limits`` :102-135 (central-crop norm used by the
    deconvolution acceptance tests)
  * ``l1norm``              :137-151
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def direct_convolve(
    image: np.ndarray, kernel: np.ndarray, boundary: str = "zero"
) -> np.ndarray:
    """out[p] = sum_j kernel[j] * image[p + c - j], c = kernel_shape // 2.

    The center convention matches the wrap of
    /root/reference/inc/padd_utils.h:11-40 (valid for even dims too).
    ``boundary``: "zero" (reads outside the image are 0 — the oracle's
    behavior in test_algorithms.hpp) or "wrap" (circular, what the FFT
    path computes on unpadded data).
    """
    image = np.asarray(image, np.float64)
    kernel = np.asarray(kernel, np.float64)
    out = np.zeros_like(image)
    c = tuple(k // 2 for k in kernel.shape)
    for idx in np.ndindex(*kernel.shape):
        w = kernel[idx]
        if w == 0.0:
            continue
        shift = tuple(ci - i for ci, i in zip(c, idx))  # out[p] += w*img[p+shift]
        if boundary == "wrap":
            out += w * np.roll(image, [-s for s in shift], axis=range(image.ndim))
        elif boundary == "zero":
            src = [slice(None)] * image.ndim
            dst = [slice(None)] * image.ndim
            ok = True
            for d, s in enumerate(shift):
                n = image.shape[d]
                if abs(s) >= n:
                    ok = False
                    break
                if s >= 0:
                    src[d] = slice(s, n)
                    dst[d] = slice(0, n - s)
                else:
                    src[d] = slice(0, n + s)
                    dst[d] = slice(-s, n)
            if ok:
                out[tuple(dst)] += w * image[tuple(src)]
        else:
            raise ValueError(f"unknown boundary {boundary!r}")
    return out


def l2norm(a: np.ndarray, b: np.ndarray) -> float:
    """sum((a-b)^2) — REFERENCE-FAITHFUL: the reference's "l2norm" is the
    raw sum of squared differences, no sqrt and no 1/N
    (tests/test_algorithms.hpp:88-99).  Thresholds quoted from the
    reference acceptance tests (40 / 70 / 1e-2, test_cpu_deconvolve.cpp)
    apply to THIS quantity at the reference pack's volume."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sum((a - b) ** 2))


def l2norm_within_limits(
    a: np.ndarray, b: np.ndarray, lower_frac: float = 0.3, upper_frac: float = 0.7
) -> float:
    """Raw sum of squared diffs over the central crop [lower_frac,
    upper_frac) per axis — reference-faithful
    (tests/test_algorithms.hpp:102-135; used with 0.3/0.7 by
    test_cpu_deconvolve.cpp:87 and 0.25/0.75 by test_gpu_deconvolve.cpp:68)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    sl = tuple(
        slice(int(lower_frac * n), int(upper_frac * n)) for n in a.shape
    )
    return l2norm(a[sl], b[sl])


def rms(a: np.ndarray, b: np.ndarray) -> float:
    """sqrt(mean((a-b)^2)) — volume-independent error measure used by this
    repo's own tolerance gates (NOT the reference norm; see l2norm)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def rms_within_limits(
    a: np.ndarray, b: np.ndarray, lower_frac: float = 0.3, upper_frac: float = 0.7
) -> float:
    """RMS over the central crop [lower_frac, upper_frac) per axis."""
    a = np.asarray(a, np.float64)
    sl = tuple(
        slice(int(lower_frac * n), int(upper_frac * n)) for n in a.shape
    )
    return rms(np.asarray(a)[sl], np.asarray(b)[sl])


# Bars a full-size deconvolution is held to against the float64 mirror
# (reference/numpy_ref.py): relative L2 over the volume, and the central
# [0.3, 0.7) crop's rms over the mirror's peak magnitude.
MIRROR_REL_L2_MAX = 1e-3
MIRROR_CROP_RMS_MAX = 2e-4


def mirror_errors(got: np.ndarray, want: np.ndarray) -> dict:
    """``rel_l2`` = ||got - want|| / ||want||; ``crop_rms`` = central-crop
    rms(got - want) / max|want|; ``ok`` when both sit under the mirror
    bars."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rel_l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    crop = rms_within_limits(got, want) / float(np.abs(want).max())
    return {
        "rel_l2": rel_l2,
        "crop_rms": crop,
        "ok": bool(
            np.all(np.isfinite(got))
            and rel_l2 < MIRROR_REL_L2_MAX
            and crop < MIRROR_CROP_RMS_MAX
        ),
    }


def l1norm(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sum(np.abs(a - b)) / a.size)
