"""Analytic convolution fixtures — numpy port of the reference's synthetic
test data (/root/reference/tests/test_fixtures.hpp:21-305).

``convolution_fixture_3d(K=3, N=8)`` builds:
  * ``image``          : ramp, image.flat[i] = i               (:128-135)
  * ``one_image``      : all ones
  * kernels (all K³ unless noted):
      - identity  : delta at center                            (:153-158)
      - horizontal: ramp 1..K along x through the center       (:147-151,
        deliberately asymmetric to catch axis flips — SURVEY appendix)
      - vertical  : ramp 1..K along y
      - depth     : ramp 1..K along z
      - all1      : all ones
      - asymm_cross: one-hot-sum cross with distinct arm values on an
        even/odd (K+1)×K×(K-1) support                         (:112-117)
  * expected folds of ``image`` by each kernel via the direct oracle.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from libmultiviewnative_jax.reference.oracle import direct_convolve


def kernels_3d(K: int = 3) -> Dict[str, np.ndarray]:
    c = K // 2
    ks: Dict[str, np.ndarray] = {}

    identity = np.zeros((K, K, K), np.float32)
    identity[c, c, c] = 1.0
    ks["identity"] = identity

    for name, axis in (("depth", 0), ("vertical", 1), ("horizontal", 2)):
        k = np.zeros((K, K, K), np.float32)
        idx = [c, c, c]
        for i in range(K):
            idx[axis] = i
            k[tuple(idx)] = float(i + 1)  # ramp 1..K, asymmetric on purpose
        ks[name] = k

    ks["all1"] = np.ones((K, K, K), np.float32)

    # even/odd mixed support (K+1, K, K-1) — exercises even-dim center
    # conventions (test_fixtures.hpp:112-117)
    a = np.zeros((K + 1, K, K - 1), np.float32)
    ca = tuple(s // 2 for s in a.shape)
    a[:, ca[1], ca[2]] = 1.0
    a[ca[0], :, ca[2]] += 2.0
    a[ca[0], ca[1], :] += 3.0
    ks["asymm_cross"] = a

    return ks


def convolution_fixture_3d(K: int = 3, N: int = 8):
    image = np.arange(N**3, dtype=np.float32).reshape(N, N, N)
    one = np.ones((N, N, N), np.float32)
    ks = kernels_3d(K)
    expected = {
        name: direct_convolve(image, k, boundary="zero") for name, k in ks.items()
    }
    return image, one, ks, expected
