#!/usr/bin/env python
"""Generate the frozen in-repo golden regression pack.

Replaces the reference's external Fiji-produced TIFF fixture pack
(/root/reference/tests/tiff_fixtures.hpp:18-27, default path
/dev/shm/libmultiview_data) with goldens produced by the trusted float64
numpy mirror (libmultiviewnative_jax.reference.numpy_ref) and frozen under
tests/data/ — the plan SURVEY.md §7 "golden data absence" prescribes.

Contract mirrored from the reference pack:
  * 6 views, per-view image/kernel1/kernel2/weights
  * images pre-padded by kernel half-widths (the PaddedReferenceData
    contract, tiff_fixtures.hpp:352-370)
  * psi_0 = flat average start; psi_i = state after iteration i
  * lambda = 0.006, minValue = 1e-4 (tiff_fixtures.hpp:449-450)

Deterministic (fixed seed); rerunning must reproduce the pack bit-exactly.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libmultiviewnative_jax.reference.numpy_ref import (
    np_convolve_spectrum,
    np_deconvolve,
    np_wrap_kernel,
)
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "data", "golden_mv6.npz",
)

NUM_VIEWS = 6
SHAPE = (40, 36, 32)  # deliberately anisotropic, non-cubic
KSHAPES = [(9, 9, 9), (9, 7, 7), (7, 9, 7), (7, 7, 9), (9, 9, 7), (8, 8, 8)]
LAMBDA = 0.006
MIN_VALUE = 1e-4
ITERATIONS = 5


def main():
    rng = np.random.default_rng(1308)
    # ground-truth specimen: smooth background + beads + a bar structure
    phantom = np.full(SHAPE, 2.0)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    phantom += 5.0 * np.exp(
        -((zz - 20) ** 2 + (yy - 18) ** 2 + (xx - 16) ** 2) / 200.0
    )
    for _ in range(10):
        z, y, x = (rng.integers(6, s - 6) for s in SHAPE)
        phantom[z, y, x] = 400.0
    phantom[18:22, 10:26, 14:18] += 80.0

    views, k1s, k2s, ws = [], [], [], []
    for v in range(NUM_VIEWS):
        # isotropic Gaussian per view; anisotropy comes from the per-view
        # KSHAPES supports (kernel extent differs per axis)
        k1 = gaussian_kernel(KSHAPES[v], sigma=1.0 + 0.3 * v).astype(np.float64)
        k2 = np.flip(k1).copy()
        k_hat = np.fft.rfftn(np_wrap_kernel(k1, SHAPE))
        view = np_convolve_spectrum(phantom, k_hat)
        noise = rng.poisson(np.clip(view, 0, None) * 4.0) / 4.0
        views.append(noise.astype(np.float32))
        k1s.append(k1.astype(np.float32))
        k2s.append(k2.astype(np.float32))
        ws.append(np.full(SHAPE, 1.0 / NUM_VIEWS, np.float32))

    psi0 = np.full(SHAPE, float(np.mean(views)), np.float32)
    snapshots = np_deconvolve(
        psi0, views, k1s, k2s, ws,
        num_iterations=ITERATIONS, lam=LAMBDA, min_value=MIN_VALUE,
        record_iterations=True,
    )

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    payload = {
        "phantom": phantom.astype(np.float32),
        "psi_0_start": psi0,
        "lambda": np.float64(LAMBDA),
        "min_value": np.float64(MIN_VALUE),
    }
    for v in range(NUM_VIEWS):
        payload[f"view_{v}"] = views[v]
        payload[f"kernel1_{v}"] = k1s[v]
        payload[f"kernel2_{v}"] = k2s[v]
        payload[f"weights_{v}"] = ws[v]
    for i, snap in enumerate(snapshots):
        payload[f"psi_{i}"] = snap.astype(np.float32)
    np.savez_compressed(OUT, **payload)
    print(f"wrote {OUT} ({os.path.getsize(OUT) >> 20} MiB)")


if __name__ == "__main__":
    main()
