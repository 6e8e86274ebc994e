#!/usr/bin/env python
"""Synthesize a plugin-convention EXTERNAL TIFF fixture pack.

The reference's tier-4 acceptance tests consume a pack of real Fiji-plugin
outputs from LMVN_TEST_IMAGE_PATH (default /dev/shm/libmultiview_data):
``input_view_i / kernel1_view_i / kernel2_view_i / weights_view_i .tif``
plus per-iteration ``psi_i.tif`` goldens and ``.tif.shape`` sidecars
(/root/reference/tests/tiff_fixtures.hpp:18-27, share/extract_shape.sh).
That plugin is not available in this environment, so this script generates
a pack in the SAME on-disk convention from the trusted float64 numpy
mirror — proving the loader/layout/file contract end-to-end (the in-repo
NPZ golden pack proves only the in-memory math).

Faithfulness choices mirroring the plugin pack:
  * 6 views, heterogeneous PSF supports.
  * kernel2 is a COMPOUND kernel (utils/psf.py ``efficient_bayesian`` —
    the plugin's default "conditional pdf of all views for view v",
    tiff_fixtures.hpp:21-24), not a plain adjoint: the pack therefore
    also anchors the compound-kernel family against float64 goldens.
  * images carry a quiet border wider than every kernel half-width —
    the PaddedReferenceData pre-padding contract (tiff_fixtures.hpp:
    352-370) expressed directly in the data.
  * psi_0.tif = flat average initial guess; running N iterations from it
    must reproduce psi_{N-1}.tif (the convention encoded by
    test_cpu_deconvolve.cpp:66-96: 2 iterations -> psi_1, 5 -> psi_4).
  * lambda = 0.006, minValue = 1e-4 (tiff_fixtures.hpp:449-450).

Deterministic (fixed seed); rerunning reproduces the pack bit-exactly.
Usage: python scripts/generate_external_pack.py [out_dir]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libmultiviewnative_jax.io.stacks import write_shape_sidecar, write_tiff_stack
from libmultiviewnative_jax.reference.numpy_ref import (
    np_convolve_spectrum,
    np_deconvolve,
    np_wrap_kernel,
)
from libmultiviewnative_jax.utils.psf import compound_kernels
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

NUM_VIEWS = 6
SHAPE = (44, 40, 36)  # anisotropic; >= 7-plane quiet border on every face
KSHAPES = [(9, 9, 9), (9, 7, 7), (7, 9, 7), (7, 7, 9), (9, 9, 7), (8, 8, 8)]
LAMBDA = 0.006
MIN_VALUE = 1e-4
ITERATIONS = 5


def build_pack():
    rng = np.random.default_rng(2015)  # GTC vintage
    # specimen confined to the interior: border > max kernel half-width (4),
    # so the circular wrap only ever touches background — the same
    # guarantee the plugin's pre-padding provides.
    phantom = np.full(SHAPE, 2.0)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    phantom += 6.0 * np.exp(
        -((zz - 22) ** 2 + (yy - 20) ** 2 + (xx - 18) ** 2) / 180.0
    )
    for _ in range(12):
        z, y, x = (int(rng.integers(8, s - 8)) for s in SHAPE)
        phantom[z, y, x] = 350.0
    phantom[20:24, 12:28, 16:20] += 60.0

    k1s = [
        gaussian_kernel(KSHAPES[v], sigma=1.0 + 0.25 * v).astype(np.float64)
        for v in range(NUM_VIEWS)
    ]
    # plugin-style compound kernel2 on the common max support
    k2s = [k.astype(np.float64) for k in compound_kernels(k1s, "efficient_bayesian")]

    views, ws = [], []
    for v in range(NUM_VIEWS):
        k_hat = np.fft.rfftn(np_wrap_kernel(k1s[v], SHAPE))
        blurred = np_convolve_spectrum(phantom, k_hat)
        noisy = rng.poisson(np.clip(blurred, 0, None) * 5.0) / 5.0
        views.append(noisy.astype(np.float32))
        ws.append(np.full(SHAPE, 1.0 / NUM_VIEWS, np.float32))

    psi0 = np.full(SHAPE, float(np.mean(views)), np.float32)
    snapshots = np_deconvolve(
        psi0,
        views,
        [k.astype(np.float32) for k in k1s],
        [k.astype(np.float32) for k in k2s],
        ws,
        num_iterations=ITERATIONS,
        lam=LAMBDA,
        min_value=MIN_VALUE,
        record_iterations=True,
    )
    return views, k1s, k2s, ws, psi0, snapshots


def write_pack(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    views, k1s, k2s, ws, psi0, snapshots = build_pack()

    def emit(name, stack):
        path = os.path.join(out_dir, name)
        write_tiff_stack(path, stack)
        write_shape_sidecar(path + ".shape", np.asarray(stack).shape)

    for v in range(NUM_VIEWS):
        emit(f"input_view_{v}.tif", views[v])
        emit(f"kernel1_view_{v}.tif", k1s[v])
        emit(f"kernel2_view_{v}.tif", k2s[v])
        emit(f"weights_view_{v}.tif", ws[v])
    # psi_0 = the initial guess; psi_i (i>=1) = state after i+1 iterations
    # (the reference pack's off-by-one: 2 iterations -> psi_1, 5 -> psi_4)
    emit("psi_0.tif", psi0)
    for i in range(1, ITERATIONS):
        emit(f"psi_{i}.tif", snapshots[i].astype(np.float32))
    print(f"wrote plugin-convention pack ({NUM_VIEWS} views, "
          f"{ITERATIONS - 1} psi goldens) to {out_dir}")


if __name__ == "__main__":
    write_pack(sys.argv[1] if len(sys.argv) > 1 else "/dev/shm/libmultiview_data")
