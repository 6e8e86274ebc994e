"""THE acceptance test — the analog of
/root/reference/tests/test_cpu_deconvolve.cpp:53-142.

Runs the JAX implementation from the frozen golden pack's psi_0 and holds
it to the reference's tolerance STRUCTURE (global raw-sum l2norm + central
30-70% crop, test_cpu_deconvolve.cpp:75-102) against the float64 goldens.

The reference's numeric thresholds (40 / 70 / 1e-2) are raw sums of
squared differences at ITS external TIFF pack's volume and cannot be
transferred to this pack (40x36x32).  Gates here are derived
independently: measured float32-vs-float64 deviation on this pack is
l2norm <= 1.5e-6 (raw sum) and rms <= 7.1e-6 after 5 iterations (both
engines, f32-faithful precision); gates sit ~3 orders above that — loose
enough for reduced-precision matmul modes, tight enough that any algorithmic deviation (rms O(1) on psi
values of mean ~3.8) fails by orders of magnitude.

Also: determinism — two identical runs are bitwise equal (:134-137
analog, the serial-vs-parallel bitwise check recast for a deterministic
accelerator program).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.deconv.rl import deconvolve_jit
from libmultiviewnative_jax.deconv.workspace import MultiViewData, View
from libmultiviewnative_jax.reference.oracle import (
    l2norm,
    l2norm_within_limits,
    rms,
    rms_within_limits,
)

PACK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "golden_mv6.npz")

pytestmark = pytest.mark.skipif(
    not os.path.exists(PACK), reason="golden pack missing (scripts/generate_goldens.py)"
)


@pytest.fixture(scope="module")
def pack():
    with np.load(PACK) as z:
        return {k: z[k] for k in z.files}


def _data(pack):
    # per-view kernel shapes differ (the pack mirrors the reference's
    # heterogeneous-PSF fixture); from_views center-pads to the max shape
    return MultiViewData.from_views(
        [
            View(
                image=pack[f"view_{v}"],
                kernel1=pack[f"kernel1_{v}"],
                kernel2=pack[f"kernel2_{v}"],
                weights=pack[f"weights_{v}"],
            )
            for v in range(6)
        ]
    )


def _run(pack, iters, algorithm="fft"):
    data = _data(pack)
    psi0 = jnp.asarray(pack["psi_0_start"])
    return np.asarray(
        deconvolve_jit(
            psi0,
            data,
            num_iterations=iters,
            lam=float(pack["lambda"]),
            min_value=float(pack["min_value"]),
            algorithm=algorithm,
        )
    )


def test_two_iterations_vs_golden(pack):
    out = _run(pack, 2)
    golden = pack["psi_1"]
    assert l2norm(out, golden) < 1e-3  # measured f32: 5.9e-7
    assert l2norm_within_limits(out, golden, 0.3, 0.7) < 1e-3
    assert rms_within_limits(out, golden, 0.3, 0.7) < 5e-3


def test_five_iterations_vs_golden(pack):
    out = _run(pack, 5)
    golden = pack["psi_4"]
    assert l2norm(out, golden) < 2e-3  # measured f32: 1.4e-6
    assert l2norm_within_limits(out, golden, 0.3, 0.7) < 2e-3
    assert rms_within_limits(out, golden, 0.3, 0.7) < 5e-3


def test_dft_engine_vs_golden(pack):
    out = _run(pack, 2, algorithm="dft")
    golden = pack["psi_1"]
    assert l2norm(out, golden) < 1e-3  # measured f32: 6.3e-7
    assert rms_within_limits(out, golden, 0.3, 0.7) < 5e-3


def test_deterministic_repeat(pack):
    a = _run(pack, 2)
    b = _run(pack, 2)
    np.testing.assert_array_equal(a, b)


def test_monotone_progress_toward_phantom(pack):
    # deconvolution sanity: successive golden psi_i approach the phantom
    phantom = pack["phantom"]
    errs = [l2norm(pack[f"psi_{i}"], phantom) for i in range(5)]
    assert errs[-1] < errs[0]
