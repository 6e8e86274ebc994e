"""External golden TIFF pack support — the reference's tier-4 convention.

The reference loads `input_view_i / kernel1_view_i / kernel2_view_i /
weights_view_i .tif` plus per-iteration `psi_i.tif` goldens from
LMVN_TEST_IMAGE_PATH (default /dev/shm/libmultiview_data —
/root/reference/tests/tiff_fixtures.hpp:18-27, CMakeLists.txt:25) and
SKIPS the tests when absent (tests/CMakeLists.txt:42-53).  Same contract
here — with one improvement: when no pack is present, a plugin-convention
pack is SYNTHESIZED from the trusted float64 mirror
(scripts/generate_external_pack.py), so the loader/layout/file contract
is exercised end-to-end on every run instead of never.  Point
LMVN_TEST_IMAGE_PATH at a pack produced by the real Fiji plugin to hold
this library to plugin outputs instead.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_DATA = os.environ.get("LMVN_TEST_IMAGE_PATH", "/dev/shm/libmultiview_data")


def _is_pack(d):
    return os.path.exists(os.path.join(d, "input_view_0.tif")) and os.path.exists(
        os.path.join(d, "psi_1.tif")
    )


@pytest.fixture(scope="session")
def pack_dir(tmp_path_factory):
    """A directory holding a plugin-convention pack: the external one if
    provided, else one synthesized by the float64 mirror."""
    if _is_pack(ENV_DATA):
        return ENV_DATA
    out = str(tmp_path_factory.mktemp("lmvn_extpack"))
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "generate_external_pack.py"), out],
        check=True,
        cwd=REPO,
        timeout=600,
    )
    assert _is_pack(out)
    return out


def _load_views(data):
    from libmultiviewnative_jax.deconv.workspace import View
    from libmultiviewnative_jax.io.stacks import read_tiff_stack

    views = []
    v = 0
    while os.path.exists(os.path.join(data, f"input_view_{v}.tif")):
        views.append(
            View(
                image=read_tiff_stack(os.path.join(data, f"input_view_{v}.tif")),
                kernel1=read_tiff_stack(os.path.join(data, f"kernel1_view_{v}.tif")),
                kernel2=read_tiff_stack(os.path.join(data, f"kernel2_view_{v}.tif")),
                weights=read_tiff_stack(os.path.join(data, f"weights_view_{v}.tif")),
            )
        )
        v += 1
    return views


def _run(data, iters, algorithm="fft"):
    import jax.numpy as jnp

    from libmultiviewnative_jax.deconv.rl import deconvolve_jit
    from libmultiviewnative_jax.deconv.workspace import MultiViewData
    from libmultiviewnative_jax.io.stacks import read_tiff_stack

    views = _load_views(data)
    assert views, "pack present but no views parsed"
    mvd = MultiViewData.from_views(views)
    psi0 = read_tiff_stack(os.path.join(data, "psi_0.tif"))
    return np.asarray(
        deconvolve_jit(
            jnp.asarray(psi0), mvd, num_iterations=iters, lam=0.006, min_value=1e-4
        )
    )


def test_sidecars_match_stacks(pack_dir):
    """Every .tif carries a .tif.shape sidecar agreeing with its pages —
    the share/extract_shape.sh convention, read through the public API."""
    from libmultiviewnative_jax.io.stacks import read_shape_sidecar, read_tiff_stack

    tifs = sorted(f for f in os.listdir(pack_dir) if f.endswith(".tif"))
    assert tifs
    for f in tifs:
        stack = read_tiff_stack(os.path.join(pack_dir, f))
        sidecar = os.path.join(pack_dir, f + ".shape")
        if os.path.exists(sidecar):  # real plugin packs may omit sidecars
            assert read_shape_sidecar(sidecar) == stack.shape, f


def test_external_goldens(pack_dir):
    """The acceptance thresholds of test_cpu_deconvolve.cpp:53-105 against
    the pack (lambda=0.006, minValue=1e-4 per tiff_fixtures.hpp:449-450):
    2 iterations from psi_0.tif reproduce psi_1.tif."""
    from libmultiviewnative_jax.io.stacks import read_tiff_stack
    from libmultiviewnative_jax.reference.oracle import l2norm, l2norm_within_limits

    out = _run(pack_dir, 2)
    golden = read_tiff_stack(os.path.join(pack_dir, "psi_1.tif"))
    assert l2norm(out, golden) < 40.0
    assert l2norm_within_limits(out, golden, 0.3, 0.7) < 1e-2


def test_external_goldens_five_iterations(pack_dir):
    """The second reference gate: 5 iterations reproduce psi_4.tif
    (test_cpu_deconvolve.cpp:89-102, global < 70 / central < 1e-2)."""
    from libmultiviewnative_jax.io.stacks import read_tiff_stack
    from libmultiviewnative_jax.reference.oracle import l2norm, l2norm_within_limits

    psi4 = os.path.join(pack_dir, "psi_4.tif")
    if not os.path.exists(psi4):
        pytest.skip("pack has no psi_4.tif")
    out = _run(pack_dir, 5)
    golden = read_tiff_stack(psi4)
    assert l2norm(out, golden) < 70.0
    assert l2norm_within_limits(out, golden, 0.3, 0.7) < 1e-2
