"""Shard-wise loader tests (parallel.loader) on the virtual 8-device mesh.

Covers the multi-host loading convention: every process assembles the
global arrays by reading ONLY per-shard slabs (make_array_from_callback),
and the result is bit-identical to a whole-volume device_put layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.parallel.loader import (
    as_reader,
    load_sharded_workspace,
    make_sharded_stack,
)
from libmultiviewnative_jax.parallel.sharded import (
    deconvolve_sharded,
    make_mesh,
    shard_workspace,
)
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)

V, SHAPE = 4, (16, 8, 8)


def _problem(seed=7):
    rng = np.random.default_rng(seed)
    views = [rng.gamma(2.0, 10.0, SHAPE).astype(np.float32) for _ in range(V)]
    k1 = [gaussian_kernel((3, 3, 3), 0.8 + 0.2 * v) for v in range(V)]
    k2 = [np.flip(k).copy() for k in k1]
    ws = [np.full(SHAPE, 1.0 / V, np.float32) for _ in range(V)]
    return views, k1, k2, ws


def _recording(readers):
    calls = []

    def wrap(r, v):
        def inner(zs):
            calls.append((v, zs.indices(SHAPE[0])))
            return r(zs)

        return inner

    return [wrap(r, v) for v, r in enumerate(readers)], calls


def test_loaded_equals_device_put():
    views, k1, k2, ws = _problem()
    mesh = make_mesh(view_parallel=4, z_parallel=2)
    psi0 = np.full(SHAPE, float(np.mean(np.stack(views))), np.float32)

    psi_l, data_l = load_sharded_workspace(
        mesh, views, k1, k2, ws, SHAPE
    )
    psi_d, data_d = shard_workspace(
        MultiViewData(
            views=jnp.asarray(np.stack(views)),
            kernel1=jnp.asarray(np.stack(k1)),
            kernel2=jnp.asarray(np.stack(k2)),
            weights=jnp.asarray(np.stack(ws)),
        ),
        jnp.asarray(psi0),
        mesh,
    )
    np.testing.assert_allclose(np.asarray(psi_l), np.asarray(psi_d), rtol=2e-6)
    np.testing.assert_array_equal(np.asarray(data_l.views), np.asarray(data_d.views))
    np.testing.assert_array_equal(
        np.asarray(data_l.weights), np.asarray(data_d.weights)
    )
    # and the sharded RL program accepts the loaded layout directly
    out = deconvolve_sharded(psi_l, data_l, 2, mesh, lam=0.006)
    ref = deconvolve_sharded(psi_d, data_d, 2, mesh, lam=0.006)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_reads_are_slabwise():
    views, k1, k2, _ = _problem()
    mesh = make_mesh(view_parallel=2, z_parallel=4)
    readers, calls = _recording([as_reader(v) for v in views])
    make_sharded_stack(mesh, readers, SHAPE)
    assert calls, "loader never called the readers"
    slab = SHAPE[0] // 4
    for v, (z0, z1, _) in calls:
        assert z1 - z0 == slab, f"read ({z0},{z1}) is not a z/4 slab"


def test_h5_and_scalar_weights_sources(tmp_path):
    views, k1, k2, _ = _problem()
    from libmultiviewnative_jax.io.stacks import save_stack_h5

    srcs = []
    for v, arr in enumerate(views):
        p = tmp_path / f"view_{v}.h5"
        save_stack_h5(str(p), chunks_z=4, view=arr)
        srcs.append(f"{p}:view")

    mesh = make_mesh(view_parallel=4, z_parallel=2)
    psi, data = load_sharded_workspace(
        mesh, srcs, k1, k2, [1.0 / V] * V, SHAPE
    )
    np.testing.assert_array_equal(
        np.asarray(data.views), np.stack(views)
    )
    assert data.weights.shape == (V,)
    # flat-average psi0 (the reference's psi_0 convention)
    np.testing.assert_allclose(
        float(np.asarray(psi)[0, 0, 0]), float(np.mean(np.stack(views))), rtol=1e-5
    )


def test_tiff_and_npz_sources(tmp_path):
    """as_reader handles whole-file formats (TIFF, NPZ) and the loader
    assembles them identically to in-memory arrays."""
    from libmultiviewnative_jax.io.stacks import (
        save_stack_npz,
        write_tiff_stack,
    )

    views, k1, k2, _ = _problem(seed=9)
    srcs = []
    for v, arr in enumerate(views):
        if v % 2 == 0:
            p = tmp_path / f"view_{v}.tif"
            write_tiff_stack(str(p), arr)
            srcs.append(str(p))
        else:
            p = tmp_path / f"view_{v}.npz"
            save_stack_npz(str(p), view=arr)
            srcs.append(f"{p}:view")

    mesh = make_mesh(view_parallel=2, z_parallel=4)
    readers = [as_reader(s) for s in srcs]
    got = np.asarray(make_sharded_stack(mesh, readers, SHAPE))
    np.testing.assert_allclose(got, np.stack(views), rtol=1e-6)
