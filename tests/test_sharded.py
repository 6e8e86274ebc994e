"""Multi-chip tests on the virtual 8-device CPU mesh — the test tier the
reference lacks entirely (SURVEY.md §4).

Validates: ring halo exchange == single-device circular convolution
(exact by construction), and the view×z sharded deconvolve == the
single-device simultaneous-mode deconvolve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from libmultiviewnative_jax.core.convolve import fft_convolve3d
from libmultiviewnative_jax.core.shapes import halo_widths
from libmultiviewnative_jax.deconv.rl import deconvolve_jit
from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.parallel.halo import convolve_zblock, zblock_kernel_spectrum
from libmultiviewnative_jax.parallel.sharded import (
    deconvolve_sharded,
    make_mesh,
    shard_workspace,
)
from libmultiviewnative_jax.reference.oracle import rms
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

shard_map = jax.shard_map

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


def _mesh_1d(n, name):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


@pytest.mark.parametrize("kshape", [(3, 3, 3), (5, 4, 3)])
def test_zblock_convolve_matches_single_device(kshape):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(16, 8, 8)).astype(np.float32)
    k = rng.normal(size=kshape).astype(np.float32)
    want = np.asarray(fft_convolve3d(x, k, mode="circular"))

    (lo, _, _), (hi, _, _) = halo_widths(kshape)
    mesh = _mesh_1d(8, "z")

    def f(block):
        k_hat = zblock_kernel_spectrum(jnp.asarray(k), block.shape)
        return convolve_zblock(block, k_hat, lo, hi, "z")

    out = shard_map(
        f, mesh=mesh, in_specs=P("z", None, None), out_specs=P("z", None, None)
    )(x)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-4, atol=1e-4)


def _sim_problem(num_views=4, shape=(16, 8, 8), seed=5):
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 20.0, (num_views,) + shape).astype(np.float32)
    k1 = np.stack(
        [gaussian_kernel((3, 3, 3), 0.8 + 0.2 * v) for v in range(num_views)]
    )
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    w = np.full((num_views,) + shape, 1.0 / num_views, np.float32)
    return MultiViewData(
        views=jnp.asarray(views),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(k2),
        weights=jnp.asarray(w),
    )


@pytest.mark.parametrize("vp,zp", [(1, 8), (4, 2), (2, 4)])
def test_sharded_deconvolve_matches_single_device_simultaneous(vp, zp):
    data = _sim_problem()
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)

    # deconvolve_jit donates its psi argument — hand it a copy
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, num_iterations=2, view_order="simultaneous"
        )
    )

    mesh = make_mesh(view_parallel=vp, z_parallel=zp)
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    out = np.asarray(
        deconvolve_sharded(psi_s, data_s, num_iterations=2, mesh=mesh)
    )
    assert rms(out, want) < 1e-4
    np.testing.assert_allclose(out, want, rtol=5e-3, atol=5e-3)


def test_sharded_rejects_undivisible():
    data = _sim_problem(num_views=3)
    psi0 = jnp.zeros((16, 8, 8), jnp.float32)
    mesh = make_mesh(view_parallel=2, z_parallel=4)
    with pytest.raises(ValueError, match="views not divisible"):
        deconvolve_sharded(psi0, data, 1, mesh)


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
def test_sharded_bz_equals_halo_boundary(algorithm):
    """Tightest legal z-decomposition: every block is exactly one halo
    wide, so each convolve's overlap-save extent is 3 blocks and every
    halo plane crosses a device boundary (parallel/halo ring ppermute).
    Must still match the single-device simultaneous driver exactly."""
    kshape = (5, 3, 3)  # z halo = (2, 2)
    Z, zp = 16, 8  # bz = 2 == halo
    rng = np.random.default_rng(7)
    V = 2
    views = rng.gamma(2.0, 20.0, (V, Z, 8, 8)).astype(np.float32)
    k1 = np.stack([gaussian_kernel(kshape, 0.8 + 0.2 * v) for v in range(V)])
    data = MultiViewData(
        views=jnp.asarray(views),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
        weights=jnp.full((V, Z, 8, 8), 1.0 / V, jnp.float32),
    )
    psi0 = jnp.full((Z, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, num_iterations=2, view_order="simultaneous"
        )
    )
    mesh = make_mesh(view_parallel=1, z_parallel=zp)
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    out = np.asarray(
        deconvolve_sharded(psi_s, data_s, 2, mesh, algorithm=algorithm)
    )
    assert rms(out, want) < 1e-4


def test_sharded_bz_below_halo_raises():
    data = _sim_problem()  # 3^3 kernels -> halo 1
    # 7^3 kernel -> halo 3 > bz 2 at zp=8, Z=16
    k1 = jnp.asarray(
        np.stack([gaussian_kernel((7, 7, 7), 1.0) for _ in range(4)])
    )
    data = MultiViewData(data.views, k1, k1, data.weights)
    psi0 = jnp.zeros((16, 8, 8), jnp.float32)
    mesh = make_mesh(view_parallel=1, z_parallel=8)
    with pytest.raises(ValueError, match="smaller than PSF halo"):
        deconvolve_sharded(psi0, data, 1, mesh)


@pytest.mark.parametrize("algorithm", ["dft", "auto"])
def test_sharded_dft_engine_matches_fft(algorithm):
    data = _sim_problem()
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    mesh = make_mesh(view_parallel=2, z_parallel=4)
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    a = np.asarray(
        deconvolve_sharded(psi_s + 0, data_s, 2, mesh, algorithm="fft")
    )
    b = np.asarray(
        deconvolve_sharded(psi_s + 0, data_s, 2, mesh, algorithm=algorithm)
    )
    assert rms(a, b) < 1e-4


# ---------------------------------------------------------------------------
# Mesh geometries on both spectral engines: view-only meshes (each device
# holds whole volumes), z-block meshes with per-voxel or scalar weights,
# and lane-realistic / misaligned Y-X planes (thin (…, 8, 8) planes miss
# layout bugs of real widths).
# ---------------------------------------------------------------------------


def _mesh_problem(num_views, shape, seed=9, kshape=(3, 3, 3),
                  scalar_weights=False):
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 20.0, (num_views,) + shape).astype(np.float32)
    k1 = np.stack(
        [gaussian_kernel(kshape, 0.8 + 0.2 * v) for v in range(num_views)]
    )
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    w = (
        np.full((num_views,), 1.0 / num_views, np.float32)
        if scalar_weights
        else np.full((num_views,) + shape, 1.0 / num_views, np.float32)
    )
    return MultiViewData(
        views=jnp.asarray(views),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(k2),
        weights=jnp.asarray(w),
    )


_GEOMETRIES = {
    # name: (views, shape, vp, zp, scalar_weights, iterations)
    "view-only": (4, (16, 16, 16), 4, 1, False, 2),
    "zblock": (2, (16, 16, 16), 2, 4, False, 2),
    "zblock-scalar-weights": (2, (16, 16, 16), 2, 4, True, 2),
    "wide-lanes-128": (2, (16, 128, 128), 2, 4, False, 1),
    "misaligned-y-136": (2, (16, 136, 16), 2, 4, False, 1),
}


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES))
def test_sharded_geometry_matches_single_device(geometry, algorithm):
    V, shape, vp, zp, scalar, iters = _GEOMETRIES[geometry]
    data = _mesh_problem(V, shape, scalar_weights=scalar)
    psi0 = jnp.full(shape, float(jnp.mean(data.views)), jnp.float32)
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, num_iterations=iters,
            view_order="simultaneous", algorithm=algorithm,
        )
    )
    mesh = make_mesh(
        view_parallel=vp, z_parallel=zp,
        devices=np.asarray(jax.devices()[: vp * zp]),
    )
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    out = np.asarray(
        deconvolve_sharded(psi_s, data_s, iters, mesh, algorithm=algorithm)
    )
    assert np.all(np.isfinite(out))
    assert rms(out, want) < 1e-4, rms(out, want)


def test_sharded_rejects_direct():
    """The mesh runs the spectral engines only: an explicit 'direct'
    request must raise, not silently become fft."""
    data = _mesh_problem(2, (16, 8, 8))
    psi0 = jnp.zeros((16, 8, 8), jnp.float32)
    mesh = make_mesh(view_parallel=2, z_parallel=4)
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    with pytest.raises(ValueError, match="sharded rung supports"):
        deconvolve_sharded(psi_s, data_s, 1, mesh, algorithm="direct")


@pytest.mark.parametrize("backend,want", [("cpu", "dft"), ("gpu", "fft")])
def test_sharded_auto_resolves_through_policy(monkeypatch, backend, want):
    """'auto' on the mesh resolves through the one engine policy at the
    halo-extended block extent — and the jitted driver does no string
    matching of its own."""
    from libmultiviewnative_jax.deconv import policy
    from libmultiviewnative_jax.parallel import sharded

    seen = []
    real = policy.resolve_algorithm

    def spy(algorithm, spatial, backend_=None):
        out = real(algorithm, spatial, backend_ or backend)
        seen.append((algorithm, tuple(spatial), out))
        return out

    monkeypatch.setattr(sharded, "resolve_algorithm", spy)
    data = _mesh_problem(2, (16, 8, 8))
    psi0 = jnp.full((16, 8, 8), 40.0, jnp.float32)
    mesh = make_mesh(view_parallel=2, z_parallel=4)
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    out = np.asarray(
        sharded.deconvolve_sharded(psi_s, data_s, 1, mesh, algorithm="auto")
    )
    assert np.all(np.isfinite(out))
    # block 4 + halo (1, 1) = extent 6 along z
    assert seen == [("auto", (6, 8, 8), want)]


# ---------------------------------------------------------------------------
# Round-5: SEQUENTIAL (reference-parity) view order on a z-only mesh.
# The parity contract is the product (/root/reference/src/multiviewnative.cpp:191-228);
# z-decomposition lives INSIDE each view step (overlap-save halo exchange,
# exact for the circular boundary), so the sequential math scales past one
# device's memory with NO divergence.


def _seq_problem(num_views=3, shape=(16, 16, 16), seed=13, kshape=(5, 5, 5)):
    rng = np.random.default_rng(seed)
    views = rng.gamma(2.0, 20.0, (num_views,) + shape).astype(np.float32)
    k1 = np.stack(
        [gaussian_kernel(kshape, 0.9 + 0.2 * v) for v in range(num_views)]
    )
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    w = np.full((num_views,) + shape, 1.0 / num_views, np.float32)
    return MultiViewData(
        views=jnp.asarray(views),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(k2),
        weights=jnp.asarray(w),
    )


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
def test_sharded_sequential_matches_parity_math(algorithm):
    """z-only mesh sequential == single-device sequential (the reference
    math), rms < 1e-5 on the fft engine."""
    shape = (16, 16, 16)
    data = _seq_problem(shape=shape)
    psi0 = jnp.full(shape, float(jnp.mean(data.views)), jnp.float32)
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, num_iterations=3, lam=0.006,
            view_order="sequential", algorithm="fft",
        )
    )
    mesh = make_mesh(
        view_parallel=1, z_parallel=4,
        devices=np.asarray(jax.devices()[:4]),
    )
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    out = np.asarray(
        deconvolve_sharded(
            psi_s, data_s, 3, mesh, lam=0.006, algorithm=algorithm,
            view_order="sequential",
        )
    )
    assert np.all(np.isfinite(out))
    # rms < 1e-5 for the fft engine; the dft
    # engine's dense einsum transforms at halo-extended extents carry
    # slightly different f32 roundoff (same 5e-5 class as the streamed
    # rung's overlap-save comparisons in test_dispatch.py)
    tol = 5e-5 if algorithm == "dft" else 1e-5
    assert rms(out, want) < tol, rms(out, want)


def test_sharded_sequential_differs_from_simultaneous():
    """Sanity: the two view orders really compute different math on the
    same inputs (the sequential chain is order-dependent)."""
    shape = (16, 16, 16)
    data = _seq_problem(shape=shape)
    psi0 = jnp.full(shape, float(jnp.mean(data.views)), jnp.float32)
    mesh = make_mesh(
        view_parallel=1, z_parallel=4,
        devices=np.asarray(jax.devices()[:4]),
    )
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    seq = np.asarray(
        deconvolve_sharded(
            psi_s + 0, data_s, 3, mesh, lam=0.006, view_order="sequential"
        )
    )
    sim = np.asarray(
        deconvolve_sharded(
            psi_s + 0, data_s, 3, mesh, lam=0.006, view_order="simultaneous"
        )
    )
    assert rms(seq, sim) > 1e-4


def test_sharded_sequential_requires_zonly_mesh():
    data = _seq_problem(num_views=4)
    psi0 = jnp.zeros((16, 16, 16), jnp.float32)
    mesh = make_mesh(view_parallel=2, z_parallel=4)
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    with pytest.raises(ValueError, match="z-only mesh"):
        deconvolve_sharded(
            psi_s, data_s, 1, mesh, view_order="sequential"
        )


def test_sharded_sequential_scalar_weights_and_tikhonov():
    """Sequential mesh mode with the 512-class HBM options (scalar
    weights) and the Tikhonov branch, vs the in-core parity driver."""
    shape = (16, 16, 16)
    V = 2
    rng = np.random.default_rng(17)
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(V)])
    data = MultiViewData(
        views=jnp.asarray(views),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
        weights=jnp.full((V,), 1.0 / V, jnp.float32),
    )
    psi0 = jnp.full(shape, float(np.mean(views)), jnp.float32)
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, 2, lam=0.01, view_order="sequential",
        )
    )
    mesh = make_mesh(
        view_parallel=1, z_parallel=8,
        devices=np.asarray(jax.devices()[:8]),
    )
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    out = np.asarray(
        deconvolve_sharded(
            psi_s, data_s, 2, mesh, lam=0.01, view_order="sequential"
        )
    )
    assert rms(out, want) < 1e-5, rms(out, want)


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
@pytest.mark.parametrize("vp,zp,view_order", [
    (2, 2, "simultaneous"), (1, 4, "sequential"),
])
def test_sharded_long_x_matches_single_device(vp, zp, view_order, algorithm):
    """X=256 local extents through both mesh strategies — z-block
    overlap-save, both view orders (sequential = the z-only parity mode) —
    against the single-device driver in the same view order.  These are
    the mesh forms the 4-device chip check runs at 512^3."""
    shape = (16, 16, 256)
    V = 2 if view_order == "sequential" else vp * 2
    data = _mesh_problem(V, shape)
    psi0 = jnp.full(shape, float(jnp.mean(data.views)), jnp.float32)
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, num_iterations=2, lam=0.006,
            view_order=view_order, algorithm="fft",
        )
    )
    mesh = make_mesh(
        view_parallel=vp, z_parallel=zp,
        devices=np.asarray(jax.devices()[: vp * zp]),
    )
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    out = np.asarray(
        deconvolve_sharded(
            psi_s, data_s, 2, mesh, lam=0.006, algorithm=algorithm,
            view_order=view_order,
        )
    )
    assert np.all(np.isfinite(out))
    assert rms(out, want) < 1e-4, rms(out, want)
