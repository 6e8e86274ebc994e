"""Out-of-core streamed deconvolve must match the in-core path exactly
(the contract the reference's interleaved mode is held to in
test_gpu_deconvolve_impl.cu:28-333)."""

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.deconv.rl import deconvolve_jit
from libmultiviewnative_jax.deconv.streamed import deconvolve_streamed
from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.reference.oracle import rms
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


@pytest.mark.parametrize("chunk_z", [4, 5, 16])
def test_streamed_matches_incore(chunk_z, rng):
    shape = (16, 12, 12)
    V = 2
    views = [rng.gamma(2.0, 20.0, shape).astype(np.float32) for _ in range(V)]
    k1s = [gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(V)]
    k2s = [np.flip(k).copy() for k in k1s]
    ws = [np.full(shape, 1.0 / V, np.float32) for _ in range(V)]
    psi0 = np.full(shape, float(np.mean(views)), np.float32)

    got = deconvolve_streamed(
        psi0, views, k1s, k2s, ws, num_iterations=2, lam=0.006, chunk_z=chunk_z
    )

    data = MultiViewData(
        views=jnp.asarray(np.stack(views)),
        kernel1=jnp.asarray(np.stack(k1s)),
        kernel2=jnp.asarray(np.stack(k2s)),
        weights=jnp.asarray(np.stack(ws)),
    )
    want = np.asarray(
        deconvolve_jit(jnp.asarray(psi0), data, num_iterations=2, lam=0.006)
    )
    assert rms(got, want) < 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_streamed_from_h5_disk(tmp_path, rng):
    """Out-of-core end to end: views live in z-chunked HDF5 on disk and
    stream through the device without ever being fully materialized by the
    framework (h5py datasets support the z-slicing the streamed driver
    performs)."""
    import h5py

    from libmultiviewnative_jax.io.stacks import save_stack_h5

    shape = (16, 12, 12)
    V = 2
    views = [rng.gamma(2.0, 20.0, shape).astype(np.float32) for _ in range(V)]
    k1s = [gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(V)]
    k2s = [np.flip(k).copy() for k in k1s]
    ws = [np.full(shape, 1.0 / V, np.float32) for _ in range(V)]
    psi0 = np.full(shape, float(np.mean(views)), np.float32)

    path = str(tmp_path / "views.h5")
    save_stack_h5(path, chunks_z=4,
                  **{f"view_{v}": views[v] for v in range(V)},
                  **{f"weights_{v}": ws[v] for v in range(V)})

    with h5py.File(path, "r") as f:
        got = deconvolve_streamed(
            psi0,
            [f[f"view_{v}"] for v in range(V)],   # h5 datasets, not arrays
            k1s,
            k2s,
            [f[f"weights_{v}"] for v in range(V)],
            num_iterations=2,
            lam=0.006,
            chunk_z=4,
        )

    want = deconvolve_streamed(
        psi0, views, k1s, k2s, ws, num_iterations=2, lam=0.006, chunk_z=4
    )
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_pick_chunk_z_smooth_for_every_kernel():
    """The auto chunk must give a 5-smooth extended extent for EVERY
    kernel pass, not just the max-halo one (the repo-standard 21^3/25^3
    pair at 512^3 regressed exactly this way: chunk 232 made the 25^3
    pass 256 but the 21^3 pass 252 = 2^2*3^2*7)."""
    from libmultiviewnative_jax.deconv.streamed import _smooth, pick_chunk_z

    pairs = [(10, 10), (12, 12)]  # 21^3 and 25^3 halos
    c = pick_chunk_z(512, pairs)
    for lo, hi in pairs:
        assert _smooth(c + lo + hi), (c, lo, hi)
    # single-pair behaviour unchanged
    c1 = pick_chunk_z(512, [(12, 12)])
    assert _smooth(c1 + 24)
