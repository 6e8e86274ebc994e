"""Interleaved rung (device-resident psi, streamed views) must reproduce
the in-core sequential math exactly — the acceptance contract the
reference applies to its interleaved mode
(tests/test_gpu_deconvolve_impl.cu compares both GPU strategies to the
same goldens)."""

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.deconv.interleaved import deconvolve_interleaved
from libmultiviewnative_jax.deconv.rl import deconvolve_jit
from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


@pytest.fixture
def problem():
    rng = np.random.default_rng(11)
    V, shape = 3, (24, 16, 16)
    views = [rng.gamma(2.0, 20.0, shape).astype(np.float32) for _ in range(V)]
    k1 = [gaussian_kernel((5, 5, 5), 1.0 + 0.2 * v) for v in range(V)]
    k2 = [np.flip(k).copy() for k in k1]
    ws = [rng.uniform(0.2, 0.5, shape).astype(np.float32) for _ in range(V)]
    psi0 = np.full(shape, float(np.mean(views)), np.float32)
    return psi0, views, k1, k2, ws, shape


def _incore(psi0, views, k1, k2, ws, shape, iters, lam, algorithm):
    data = MultiViewData(
        views=jnp.asarray(np.stack(views)),
        kernel1=jnp.asarray(np.stack(k1)),
        kernel2=jnp.asarray(np.stack(k2)),
        weights=jnp.asarray(np.stack([np.broadcast_to(w, shape) for w in ws])),
    )
    return np.asarray(
        deconvolve_jit(
            jnp.asarray(psi0), data, num_iterations=iters, lam=lam,
            algorithm=algorithm,
        )
    )


@pytest.mark.parametrize("engine", ["fft", "dft", "auto"])
@pytest.mark.parametrize("lam", [0.0, 0.006])
def test_interleaved_matches_incore(problem, engine, lam):
    psi0, views, k1, k2, ws, shape = problem
    got = deconvolve_interleaved(
        psi0, views, k1, k2, ws, 3, lam=lam, chunk_z=8, algorithm=engine
    )
    want = _incore(psi0, views, k1, k2, ws, shape, 3, lam, engine)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_interleaved_scalar_weights_stream_nothing(problem):
    """Scalar weights take the full-device update path and match the
    per-voxel path with constant stacks."""
    psi0, views, k1, k2, _, shape = problem
    scalars = [1.0 / 3.0] * 3
    stacks = [np.full(shape, 1.0 / 3.0, np.float32)] * 3
    a = deconvolve_interleaved(
        psi0, views, k1, k2, scalars, 2, chunk_z=8, algorithm="fft"
    )
    b = deconvolve_interleaved(
        psi0, views, k1, k2, stacks, 2, chunk_z=8, algorithm="fft"
    )
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_interleaved_uneven_chunks(problem):
    """Z not divisible by chunk_z: the tail chunk is smaller."""
    psi0, views, k1, k2, ws, shape = problem
    got = deconvolve_interleaved(
        psi0, views, k1, k2, ws, 2, chunk_z=7, algorithm="fft"
    )
    want = _incore(psi0, views, k1, k2, ws, shape, 2, 0.0, "fft")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_interleaved_rejects_unknown_engine(problem):
    psi0, views, k1, k2, ws, _ = problem
    with pytest.raises(ValueError, match="interleaved rung supports"):
        deconvolve_interleaved(
            psi0, views, k1, k2, ws, 1, algorithm="direct"
        )
