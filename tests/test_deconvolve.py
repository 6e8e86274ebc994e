"""Integration tests: multi-view RL deconvolution vs the float64 reference.

The analog of the reference's tests/test_cpu_deconvolve.cpp:53-142 — with
goldens regenerated by the in-repo float64 numpy mirror (the external Fiji
TIFF pack is unavailable; SURVEY.md §4).
Tolerances mirror the reference's acceptance structure: tight central-crop
rms, looser global rms.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from libmultiviewnative_jax.deconv.rl import deconvolve_jit
from libmultiviewnative_jax.deconv.workspace import (
    MultiViewData,
    Workspace,
    initial_psi,
    pad_kernel_to,
)
from libmultiviewnative_jax.reference.numpy_ref import np_deconvolve
from libmultiviewnative_jax.reference.oracle import rms, rms_within_limits
from libmultiviewnative_jax.utils.synthetic import (
    delta_kernel,
    gaussian_kernel,
    multiview_data,
)


def _problem(num_views=4, shape=(16, 16, 16), seed=3):
    """A non-trivial synthetic deconvolution problem: a sparse bead phantom
    blurred by per-view anisotropic Gaussians (views = blurred phantom)."""
    rng = np.random.default_rng(seed)
    phantom = np.full(shape, 1.0, np.float64)
    for _ in range(6):
        z, y, x = (rng.integers(2, s - 2) for s in shape)
        phantom[z, y, x] = 500.0

    from libmultiviewnative_jax.reference.numpy_ref import (
        np_convolve_spectrum,
        np_wrap_kernel,
    )

    views, k1s, k2s, ws = [], [], [], []
    for v in range(num_views):
        sigma = 1.0 + 0.3 * v
        k1 = gaussian_kernel((5, 5, 5), sigma=sigma).astype(np.float64)
        k2 = np.flip(k1).copy()  # adjoint kernel = mirrored PSF
        k_hat = np.fft.rfftn(np_wrap_kernel(k1, shape))
        view = np_convolve_spectrum(phantom, k_hat)
        views.append(view.astype(np.float32))
        k1s.append(k1.astype(np.float32))
        k2s.append(k2.astype(np.float32))
        ws.append(np.full(shape, 1.0 / num_views, np.float32))
    return views, k1s, k2s, ws


@pytest.mark.parametrize("lam", [0.0, 0.006])
def test_deconvolve_matches_float64_reference(lam):
    views, k1s, k2s, ws = _problem()
    psi0 = np.full(views[0].shape, float(np.mean(views)), np.float32)

    golden = np_deconvolve(
        psi0, views, k1s, k2s, ws, num_iterations=2, lam=lam, min_value=1e-4
    )

    data = MultiViewData(
        views=np.stack(views),
        kernel1=np.stack(k1s),
        kernel2=np.stack(k2s),
        weights=np.stack(ws),
    )
    out = np.asarray(
        deconvolve_jit(psi0, data, num_iterations=2, lam=lam, min_value=1e-4)
    )
    # acceptance structure of test_cpu_deconvolve.cpp:73-87: central crop
    # tight, global loose
    assert rms_within_limits(out, golden, 0.3, 0.7) < 1e-2
    assert rms(out, golden) < 1.0


def test_deconvolve_direct_algorithm_matches_fft():
    views, k1s, k2s, ws = _problem(num_views=2)
    psi0 = np.full(views[0].shape, float(np.mean(views)), np.float32)
    data = MultiViewData(
        views=np.stack(views),
        kernel1=np.stack(k1s),
        kernel2=np.stack(k2s),
        weights=np.stack(ws),
    )
    fft = np.asarray(
        deconvolve_jit(psi0.copy(), data, num_iterations=2, algorithm="fft")
    )
    direct = np.asarray(
        deconvolve_jit(psi0.copy(), data, num_iterations=2, algorithm="direct")
    )
    assert rms(fft, direct) < 1e-2


def test_deconvolve_delta_kernels_is_stable():
    # the reference bench workload: delta kernels -> convolution is identity,
    # quotient -> 1, update -> psi converges to weighted blend of views
    views = multiview_data(4, (12, 12, 12), kernel="delta")
    ws = Workspace.from_views(views, num_iterations=3)
    psi0 = initial_psi(ws.data, "average")
    out = np.asarray(
        deconvolve_jit(
            psi0, ws.data, num_iterations=3, lam=0.0, min_value=1e-4
        )
    )
    assert np.all(np.isfinite(out))
    # views are constant 128; RL with identity PSF must land on 128
    np.testing.assert_allclose(out, 128.0, rtol=1e-3)


def test_sequential_view_order_matters():
    # guards the parity semantics: sequential must differ from simultaneous
    # on asymmetric-view problems (each view sees prior views' updates)
    views, k1s, k2s, ws = _problem(num_views=3)
    psi0 = np.full(views[0].shape, float(np.mean(views)), np.float32)
    data = MultiViewData(
        views=np.stack(views),
        kernel1=np.stack(k1s),
        kernel2=np.stack(k2s),
        weights=np.stack(ws),
    )
    seq = np.asarray(deconvolve_jit(psi0.copy(), data, 1, view_order="sequential"))
    sim = np.asarray(deconvolve_jit(psi0.copy(), data, 1, view_order="simultaneous"))
    assert np.all(np.isfinite(seq)) and np.all(np.isfinite(sim))
    assert not np.allclose(seq, sim)


def test_pad_kernel_preserves_spectrum():
    from libmultiviewnative_jax.core.fft import forward_kernel_spectrum

    k = gaussian_kernel((5, 4, 3), sigma=1.5)
    padded = pad_kernel_to(k, (7, 7, 7))
    a = np.asarray(forward_kernel_spectrum(k, (16, 16, 16)))
    b = np.asarray(forward_kernel_spectrum(padded, (16, 16, 16)))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_workspace_from_heterogeneous_kernels():
    views = multiview_data(2, (10, 10, 10), kernel="gaussian")
    views[1].kernel1 = gaussian_kernel((5, 5, 5), 1.0)  # smaller than view 0's
    data = MultiViewData.from_views(views)
    assert data.kernel1.shape == (2, 21, 21, 21)
    assert data.num_views == 2


def test_convergence_history():
    from libmultiviewnative_jax.deconv.rl import deconvolve_with_history

    views, k1s, k2s, ws = _problem(num_views=2)
    psi0 = np.full(views[0].shape, float(np.mean(views)), np.float32)
    data = MultiViewData(
        views=np.stack(views),
        kernel1=np.stack(k1s),
        kernel2=np.stack(k2s),
        weights=np.stack(ws),
    )
    psi, deltas = deconvolve_with_history(psi0, data, num_iterations=4)
    assert deltas.shape == (4,)
    deltas = np.asarray(deltas)
    assert np.all(deltas > 0) and np.all(np.isfinite(deltas))
    # RL update magnitude decays as it converges
    assert deltas[-1] < deltas[0]
    # final psi identical to the untracked path
    want = np.asarray(deconvolve_jit(psi0, data, num_iterations=4))
    np.testing.assert_allclose(np.asarray(psi), want, rtol=1e-6, atol=1e-6)


def test_direct_engine_matches_dft_engine(rng):
    """algorithm='direct' (spatial stencil) must match the einsum engine's
    math on a non-cubic volume, including the adjoint-kernel2 path."""
    V, shape = 2, (16, 24, 32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.2 * v) for v in range(V)])
    data = MultiViewData(
        views=jnp.asarray(rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
        weights=jnp.full((V,) + shape, 1.0 / V, jnp.float32),
    )
    psi0 = jnp.full(shape, float(jnp.mean(data.views)), jnp.float32)
    want = np.asarray(deconvolve_jit(psi0 + 0.0, data, 3, lam=0.006, algorithm="dft"))
    got = np.asarray(deconvolve_jit(psi0 + 0.0, data, 3, lam=0.006, algorithm="direct"))
    assert rms(got, want) < 1e-4
    # adjoint path: conj spectra vs the flipped spatial kernel
    want_a = np.asarray(
        deconvolve_jit(psi0 + 0.0, data, 2, algorithm="dft", adjoint_kernel2=True)
    )
    got_a = np.asarray(
        deconvolve_jit(psi0 + 0.0, data, 2, algorithm="direct", adjoint_kernel2=True)
    )
    assert rms(got_a, want_a) < 1e-4


def test_direct_engine_simultaneous_order(rng):
    """view_order='simultaneous' must work with the direct engine (the
    step runs under vmap over views — validated against the dft
    engine)."""
    V, shape = 2, (16, 16, 16)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.2 * v) for v in range(V)])
    data = MultiViewData(
        views=jnp.asarray(rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
        weights=jnp.full((V,) + shape, 1.0 / V, jnp.float32),
    )
    psi0 = jnp.full(shape, float(jnp.mean(data.views)), jnp.float32)
    out = np.asarray(
        deconvolve_jit(
            psi0 + 0.0, data, 2, algorithm="direct", view_order="simultaneous"
        )
    )
    ref = np.asarray(
        deconvolve_jit(
            psi0 + 0.0, data, 2, algorithm="dft", view_order="simultaneous"
        )
    )
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
