"""HBM-saving option tests: adjoint_kernel2 conj-spectrum reuse and
per-view scalar weights must be exact vs the explicit forms."""

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.deconv.rl import deconvolve_jit
from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.reference.oracle import rms
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


def _base(rng, V=2, shape=(12, 12, 12), kshape=(5, 5, 5)):
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel(kshape, 1.0 + 0.3 * v) for v in range(V)])
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    return views, k1, k2


@pytest.mark.parametrize("algorithm", ["fft", "dft", "direct"])
def test_adjoint_kernel2_matches_explicit_flip(rng, algorithm):
    views, k1, k2 = _base(rng)
    V, shape = 2, (12, 12, 12)
    w = np.full((V,) + shape, 0.5, np.float32)
    psi0 = jnp.full(shape, float(np.mean(views)), jnp.float32)

    explicit = MultiViewData(jnp.asarray(views), jnp.asarray(k1),
                             jnp.asarray(k2), jnp.asarray(w))
    a = np.asarray(deconvolve_jit(psi0.copy(), explicit, 2, algorithm=algorithm))
    b = np.asarray(
        deconvolve_jit(
            psi0.copy(), explicit, 2, algorithm=algorithm, adjoint_kernel2=True
        )
    )
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_adjoint_kernel2_rejects_even_dims(rng):
    views, k1, k2 = _base(rng, kshape=(4, 5, 5))
    data = MultiViewData(
        jnp.asarray(views), jnp.asarray(k1), jnp.asarray(k2),
        jnp.full((2, 12, 12, 12), 0.5, jnp.float32),
    )
    psi0 = jnp.full((12, 12, 12), 1.0, jnp.float32)
    with pytest.raises(ValueError, match="odd kernel1 dims"):
        deconvolve_jit(psi0, data, 1, adjoint_kernel2=True)


@pytest.mark.parametrize("view_order", ["sequential", "simultaneous"])
def test_scalar_weights_match_full_stacks(rng, view_order):
    views, k1, k2 = _base(rng)
    V, shape = 2, (12, 12, 12)
    psi0 = jnp.full(shape, float(np.mean(views)), jnp.float32)

    full = MultiViewData(
        jnp.asarray(views), jnp.asarray(k1), jnp.asarray(k2),
        jnp.full((V,) + shape, 1.0 / V, jnp.float32),
    )
    scalar = MultiViewData(
        jnp.asarray(views), jnp.asarray(k1), jnp.asarray(k2),
        jnp.full((V,), 1.0 / V, jnp.float32),
    )
    a = np.asarray(deconvolve_jit(psi0.copy(), full, 2, view_order=view_order))
    b = np.asarray(deconvolve_jit(psi0.copy(), scalar, 2, view_order=view_order))
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_sharded_scalar_weights(rng):
    import jax as _jax

    if _jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    from libmultiviewnative_jax.parallel.sharded import (
        deconvolve_sharded,
        make_mesh,
        shard_workspace,
    )

    views, k1, k2 = _base(rng, V=2, shape=(16, 8, 8))
    psi0 = jnp.full((16, 8, 8), float(np.mean(views)), jnp.float32)
    scalar = MultiViewData(
        jnp.asarray(views), jnp.asarray(k1), jnp.asarray(k2),
        jnp.full((2,), 0.5, jnp.float32),
    )
    want = np.asarray(
        deconvolve_jit(psi0.copy(), scalar, 2, view_order="simultaneous")
    )
    mesh = make_mesh(view_parallel=2, z_parallel=2, devices=_jax.devices()[:4])
    psi_s, data_s = shard_workspace(scalar, psi0, mesh)
    got = np.asarray(deconvolve_sharded(psi_s, data_s, 2, mesh))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
@pytest.mark.parametrize("shape", [(12, 12, 12), (16, 16, 16)])
def test_prepared_spectra_match_oneshot(rng, algorithm, shape):
    from libmultiviewnative_jax.deconv.rl import (
        deconvolve_prepared,
        prepare_workspace,
    )

    V = 2
    views, k1, k2 = _base(rng, V=V, shape=shape)
    w = np.full((V,) + shape, 0.5, np.float32)
    psi0 = jnp.full(shape, float(np.mean(views)), jnp.float32)
    data = MultiViewData(jnp.asarray(views), jnp.asarray(k1),
                         jnp.asarray(k2), jnp.asarray(w))
    prepared = prepare_workspace(data, shape, algorithm=algorithm)
    a = np.asarray(deconvolve_prepared(psi0.copy(), data, prepared, 2, 0.006))
    b = np.asarray(
        deconvolve_jit(psi0.copy(), data, 2, lam=0.006, algorithm=algorithm)
    )
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # prepared spectra reusable across calls (second call, fresh psi)
    c = np.asarray(deconvolve_prepared(psi0.copy(), data, prepared, 2, 0.006))
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize(
    "algorithm,forwarder",
    [("fft", "prepare_spectra"), ("dft", "prepare_spectra_split")],
)
def test_prepared_timelapse_skips_forwarding(rng, monkeypatch, algorithm,
                                            forwarder):
    """Time-lapse contract: with a PreparedSpectra in hand, repeated
    deconvolve_prepared calls must NOT re-run the kernel spectrum
    forwarding — the very per-call cost the prepared path exists to
    amortize."""
    from libmultiviewnative_jax.deconv import rl
    from libmultiviewnative_jax.deconv.rl import (
        deconvolve_prepared,
        prepare_workspace,
    )

    V, shape = 2, (16, 16, 16)
    views, k1, k2 = _base(rng, V=V, shape=shape)
    w = np.full((V,) + shape, 0.5, np.float32)
    data = MultiViewData(jnp.asarray(views), jnp.asarray(k1),
                         jnp.asarray(k2), jnp.asarray(w))

    calls = {"n": 0}
    orig = getattr(rl, forwarder)

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(rl, forwarder, counting)
    prepared = prepare_workspace(data, shape, algorithm=algorithm)
    prep_calls = calls["n"]
    assert prep_calls > 0  # forwarding happened at prepare time

    psi0 = jnp.full(shape, float(np.mean(views)), jnp.float32)
    # two "time points" (fresh views each call, fixed PSFs)
    for t in range(2):
        frame = MultiViewData(
            jnp.asarray(views + np.float32(t)), data.kernel1,
            data.kernel2, data.weights,
        )
        deconvolve_prepared(psi0.copy(), frame, prepared, 2, 0.006)
    assert calls["n"] == prep_calls  # zero forwarding after prepare


def test_prepare_workspace_auto_matches_serving_engine(rng):
    """'auto' in prepare_workspace resolves like deconvolve's auto: on the
    CPU backend, the dense-DFT plan up to 256/axis."""
    from libmultiviewnative_jax.deconv.rl import prepare_workspace

    views, k1, k2 = _base(rng, shape=(16, 16, 16))
    data = MultiViewData(
        jnp.asarray(views), jnp.asarray(k1), jnp.asarray(k2),
        jnp.full((2, 16, 16, 16), 0.5, jnp.float32),
    )
    prepared = prepare_workspace(data, (16, 16, 16), algorithm="auto")
    assert prepared.algorithm == "dft"


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
@pytest.mark.parametrize("shape", [(12, 12, 12), (16, 16, 16)])
def test_prepared_simultaneous_view_order(rng, algorithm, shape):
    """Round-4 contract widening: deconvolve_prepared accepts view_order
    like deconvolve_jit (it shares the whole driver), so a prepared
    time-lapse pipeline can run the shardable simultaneous math too."""
    from libmultiviewnative_jax.deconv.rl import (
        deconvolve_prepared,
        prepare_workspace,
    )

    V = 2
    views, k1, k2 = _base(rng, V=V, shape=shape)
    w = np.full((V,) + shape, 0.5, np.float32)
    psi0 = jnp.full(shape, float(np.mean(views)), jnp.float32)
    data = MultiViewData(jnp.asarray(views), jnp.asarray(k1),
                         jnp.asarray(k2), jnp.asarray(w))
    prepared = prepare_workspace(data, shape, algorithm=algorithm)
    a = np.asarray(
        deconvolve_prepared(
            psi0.copy(), data, prepared, 2, 0.006,
            view_order="simultaneous",
        )
    )
    b = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, 2, lam=0.006, algorithm=algorithm,
            view_order="simultaneous",
        )
    )
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_prepared_rejects_shape_mismatch(rng):
    from libmultiviewnative_jax.deconv.rl import (
        deconvolve,
        prepare_workspace,
    )

    shape = (12, 12, 12)
    views, k1, k2 = _base(rng, V=2, shape=shape)
    w = np.full((2,) + shape, 0.5, np.float32)
    data = MultiViewData(jnp.asarray(views), jnp.asarray(k1),
                         jnp.asarray(k2), jnp.asarray(w))
    prepared = prepare_workspace(data, shape, algorithm="fft")
    with pytest.raises(ValueError, match="prepared spectra are for"):
        deconvolve(
            jnp.zeros((16, 16, 16), jnp.float32), data, 1, prepared=prepared
        )


def test_prepare_workspace_rejects_direct(rng):
    """The direct engine keeps its kernels spatial — there is nothing to
    prepare, so an explicit request is an error, not a silent engine
    change."""
    from libmultiviewnative_jax.deconv.rl import prepare_workspace

    views, k1, k2 = _base(rng, V=2, shape=(12, 12, 12))
    data = MultiViewData(jnp.asarray(views), jnp.asarray(k1),
                         jnp.asarray(k2), jnp.full((2,), 0.5, jnp.float32))
    with pytest.raises(ValueError, match="supports fft/dft"):
        prepare_workspace(data, (12, 12, 12), algorithm="direct")
