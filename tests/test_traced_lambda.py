"""Traced λ/min_value contract: on every engine the regularization
constants are RUNTIME OPERANDS — a λ sweep (the tuning loop the prepared
path exists for) compiles ONE program per shape, like the reference's plan
store which never re-plans when λ changes (reference
inc/plan_store.h:25-235; λ lives in the runtime workspace struct,
inc/multiviewnative.h:28-35)."""

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.deconv.rl import (
    deconvolve,
    deconvolve_jit,
    deconvolve_prepared,
    prepare_workspace,
)
from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


def _problem(rng, V=2, shape=(12, 12, 12)):
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v) for v in range(V)])
    k2 = np.flip(k1, axis=(1, 2, 3)).copy()
    w = np.full((V,) + shape, 1.0 / V, np.float32)
    data = MultiViewData(
        jnp.asarray(views), jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(w)
    )
    psi0 = jnp.full(shape, float(np.mean(views)), jnp.float32)
    return data, psi0


@pytest.mark.parametrize("algorithm", ["fft", "dft", "direct"])
def test_lambda_sweep_compiles_once(rng, algorithm):
    data, psi0 = _problem(rng)
    lams = [0.0, 0.002, 0.006, 0.01, 0.05]
    outs = []
    deconvolve_jit(psi0.copy(), data, 2, lam=lams[0], algorithm=algorithm)
    n0 = deconvolve_jit._cache_size()
    for lam in lams:
        outs.append(
            np.asarray(
                deconvolve_jit(
                    psi0.copy(), data, 2, lam=lam, algorithm=algorithm
                )
            )
        )
    # the whole sweep reuses the single compiled program
    assert deconvolve_jit._cache_size() == n0
    # ... and each value matches the eager static-λ reference math exactly
    for lam, got in zip(lams, outs):
        want = np.asarray(deconvolve(psi0.copy(), data, 2, lam=lam,
                                     algorithm=algorithm))
        np.testing.assert_array_equal(got, want)


def test_min_value_is_traced_too(rng):
    data, psi0 = _problem(rng)
    deconvolve_jit(psi0.copy(), data, 2, lam=0.006, min_value=1e-4)
    n0 = deconvolve_jit._cache_size()
    a = np.asarray(
        deconvolve_jit(psi0.copy(), data, 2, lam=0.006, min_value=1e-3)
    )
    assert deconvolve_jit._cache_size() == n0
    want = np.asarray(
        deconvolve(psi0.copy(), data, 2, lam=0.006, min_value=1e-3)
    )
    np.testing.assert_array_equal(a, want)


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
def test_prepared_lambda_sweep_compiles_once(rng, algorithm):
    data, psi0 = _problem(rng)
    shape = tuple(psi0.shape)
    prepared = prepare_workspace(data, shape, algorithm=algorithm)
    deconvolve_prepared(psi0.copy(), data, prepared, 2, lam=0.0)
    n0 = deconvolve_prepared._cache_size()
    for lam in (0.0, 0.002, 0.006, 0.01, 0.05):
        got = np.asarray(
            deconvolve_prepared(psi0.copy(), data, prepared, 2, lam=lam)
        )
        want = np.asarray(
            deconvolve(psi0.copy(), data, 2, lam=lam, algorithm=algorithm)
        )
        np.testing.assert_array_equal(got, want)
    assert deconvolve_prepared._cache_size() == n0


@pytest.mark.parametrize("algorithm", ["fft", "dft", "direct", "auto"])
def test_every_engine_takes_traced_lambda(rng, algorithm):
    """Every engine rides the traced-λ program: a λ/min_value sweep
    through the public driver adds at most one compiled program."""
    data, psi0 = _problem(rng)
    deconvolve_jit(psi0.copy(), data, 1, lam=0.0, algorithm=algorithm)
    n0 = deconvolve_jit._cache_size()
    for lam, mv in ((0.006, 1e-4), (0.05, 1e-3)):
        deconvolve_jit(
            psi0.copy(), data, 1, lam=lam, min_value=mv, algorithm=algorithm
        )
    assert deconvolve_jit._cache_size() == n0


def test_direct_lambda_matches_traced_fft(rng):
    """Cross-engine λ agreement: the direct (stencil) and fft engines
    agree for a Tikhonov λ, so the λ path is the same math on both."""
    data, psi0 = _problem(rng, shape=(16, 16, 16))
    a = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, 2, lam=0.006, algorithm="direct"
        )
    )
    b = np.asarray(
        deconvolve_jit(psi0.copy(), data, 2, lam=0.006, algorithm="fft")
    )
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.skipif(
    __import__("jax").device_count() < 8, reason="needs 8 virtual devices"
)
@pytest.mark.parametrize("view_order", ["simultaneous", "sequential"])
def test_sharded_lambda_sweep_compiles_once(rng, view_order):
    """Round 5: the mesh rung honors the same λ contract on its explicit
    fft engine — one compiled program serves the whole sweep, in BOTH
    view orders (sequential = the z-only parity mode)."""
    import jax
    import numpy as np

    from libmultiviewnative_jax.parallel.sharded import (
        deconvolve_sharded_jit,
        make_mesh,
        shard_workspace,
    )

    data, psi0 = _problem(rng, V=2, shape=(16, 16, 16))
    if view_order == "sequential":
        mesh = make_mesh(
            view_parallel=1, z_parallel=4,
            devices=np.asarray(jax.devices()[:4]),
        )
    else:
        mesh = make_mesh(
            view_parallel=2, z_parallel=2,
            devices=np.asarray(jax.devices()[:4]),
        )
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    deconvolve_sharded_jit(
        psi_s + 0, data_s, 2, mesh, lam=0.0, view_order=view_order
    )
    n0 = deconvolve_sharded_jit._cache_size()
    for lam in (0.0, 0.002, 0.006, 0.02, 0.05):
        got = np.asarray(
            deconvolve_sharded_jit(
                psi_s + 0, data_s, 2, mesh, lam=lam, view_order=view_order
            )
        )
        want = np.asarray(
            deconvolve(
                psi0.copy(), data, 2, lam=lam, algorithm="fft",
                view_order=view_order,
            )
        )
        # overlap-save transforms at halo-extended extents vs the
        # single-device program: f32 roundoff class (see test_dispatch's
        # 5e-5 convention), not a λ-path discrepancy
        assert float(np.sqrt(np.mean((got - want) ** 2))) < 5e-5
    assert deconvolve_sharded_jit._cache_size() == n0


def test_history_lambda_sweep_compiles_once(rng):
    """deconvolve_with_history shares the traced-λ contract (a
    convergence-monitored λ-tuning sweep compiles once)."""
    from libmultiviewnative_jax.deconv.rl import deconvolve_with_history

    data, psi0 = _problem(rng)
    deconvolve_with_history(psi0.copy(), data, 3, lam=0.0)
    n0 = deconvolve_with_history._cache_size()
    deltas = {}
    for lam in (0.0, 0.006, 0.05):
        psi, d = deconvolve_with_history(psi0.copy(), data, 3, lam=lam)
        deltas[lam] = np.asarray(d)
        assert np.asarray(d).shape == (3,)
    assert deconvolve_with_history._cache_size() == n0
    # λ actually changes the convergence trace
    assert abs(deltas[0.05][-1] - deltas[0.0][-1]) > 0


def test_streamed_rung_lambda_sweep_compiles_once(rng):
    """Round 5: the streamed out-of-core rung's chunk programs also take
    λ/min_value as runtime operands — a λ sweep reuses
    one compiled chunk program per extent."""
    from libmultiviewnative_jax.deconv.streamed import (
        _UPD_FNS,
        deconvolve_streamed,
    )

    V, shape = 2, (16, 8, 8)
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = [gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(V)]
    k2 = [np.flip(k).copy() for k in k1]
    w = [np.full(shape, 1.0 / V, np.float32)] * V
    psi0 = np.full(shape, float(views.mean()), np.float32)

    fns = _UPD_FNS
    outs = {}
    n0 = None
    for lam in (0.0, 0.006, 0.05):
        outs[lam] = deconvolve_streamed(
            psi0.copy(), list(views), k1, k2, w, 2, lam, 1e-4,
            chunk_z=8, algorithm="fft",
        )
        n = fns["fft"]._cache_size()
        if n0 is None:
            n0 = n
        assert n == n0  # no per-λ recompiles after the first
    assert np.abs(outs[0.05] - outs[0.0]).max() > 0
    # values match the in-core traced-λ driver
    data = MultiViewData(
        jnp.asarray(views), jnp.asarray(np.stack(k1)),
        jnp.asarray(np.stack(k2)), jnp.asarray(np.stack(w)),
    )
    want = np.asarray(
        deconvolve_jit(
            jnp.asarray(psi0), data, 2, lam=0.006, algorithm="fft"
        )
    )
    rms = float(np.sqrt(np.mean((outs[0.006] - want) ** 2)))
    assert rms < 1e-5, rms
