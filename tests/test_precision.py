"""Matmul precision must be part of program identity: switching 'high'
(TF32 on a GPU) <-> 'highest' (float32) for an already-compiled shape must
produce a NEW program, never silently reuse code traced at the other
precision.

(On the CPU backend both precisions lower to the same f32 math, so the
observable contract here is RETRACE/RECOMPILE — trace counting and jit
cache size — not numeric divergence; on a GPU the recompile is what makes
the numerics follow the setting.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libmultiviewnative_jax.core import dft
from libmultiviewnative_jax.core.dft import set_matmul_precision


@pytest.fixture(autouse=True)
def _restore_precision():
    yield
    set_matmul_precision("highest")


def test_switch_retraces_same_shape():
    traces = []

    @jax.jit
    def f(x):
        traces.append(1)
        plan = dft.make_plan(tuple(x.shape))
        re, im = dft.dft3(x, plan)
        return dft.idft3(re, im, plan)

    x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 8, 8)), jnp.float32)
    set_matmul_precision("highest")
    f(x)
    f(x)
    assert len(traces) == 1  # cache hit at the same precision
    set_matmul_precision("high")
    f(x)
    assert len(traces) == 2  # precision flip invalidates the cached program
    set_matmul_precision("highest")
    f(x)
    assert len(traces) == 2  # flipping back reuses the first program


def test_deconvolve_jit_cache_keyed_on_precision(rng):
    from libmultiviewnative_jax.deconv.rl import deconvolve_jit
    from libmultiviewnative_jax.deconv.workspace import MultiViewData
    from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

    V, shape = 2, (8, 8, 8)
    k1 = np.stack([gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(V)])
    data = MultiViewData(
        views=jnp.asarray(rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
        weights=jnp.full((V,) + shape, 1.0 / V, jnp.float32),
    )
    psi0 = jnp.full(shape, float(jnp.mean(data.views)), jnp.float32)

    def run():
        return np.asarray(
            deconvolve_jit(psi0.copy(), data, 2, algorithm="dft")
        )

    set_matmul_precision("highest")
    a = run()
    n0 = deconvolve_jit._cache_size()
    set_matmul_precision("high")
    b = run()
    assert deconvolve_jit._cache_size() > n0  # a distinct compiled program
    # both must still be correct (CPU lowers both to f32 math)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_unknown_precision_rejected():
    with pytest.raises(KeyError):
        set_matmul_precision("bf16")  # not a supported name
    # and the config was not half-updated
    assert jax.config.jax_default_matmul_precision in (None, "high", "highest")
