"""Model-facade tests: RL model == functional path; Wiener actually
deconvolves and accelerates RL when used as the initializer."""

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.deconv.rl import deconvolve_jit
from libmultiviewnative_jax.deconv.workspace import MultiViewData, initial_psi
from libmultiviewnative_jax.models import RichardsonLucy, WienerFilter
from libmultiviewnative_jax.reference.numpy_ref import (
    np_convolve_spectrum,
    np_wrap_kernel,
)
from libmultiviewnative_jax.reference.oracle import rms
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


@pytest.fixture(scope="module")
def problem():
    shape = (20, 20, 20)
    rng = np.random.default_rng(17)
    phantom = np.full(shape, 1.0)
    for _ in range(6):
        z, y, x = (rng.integers(4, s - 4) for s in shape)
        phantom[z, y, x] = 300.0
    V = 3
    k1s = [gaussian_kernel((7, 7, 7), 1.0 + 0.3 * v) for v in range(V)]
    views = [
        np_convolve_spectrum(phantom, np.fft.rfftn(np_wrap_kernel(k, shape)))
        for k in k1s
    ]
    data = MultiViewData(
        views=jnp.asarray(np.stack(views).astype(np.float32)),
        kernel1=jnp.asarray(np.stack(k1s)),
        kernel2=jnp.asarray(np.flip(np.stack(k1s), axis=(1, 2, 3)).copy()),
        weights=jnp.full((V,) + shape, 1.0 / V, jnp.float32),
    )
    return phantom, data


def test_rl_model_matches_functional(problem):
    _, data = problem
    model = RichardsonLucy(num_iterations=3, lambda_=0.006, auto_dispatch=False,
                           algorithm="fft")
    got = np.asarray(model.run(data))
    psi0 = initial_psi(data, "average")
    want = np.asarray(deconvolve_jit(psi0, data, 3, lam=0.006))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_wiener_deconvolves(problem):
    phantom, data = problem
    out = np.asarray(WienerFilter(nsr=1e-4).run(data))
    blurred = np.asarray(data.views[0])
    assert rms(out, phantom) < rms(blurred, phantom)
    assert out.min() >= 0.0


def test_wiener_init_accelerates_rl(problem):
    phantom, data = problem
    rl = RichardsonLucy(num_iterations=4, auto_dispatch=False, algorithm="fft")
    from_avg = np.asarray(rl.run(data))
    wiener0 = WienerFilter(nsr=1e-3).run(data)
    # RL needs strictly positive psi
    from_wiener = np.asarray(rl.run(data, psi0=jnp.maximum(wiener0, 1e-3)))
    assert rms(from_wiener, phantom) < rms(from_avg, phantom)
