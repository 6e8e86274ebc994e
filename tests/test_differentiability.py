"""Differentiability — a capability the reference's C++/CUDA stack cannot
offer: the whole RL pipeline is a pure JAX function, so gradients flow
through it (enabling learned-PSF / hyperparameter optimization research
on top of the framework)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libmultiviewnative_jax.core.convolve import fft_convolve3d
from libmultiviewnative_jax.deconv.rl import prepare_spectra, rl_view_step
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


def test_grad_through_convolve(rng):
    x = jnp.asarray(rng.normal(size=(8, 8, 8)).astype(np.float32))
    k = jnp.asarray(gaussian_kernel((3, 3, 3), 1.0))

    def loss(kernel):
        return jnp.sum(fft_convolve3d(x, kernel, mode="circular") ** 2)

    g = jax.grad(loss)(k)
    assert g.shape == k.shape
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.abs(g).max()) > 0


def test_grad_through_rl_step(rng):
    shape = (8, 8, 8)
    psi = jnp.asarray(rng.gamma(2.0, 5.0, shape).astype(np.float32))
    view = jnp.asarray(rng.gamma(2.0, 5.0, shape).astype(np.float32))
    w = jnp.full(shape, 0.5, jnp.float32)
    k = jnp.asarray(gaussian_kernel((3, 3, 3), 1.0))[None]

    def loss(psi0):
        k1 = prepare_spectra(k, shape)[0]
        out = rl_view_step(psi0, view, k1, jnp.conj(k1), w, 0.0, 1e-4)
        return jnp.mean((out - view) ** 2)

    g = jax.grad(loss)(psi)
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.abs(g).max()) > 0
