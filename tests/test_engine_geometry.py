"""Both spectral engines at the geometries real volumes bring, against the
float64 mirror (reference/numpy_ref.py): lane-misaligned Y, 256-long and
mixed-radix long axes, X up to 1024, anisotropic and even kernels, and
whole 264^3 / 256x320x384 volumes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libmultiviewnative_jax.core.convolve import convolve_spectrum
from libmultiviewnative_jax.core.dft import (
    dft_convolve_spectrum,
    kernel_spectrum_split,
)
from libmultiviewnative_jax.core.fft import forward_kernel_spectrum
from libmultiviewnative_jax.reference.numpy_ref import (
    np_convolve_spectrum,
    np_rfftn,
    np_wrap_kernel,
)

# name: (volume shape, kernel shape)
GEOMETRIES = {
    "y136-misaligned": ((8, 136, 16), (5, 5, 5)),
    "y264-misaligned": ((8, 264, 16), (5, 5, 5)),
    "z256-long": ((256, 8, 8), (5, 5, 5)),
    "x384": ((8, 8, 384), (5, 5, 5)),
    "x512": ((8, 8, 512), (5, 5, 5)),
    "x768": ((8, 8, 768), (5, 5, 5)),
    "x1024": ((8, 8, 1024), (5, 5, 5)),
    "kernel-21x9x9": ((32, 16, 16), (21, 9, 9)),
    "kernel-8x6x6-even": ((16, 16, 16), (8, 6, 6)),
    "cube-264": ((264, 264, 264), (9, 9, 9)),
    "aniso-256x320x384": ((256, 320, 384), (9, 9, 9)),
}


def _convolve(engine, x, k):
    shape = x.shape
    if engine == "fft":
        k_hat = forward_kernel_spectrum(jnp.asarray(k), shape)
        return jax.jit(convolve_spectrum)(jnp.asarray(x), k_hat)
    kre, kim = kernel_spectrum_split(jnp.asarray(k), shape)
    return jax.jit(dft_convolve_spectrum)(jnp.asarray(x), kre, kim)


@pytest.mark.parametrize("engine", ["fft", "dft"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_engine_convolve_vs_float64_mirror(geometry, engine):
    shape, kshape = GEOMETRIES[geometry]
    rng = np.random.default_rng(sum(shape) + sum(kshape))
    x = rng.gamma(2.0, 20.0, shape).astype(np.float32)
    k = rng.gamma(2.0, 1.0, kshape).astype(np.float32)
    k /= k.sum()
    want = np_convolve_spectrum(
        x.astype(np.float64), np_rfftn(np_wrap_kernel(k, shape))
    )
    got = np.asarray(_convolve(engine, x, k), np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    # f32 transforms: ~1e-7 measured; an indexing or twiddle defect
    # costs >= 1e-3
    assert rel < 5e-6, rel
