"""Cache-semantics + misc utility tests.

KernelSpectrumCache mirrors the reference plan-store contract
(test_plan_store.cpp:83-177): miss -> build, hit -> same object, clear
empties; plus h5 IO and the stack printer."""

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.core.fft import KernelSpectrumCache
from libmultiviewnative_jax.core.dft import make_plan
from libmultiviewnative_jax.io.stacks import load_stack_h5, save_stack_h5
from libmultiviewnative_jax.utils.printing import format_stack
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


def test_spectrum_cache_hit_miss_clear():
    cache = KernelSpectrumCache()
    k = jnp.asarray(gaussian_kernel((3, 3, 3), 1.0))
    assert len(cache) == 0
    a = cache.get(k, (8, 8, 8))
    assert len(cache) == 1
    b = cache.get(k, (8, 8, 8))
    assert a is b  # hit returns the cached spectrum
    c = cache.get(k, (10, 8, 8))  # different extents -> new entry
    assert len(cache) == 2 and c is not a
    cache.clear()
    assert len(cache) == 0


def test_dft_plan_cache_identity():
    # make_plan is lru_cached per shape (the plan-store analog)
    assert make_plan((8, 8, 8)) is make_plan((8, 8, 8))
    assert make_plan((8, 8, 8)) is not make_plan((8, 8, 10))


def test_h5_roundtrip(tmp_path):
    p = str(tmp_path / "s.h5")
    a = np.random.default_rng(0).normal(size=(20, 8, 8)).astype(np.float32)
    save_stack_h5(p, chunks_z=4, psi=a)
    back = load_stack_h5(p, "psi")
    np.testing.assert_array_equal(back, a)
    everything = load_stack_h5(p)
    assert set(everything) == {"psi"}


def test_format_stack():
    a = np.arange(8.0, dtype=np.float32).reshape(2, 2, 2)
    s = format_stack(a)
    assert "image_stack 2x2x2" in s
    assert "-- z = 1 --" in s
    assert "7.000" in s
