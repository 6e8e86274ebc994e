"""3D real FFT layer + kernel-spectrum cache.

Replacement of the reference's FFT abstraction stack:
  * ``inplace_3d_transform`` (/root/reference/inc/fft_utils.h:13-153) and its
    cuFFT twin (/root/reference/inc/cufft_utils.cuh:19-84) become plain
    ``jnp.fft.rfftn`` / ``irfftn`` — XLA owns planning and layout, so the
    in-place ``2*(n/2+1)`` last-dim inflation dance disappears entirely.
  * the shape-keyed singleton plan stores (/root/reference/inc/plan_store.h:25-235,
    plan_store.cuh:20-217) are subsumed by jit's compilation cache (plans) plus
    ``KernelSpectrumCache`` below (pre-forwarded kernel *data*, the analog of
    ``generate_forwarded_kernels`` /root/reference/src/gpu_deconvolve_methods.cuh:28-65).

Normalization: irfftn applies 1/N, matching the reference's explicit
post-scale loop (/root/reference/inc/cpu_convolve.h:182-189).
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

from .shapes import Shape, as_shape
from .wrap import wrap_kernel

_AXES3 = (-3, -2, -1)


def rfft3(x: jnp.ndarray) -> jnp.ndarray:
    """Forward real 3D FFT over the trailing (z, y, x) axes."""
    return jnp.fft.rfftn(x, axes=_AXES3)


def irfft3(x: jnp.ndarray, shape: Sequence[int]) -> jnp.ndarray:
    """Inverse real 3D FFT back to the given trailing spatial shape.

    Includes the 1/N normalization (reference: inc/cpu_convolve.h:182-189).
    """
    return jnp.fft.irfftn(x, s=as_shape(shape), axes=_AXES3)


def forward_kernel_spectrum(kernel: jnp.ndarray, extents: Sequence[int]) -> jnp.ndarray:
    """Wrap a PSF to the origin and forward-transform it.

    The returned complex spectrum plays the role of the reference's
    "forwarded kernel" buffers (/root/reference/src/multiviewnative.cpp:146-174):
    compute it once per (kernel, image-shape) pair, then every convolution is
    a single rfft + pointwise multiply + irfft (the ``half_inplace`` fast path,
    /root/reference/inc/cpu_convolve.h:217-291).
    """
    kernel = jnp.asarray(kernel, jnp.float32)
    return rfft3(wrap_kernel(kernel, as_shape(extents)))


_fwd_spectrum_jit = jax.jit(forward_kernel_spectrum, static_argnums=(1,))


class KernelSpectrumCache:
    """Host-side cache of forwarded kernel spectra keyed by kernel identity.

    The analog of the reference plan stores — but caching *data* rather than
    plans (XLA's jit cache already holds the plans).  Unlike the reference's
    Meyers singletons (/root/reference/inc/plan_store.h:40-43, noted as
    thread-unsafe in SURVEY §5), this cache is lock-protected, holds a
    strong reference to each cached kernel (so a recycled ``id()`` can never
    alias a freed kernel's entry), and is LRU-bounded.
    """

    def __init__(self, maxsize: int = 64) -> None:
        from collections import OrderedDict

        # key -> (kernel object, spectrum); kernel kept alive so the id key
        # stays uniquely bound to it
        self._store: "OrderedDict[Tuple[int, Shape, Shape], tuple]" = (
            OrderedDict()
        )
        self._maxsize = int(maxsize)
        self._lock = threading.Lock()

    def get(self, kernel, extents: Sequence[int]) -> jnp.ndarray:
        extents = as_shape(extents)
        key = (id(kernel), tuple(kernel.shape), extents)
        with self._lock:
            hit = self._store.get(key)
            if hit is not None and hit[0] is kernel:
                self._store.move_to_end(key)
                return hit[1]
        spectrum = _fwd_spectrum_jit(jnp.asarray(kernel, jnp.float32), extents)
        with self._lock:
            self._store[key] = (kernel, spectrum)
            self._store.move_to_end(key)
            while len(self._store) > self._maxsize:
                self._store.popitem(last=False)
        return spectrum

    def clear(self) -> None:
        with self._lock:
            self._store.clear()

    def __len__(self) -> int:
        return len(self._store)


# Process-wide default cache, mirroring the reference's global plan store
# usage pattern (but explicit and resettable).
default_spectrum_cache = KernelSpectrumCache()
