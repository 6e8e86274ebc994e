"""3D convolution engines: spectral (FFT) and direct (stencil) paths.

Replacement for the reference convolution engines (``cpu_convolve``,
reference inc/cpu_convolve.h:26-304, and ``gpu_convolve``, reference
inc/gpu_convolve.cuh:144-475).  The
reference's two entry points map to:

  * ``half_inplace(forwarded_kernel)``  → :func:`convolve_spectrum`
    (kernel spectrum precomputed once; one rfft + pointwise multiply +
    irfft per call — the RL hot path),
  * ``inplace()``                        → :func:`fft_convolve3d`
    (wraps + transforms the kernel itself; ``mode`` selects the padding
    policy: ``circular`` = no_padd, ``linear`` = zero_padd).

New here: :func:`direct_convolve3d` — for small PSF supports the taps run
as a dense contraction via ``lax.conv_general_dilated`` (cuDNN on a GPU),
which can beat the FFT path outright; :func:`convolve3d` picks per a static
policy.

Boundary semantics: the reference's deconvolution path is *circular*
convolution at image extent (kernels wrapped into image-shaped buffers,
/root/reference/src/multiviewnative.cpp:146-174; callers pre-pad the data).
All functions here treat the leading axes as batch and the trailing three as
(z, y, x) spatial.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax

from .fft import irfft3, rfft3
from .shapes import (
    as_shape,
    halo_widths,
    zero_pad_extents,
    zero_pad_offsets,
)
from .wrap import crop_at_offsets, embed_at_offsets, wrap_kernel


def convolve_spectrum(x: jnp.ndarray, kernel_hat: jnp.ndarray) -> jnp.ndarray:
    """Circular-convolve ``x`` with a pre-forwarded kernel spectrum.

    The RL fast path — parity with ``cpu_convolve::half_inplace``
    (/root/reference/inc/cpu_convolve.h:217-291): rfft(x), pointwise complex
    multiply, irfft (XLA's irfft applies the 1/N the reference scales by
    hand at inc/cpu_convolve.h:182-189).  Leading batch axes broadcast.
    """
    spatial = x.shape[-3:]
    return irfft3(rfft3(x) * kernel_hat, spatial)


def fft_convolve3d(
    image: jnp.ndarray,
    kernel: jnp.ndarray,
    mode: str = "circular",
) -> jnp.ndarray:
    """One-shot FFT convolution of an image with an unprepared kernel.

    Parity with ``cpu_convolve::inplace`` (/root/reference/inc/cpu_convolve.h:147-202):

    * ``mode="circular"`` — the no_padd policy (reference default,
      inc/cpu_convolve.h:24): kernel is wrapped into an image-extent buffer,
      convolution wraps around the volume edges.
    * ``mode="linear"`` — the zero_padd policy (inc/padd_utils.h:121-146):
      image embedded at offsets (k-1)//2 inside extents image+k-1, circular
      convolution there, then crop — i.e. true linear convolution with zero
      boundary.
    """
    if mode == "circular":
        k_hat = rfft3(wrap_kernel(kernel, image.shape[-3:]))
        return convolve_spectrum(image, k_hat)
    if mode == "linear":
        spatial = as_shape(image.shape[-3:])
        extents = zero_pad_extents(spatial, kernel.shape)
        offsets = zero_pad_offsets(kernel.shape)
        batch_pad = [(0, 0)] * (image.ndim - 3)
        padded = jnp.pad(
            image,
            batch_pad + [(o, e - o - s) for o, e, s in zip(offsets, extents, spatial)],
        )
        k_hat = rfft3(wrap_kernel(kernel, extents))
        out = convolve_spectrum(padded, k_hat)
        slices = tuple(slice(None) for _ in range(image.ndim - 3)) + tuple(
            slice(o, o + s) for o, s in zip(offsets, spatial)
        )
        return out[slices]
    raise ValueError(f"unknown mode {mode!r}; expected 'circular' or 'linear'")


def _pad_for_stencil(image: jnp.ndarray, kernel_shape, mode: str) -> jnp.ndarray:
    lo, hi = halo_widths(kernel_shape)
    pad_mode = {"circular": "wrap", "linear": "constant"}[mode]
    batch_pad = [(0, 0)] * (image.ndim - 3)
    return jnp.pad(image, batch_pad + list(zip(lo, hi)), mode=pad_mode)


def _stencil_conv(padded: jnp.ndarray, kernel: jnp.ndarray, spatial) -> jnp.ndarray:
    """Shift-and-add stencil: out = sum_m kernel[m] * padded[o_m : o_m + S]
    with o_m = (k-1) - m per axis (derived from out[p] = sum_m k[m]*x[p+c-m],
    c = k//2, lo = k-1-c).  Unrolled over taps — one fused elementwise chain; used
    for tiny kernels and as a correctness fallback where XLA's conv lowering
    is untrustworthy."""
    kz, ky, kx = kernel.shape
    lead = tuple(slice(None) for _ in range(padded.ndim - 3))
    out = None
    for mz in range(kz):
        for my in range(ky):
            for mx in range(kx):
                oz, oy, ox = kz - 1 - mz, ky - 1 - my, kx - 1 - mx
                sl = lead + (
                    slice(oz, oz + spatial[0]),
                    slice(oy, oy + spatial[1]),
                    slice(ox, ox + spatial[2]),
                )
                term = kernel[mz, my, mx] * padded[sl]
                out = term if out is None else out + term
    return out


def _lax_conv(padded: jnp.ndarray, kernel: jnp.ndarray, batch_shape, spatial):
    """Dense stencil via lax.conv.

    lax.conv computes correlation; flip the kernel for true convolution.
    """
    flipped = jnp.flip(kernel, axis=(0, 1, 2))
    x = padded.reshape((-1, 1) + padded.shape[-3:])  # NCZYX
    w = flipped[None, None]  # OIZYX
    out = lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        window_strides=(1, 1, 1),
        padding="VALID",
        dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
        preferred_element_type=jnp.float32,
        # full float32 products: a reduced-precision default (TF32 on a
        # GPU) costs ~2^-10 relative error, outside the reference's
        # tolerance envelope.
        precision=lax.Precision.HIGHEST,
    )
    return out.reshape(batch_shape + spatial).astype(padded.dtype)


_STENCIL_TAP_LIMIT = 256


def direct_convolve3d(
    image: jnp.ndarray,
    kernel: jnp.ndarray,
    mode: str = "circular",
    stencil: str = "auto",
) -> jnp.ndarray:
    """True convolution with a small PSF as a dense stencil contraction.

    Same math as the FFT path — out[p] = sum_j kernel[j] * x[p + c - j] with
    c = kernel_shape // 2 (the wrap convention of
    reference inc/padd_utils.h:11-40) — but computed in the spatial
    domain, as one convolution op instead of transforms; it answers the
    choice of a conv algorithm, not a translation of any reference code
    path.

    ``mode``: boundary handling, ``circular`` (wrap) or ``linear`` (zeros).
    ``stencil``: "auto" | "rolls" (shift-and-add) | "conv" (lax.conv).
    """
    spatial = image.shape[-3:]
    batch_shape = image.shape[:-3]
    padded = _pad_for_stencil(image, kernel.shape, mode)
    taps = 1
    for k in kernel.shape:
        taps *= int(k)
    if stencil == "auto":
        stencil = "rolls" if taps <= _STENCIL_TAP_LIMIT else "conv"
    if stencil == "rolls":
        return _stencil_conv(padded, kernel.astype(image.dtype), spatial)
    if stencil == "conv":
        return _lax_conv(padded, kernel, batch_shape, spatial)
    raise ValueError(f"unknown stencil {stencil!r}")


def convolve3d(
    image: jnp.ndarray,
    kernel: jnp.ndarray,
    mode: str = "circular",
    algorithm: str = "auto",
    direct_threshold: int = 15**3,
) -> jnp.ndarray:
    """Convolve, picking the FFT or direct engine by a static policy.

    The analog of the reference's algorithm dispatch (its GPU side picks
    between memory strategies at reference src/multiviewnative.cu:89-142;
    here the axis of choice is stencil vs spectral).  ``algorithm`` in
    {"auto", "fft", "direct"}; "auto" uses the direct path when the PSF tap
    count is at most ``direct_threshold``.
    """
    if algorithm == "auto":
        taps = 1
        for k in kernel.shape:
            taps *= int(k)
        algorithm = "direct" if taps <= direct_threshold else "fft"
    if algorithm == "direct":
        return direct_convolve3d(image, kernel, mode=mode)
    if algorithm == "fft":
        return fft_convolve3d(image, kernel, mode=mode)
    raise ValueError(f"unknown algorithm {algorithm!r}")
