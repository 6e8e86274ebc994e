"""Ring halo exchange + overlap-save block convolution along a sharded Z axis.

This is the capability the reference *lacks*: it never decomposes a single
volume — when a volume outgrows device memory it falls back to PCIe
streaming (the interleaved strategy, reference
src/gpu_deconvolve_methods.cuh:85-326) or refuses (reference
src/multiviewnative.cu:140).  Here the Z axis is sharded over the mesh and
PSF-support halos are exchanged between neighbouring devices with
``lax.ppermute`` — the sharding analog of its stream/prefetch machinery.

Math: global *circular* convolution (the reference's no_padd deconvolution
boundary) decomposes exactly into per-block overlap-save with a RING halo
exchange: block 0's lower halo is the last block's top planes, which is
precisely the global wrap.  Each device convolves its halo-extended block
(extent Bz+k-1) circularly and keeps the central Bz output planes, which
never touch the block-edge wrap — so the result is bit-identical in
structure to the single-device circular convolve.

Halo widths come from the kernel center convention c = k//2
(/root/reference/inc/padd_utils.h:25-27): ``lo = k-1-c`` planes from the
previous block, ``hi = c`` planes from the next
(libmultiviewnative_jax.core.shapes.halo_widths).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.convolve import convolve_spectrum
from ..core.fft import rfft3
from ..core.shapes import halo_widths
from ..core.wrap import wrap_kernel


def _ring_perms(n: int):
    fwd = [(i, (i + 1) % n) for i in range(n)]  # send to next rank
    bwd = [(i, (i - 1) % n) for i in range(n)]  # send to previous rank
    return fwd, bwd


def halo_exchange_z(
    block: jnp.ndarray, lo: int, hi: int, axis_name: str
) -> jnp.ndarray:
    """Extend a local (..., Bz, Y, X) block by ring-exchanged z halos.

    ``lo`` planes arrive from the previous rank (they are its top planes),
    ``hi`` planes from the next rank.  Ring wrap-around gives global
    circular boundary semantics for free.
    """
    n = lax.psum(1, axis_name)
    fwd, bwd = _ring_perms(n)
    zax = block.ndim - 3
    parts = []
    if lo > 0:
        top = lax.slice_in_dim(block, block.shape[zax] - lo, block.shape[zax], axis=zax)
        parts.append(lax.ppermute(top, axis_name, fwd))
    parts.append(block)
    if hi > 0:
        bottom = lax.slice_in_dim(block, 0, hi, axis=zax)
        parts.append(lax.ppermute(bottom, axis_name, bwd))
    return jnp.concatenate(parts, axis=zax) if len(parts) > 1 else block


def zblock_kernel_spectrum(
    kernel: jnp.ndarray, local_spatial: Tuple[int, int, int]
) -> jnp.ndarray:
    """Forward a PSF for halo-extended local blocks: wrap + rfft at extent
    (Bz + k - 1, Y, X)."""
    (lo_z, _, _), (hi_z, _, _) = halo_widths(kernel.shape)
    ext = (local_spatial[0] + lo_z + hi_z, local_spatial[1], local_spatial[2])
    return rfft3(wrap_kernel(kernel, ext))


def zblock_kernel_spectrum_split(
    kernel: jnp.ndarray, local_spatial: Tuple[int, int, int]
):
    """Split (re, im) spectrum at the halo-extended extent for the
    dense-DFT engine."""
    from ..core.dft import kernel_spectrum_split

    (lo_z, _, _), (hi_z, _, _) = halo_widths(kernel.shape)
    ext = (local_spatial[0] + lo_z + hi_z, local_spatial[1], local_spatial[2])
    return kernel_spectrum_split(kernel, ext)


def convolve_zblock(
    block: jnp.ndarray,
    kernel_hat_ext: jnp.ndarray,
    lo: int,
    hi: int,
    axis_name: str,
) -> jnp.ndarray:
    """Overlap-save circular convolution of a z-sharded volume.

    ``block``: local (..., Bz, Y, X) shard; ``kernel_hat_ext``: spectrum at
    the halo-extended extent.  Output planes [lo, lo+Bz) of the extended
    convolve are exact — crop offsets are the zero_padd ``offsets_``
    arithmetic (/root/reference/inc/padd_utils.h:121-146) lifted to blocks.
    """
    bz = block.shape[-3]
    ext = halo_exchange_z(block, lo, hi, axis_name)
    out = convolve_spectrum(ext, kernel_hat_ext)
    return lax.slice_in_dim(out, lo, lo + bz, axis=out.ndim - 3)


def convolve_zblock_dft(
    block: jnp.ndarray,
    kernel_split_ext,
    lo: int,
    hi: int,
    axis_name: str,
) -> jnp.ndarray:
    """:func:`convolve_zblock` with the dense-DFT engine (split spectra)."""
    from ..core.dft import dft_convolve_spectrum

    bz = block.shape[-3]
    ext = halo_exchange_z(block, lo, hi, axis_name)
    out = dft_convolve_spectrum(ext, kernel_split_ext[0], kernel_split_ext[1])
    return lax.slice_in_dim(out, lo, lo + bz, axis=out.ndim - 3)
