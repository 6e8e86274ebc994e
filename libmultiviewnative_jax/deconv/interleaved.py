"""Interleaved out-of-core rung: device-resident psi, host-streamed views.

The recast of the reference's interleaved GPU mode's actual design
point (reference src/gpu_deconvolve_methods.cuh:85-326): there, psi and the work
buffers LIVE ON THE DEVICE across the whole run and only the per-view
payloads (forwarded kernels, view image, weights) stream in, overlapped
with compute via 2 CUDA streams and a prefetch "kick"
(inc/gpu_convolve.cuh:57-98).  The fully-streamed rung (deconv.streamed)
additionally chunks psi itself — correct for psi > device memory, but it moves
~25x more bytes per iteration.

Here:
  * psi / quotient / integral are device arrays for the whole run
    (buffer-donated between steps — XLA's in-place analog of the
    reference's rotating device buffers, gpu_deconvolve_methods.cuh:160-171);
  * both convolves per view step run IN-CORE on the device (honoring the
    fft/dft engines; kernel spectra are forwarded once per view and
    cached on device — the analog of generate_forwarded_kernels,
    src/gpu_deconvolve_methods.cuh:28-65);
  * only the view image (and per-voxel weights, if any) stream
    host->device, in z-chunks, each chunk's H2D dispatched asynchronously
    so it overlaps the previous chunk's elementwise work (the kick);
    scalar per-view weights stream nothing at all;
  * nothing returns to the host until the final psi fetch.

Per-iteration host<->device traffic for V views of volume S bytes:
views V*S (+weights V*S if per-voxel), vs the fully-streamed rung's
~3*V*S down + ~(2V+2)*S up.  The chunk H2D copies are meant to ride
behind compute; how far they do over PCIe is not measured yet.

Memory: needs psi + 3 temporaries + 2V kernel spectra on device — the
dispatch ladder (deconv.dispatch) selects this rung when that fits but
the in-core workspace (which additionally holds all views+weights) does
not.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.convolve import convolve_spectrum
from ..core.dft import dft_convolve_spectrum, kernel_spectrum_split
from ..core.fft import rfft3
from ..core.kernels import rl_update
from ..core.wrap import wrap_kernel
from .policy import resolve_algorithm


def _resolve_engine(algorithm: str, spatial_shape) -> str:
    if algorithm not in ("fft", "dft", "auto"):
        raise ValueError(
            f"interleaved rung supports algorithm 'fft'|'dft'|'auto', "
            f"got {algorithm!r}"
        )
    # full-volume convolves: the same policy as the in-core engines
    return resolve_algorithm(algorithm, spatial_shape)


# two jit variants per engine: the conv2 call donates its input (the
# quotient dies there), but the conv1 call must NOT donate psi — the
# update step still reads it, and donating would force an extra
# full-volume copy (psi + 0.0) per view step just to keep psi alive
@partial(jax.jit, donate_argnums=(0,))
def _convolve_fft(x, k_hat):
    return convolve_spectrum(x, k_hat)


_convolve_fft_keep = jax.jit(lambda x, k_hat: convolve_spectrum(x, k_hat))


@partial(jax.jit, donate_argnums=(0,))
def _convolve_dft(x, k_re, k_im):
    return dft_convolve_spectrum(x, k_re, k_im)


_convolve_dft_keep = jax.jit(
    lambda x, k_re, k_im: dft_convolve_spectrum(x, k_re, k_im)
)


@partial(jax.jit, static_argnames=("z0",), donate_argnums=(0,))
def _quot_chunk(quotient, view_chunk, blurred, z0: int):
    """quotient[z0:z1] = view_chunk / blurred[z0:z1] (device-side)."""
    bz = view_chunk.shape[0]
    b = lax.dynamic_slice_in_dim(blurred, z0, bz, axis=0)
    return lax.dynamic_update_slice_in_dim(
        quotient, view_chunk * (1.0 / b), z0, axis=0
    )


@partial(jax.jit, static_argnames=("z0",), donate_argnums=(0,))
def _update_chunk(psi, integral, w_chunk, lam, min_value, z0: int):
    bz = w_chunk.shape[0]
    pz = lax.dynamic_slice_in_dim(psi, z0, bz, axis=0)
    iz = lax.dynamic_slice_in_dim(integral, z0, bz, axis=0)
    return lax.dynamic_update_slice_in_dim(
        psi, rl_update(pz, iz, w_chunk, lam, min_value), z0, axis=0
    )


@partial(jax.jit, donate_argnums=(0,))
def _update_scalar(psi, integral, w, lam, min_value):
    # scalar w broadcasts inside the update; XLA fuses it away
    return rl_update(psi, integral, w, lam, min_value)


def _chunk_bounds(Z: int, chunk: int):
    return [(z0, min(z0 + chunk, Z)) for z0 in range(0, Z, chunk)]


def deconvolve_interleaved(
    psi: np.ndarray,
    views: Sequence[np.ndarray],
    kernels1: Sequence[np.ndarray],
    kernels2: Sequence[np.ndarray],
    weights: Sequence,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    chunk_z: int = 64,
    algorithm: str = "auto",
) -> np.ndarray:
    """Sequential-parity RL with device-resident psi and streamed views.

    ``weights[v]`` may be a scalar (uniform blending: zero streaming) or a
    full (Z, Y, X) stack (streamed in z-chunks like the view).  Math is
    identical to deconv.rl.deconvolve(view_order='sequential').
    λ/min_value are runtime operands of every chunk program.
    """
    shape = tuple(int(s) for s in np.shape(psi))
    engine = _resolve_engine(algorithm, shape)
    V = len(views)

    # forward all kernel spectra once, device-resident (the
    # generate_forwarded_kernels analog)
    if engine == "fft":
        k1h = [rfft3(wrap_kernel(jnp.asarray(k, jnp.float32), shape)) for k in kernels1]
        k2h = [rfft3(wrap_kernel(jnp.asarray(k, jnp.float32), shape)) for k in kernels2]
        convolve = lambda x, op: _convolve_fft(x, *op)
        convolve_keep = lambda x, op: _convolve_fft_keep(x, *op)
        ops1, ops2 = [(h,) for h in k1h], [(h,) for h in k2h]
    else:
        ops1 = [kernel_spectrum_split(jnp.asarray(k, jnp.float32), shape) for k in kernels1]
        ops2 = [kernel_spectrum_split(jnp.asarray(k, jnp.float32), shape) for k in kernels2]
        convolve = lambda x, op: _convolve_dft(x, *op)
        convolve_keep = lambda x, op: _convolve_dft_keep(x, *op)

    w_scalars: List = []
    for w in weights:
        w_arr = np.asarray(w, np.float32)
        w_scalars.append(float(w_arr) if w_arr.ndim == 0 else None)

    lam, min_value = jnp.float32(lam), jnp.float32(min_value)
    psi_dev = jnp.asarray(np.asarray(psi, np.float32))
    bounds = _chunk_bounds(shape[0], int(chunk_z))

    def upload_view(v):
        """Issue ASYNC H2D for all of view v's chunks (device_put returns
        immediately; the DMA rides behind whatever the device is doing)."""
        return [
            jax.device_put(np.ascontiguousarray(views[v][z0:z1]))
            for z0, z1 in bounds
        ]

    # the reference's cross-view prefetch "kick"
    # (inc/gpu_convolve.cuh:57-98): view v+1's uploads are dispatched
    # while view v computes, so the next view's H2D can overlap the
    # current view's two convolves.  Costs one
    # extra view volume of device memory (accounted in
    # dispatch.estimate_interleaved_bytes).
    chunks = upload_view(0)
    step = 0
    total_steps = num_iterations * V
    for _ in range(num_iterations):
        for v in range(V):
            step += 1
            # blurred = psi (x) k1 — in-core on device via the
            # non-donating variant (psi survives for the update step; no
            # defensive copy needed)
            blurred = convolve_keep(psi_dev, ops1[v])
            if step < total_steps:
                next_chunks = upload_view((v + 1) % V)
            # quotient assembled chunk-wise from the prefetched uploads
            quotient = jnp.empty(shape, jnp.float32)
            for (z0, z1), chunk in zip(bounds, chunks):
                quotient = _quot_chunk(quotient, chunk, blurred, z0)
            del blurred, chunks
            integral = convolve(quotient, ops2[v])
            if step < total_steps:
                chunks = next_chunks
            if w_scalars[v] is not None:
                psi_dev = _update_scalar(
                    psi_dev, integral, w_scalars[v], lam, min_value
                )
            else:
                # per-voxel weights: issue ALL chunk uploads first (they
                # overlap the conv2 still in flight), then chain updates
                w_v = weights[v]
                wcs = [
                    jax.device_put(np.ascontiguousarray(w_v[z0:z1]))
                    for z0, z1 in bounds
                ]
                for (z0, z1), wc in zip(bounds, wcs):
                    psi_dev = _update_chunk(
                        psi_dev, integral, wc, lam, min_value, z0=z0
                    )
            del integral
    return np.asarray(psi_dev)
