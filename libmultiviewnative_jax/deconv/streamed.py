"""Out-of-core ("streamed") deconvolution for volumes beyond device memory.

Analog of the reference's interleaved GPU strategy
(reference src/gpu_deconvolve_methods.cuh:85-326): when the workspace
cannot live on one device, the volume stays in HOST memory and flows through
the device in Z-chunks.

The reference overlaps transfer with compute via 2 CUDA streams, pinned
buffers, and kernel prefetch ("kick",
inc/gpu_convolve.cuh:57-98).  Here the same overlap comes from PJRT's
async dispatch: chunk programs are ENQUEUED ahead of the host fetches, so
chunk i+1's H2D + compute run while the host is still pulling chunk i's
result ("software pipeline" of bounded depth — at most ``INFLIGHT`` chunk
working sets live on the device, preserving the out-of-core property).

Stage fusion: the reference's 4 steps per view
(src/multiviewnative.cpp:191-228) become TWO chunked device passes —
  pass A: quotient[z] = view[z] / (psi_ext (x) k1)        (convolve+divide)
  pass B: psi[z]      = rl_update(psi[z], quot_ext (x) k2, w[z])
halving both host<->device traffic and dispatch count versus one pass per
step.  (Pass A/B cannot fuse further: pass B's convolution needs the
quotient of NEIGHBORING chunks — the overlap-save halo.)

Engine fidelity: ``algorithm`` ('fft' | 'dft' | 'direct' | 'auto') is
honored exactly as on the in-core rung; 'auto' resolves through
:func:`policy.resolve_algorithm` per extended-chunk extent.

Correctness is exact vs the in-core sequential path (overlap-save with
full halos; ring wrap at volume ends = the circular boundary contract).
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.convolve import convolve_spectrum, direct_convolve3d
from ..core.dft import dft_convolve_spectrum, kernel_spectrum_split
from ..core.fft import rfft3
from ..core.kernels import rl_update
from ..core.shapes import halo_widths
from ..core.wrap import wrap_kernel
from .policy import resolve_algorithm

# bounded pipeline depth: how many chunk working sets may be in flight on
# the device before the host fetches the oldest (the analog of the
# reference's 2-stream round robin, inc/cufft_utils.cuh:88-187)
INFLIGHT = 2


def _chunk_bounds(Z: int, chunk: int) -> List[Tuple[int, int]]:
    return [(lo, min(lo + chunk, Z)) for lo in range(0, Z, chunk)]


def _gather_extended(vol: np.ndarray, z0: int, z1: int, lo: int, hi: int):
    """Chunk [z0, z1) plus circularly wrapped halos from host memory."""
    Z = vol.shape[0]
    idx = np.arange(z0 - lo, z1 + hi) % Z
    return vol[idx]


def _smooth(n: int) -> bool:
    """2^a * 3^b * 5^c — sizes XLA's FFT handles at mixed-radix speed."""
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def pick_chunk_z(Z: int, halo_pairs) -> int:
    """Chunk size whose EXTENDED extent (chunk + halos) is engine-friendly
    for EVERY pass.

    ``halo_pairs``: iterable of per-kernel (lo, hi) — each chunked pass
    transforms chunk + its own kernel's halos, so a chunk smooth only for
    the max-halo kernel still lands the other pass on slow sizes (e.g.
    21^3/25^3 kernels at 512^3: chunk 232 gives 256 for the 25^3 pass but
    252 = 2^2*3^2*7 for the 21^3 one).  A naive power-of-two chunk is
    worse still: 2^k + (kernel-1) hits Bluestein-fallback sizes (chunk 128
    with 21^3 kernels gives ext 148 = 4*37).
    Pick the largest chunk <= min(Z, 256 - max halos) with a 5-smooth
    extended extent for every pair — <=256 also keeps the 'auto' chunk
    engine on the dense-DFT path where the policy allows it."""
    pairs = sorted({(int(lo), int(hi)) for lo, hi in halo_pairs})
    if not pairs:
        return min(Z, 256)
    cap = min(Z, 256 - max(lo + hi for lo, hi in pairs))
    for c in range(cap, 15, -1):
        if all(_smooth(c + lo + hi) for lo, hi in pairs):
            return c
    # No 5-smooth chunk in [16, cap] (or halos eat the whole 256 budget):
    # each tiny chunk re-transforms nearly the full extended extent, so
    # throughput can collapse by orders of magnitude — tell the user WHY
    # instead of silently degenerating (advisor, round 2).
    fallback = max(cap, 1)
    import warnings

    warnings.warn(
        f"pick_chunk_z: no FFT-friendly chunk for Z={Z}, halos={pairs}; "
        f"falling back to chunk_z={fallback} (extended extents "
        f"{[fallback + lo + hi for lo, hi in pairs]} are not 5-smooth — "
        "expect slow Bluestein-class transforms; pass an explicit chunk_z "
        "or pad the volume to a 5-smooth extent)",
        RuntimeWarning,
        stacklevel=2,
    )
    return fallback


@partial(jax.jit, static_argnames=("out_z", "lo"))
def _quot_chunk_fft(ext, k_hat, view_c, out_z: int, lo: int):
    """Pass A chunk program, fft engine: view / (ext (x) k1), cropped."""
    blurred = convolve_spectrum(ext, k_hat)
    blurred = jax.lax.slice_in_dim(blurred, lo, lo + out_z, axis=0)
    return view_c * (1.0 / blurred)


@partial(jax.jit, static_argnames=("out_z", "lo"))
def _quot_chunk_dft(ext, k_re, k_im, view_c, out_z: int, lo: int):
    blurred = dft_convolve_spectrum(ext, k_re, k_im)
    blurred = jax.lax.slice_in_dim(blurred, lo, lo + out_z, axis=0)
    return view_c * (1.0 / blurred)


@partial(jax.jit, static_argnames=("out_z", "lo"))
def _quot_chunk_direct(ext, kernel, view_c, out_z: int, lo: int):
    blurred = direct_convolve3d(ext, kernel, mode="circular")
    blurred = jax.lax.slice_in_dim(blurred, lo, lo + out_z, axis=0)
    return view_c * (1.0 / blurred)


@partial(jax.jit, static_argnames=("out_z", "lo"))
def _upd_chunk_fft(ext, k_hat, psi_c, w_c, lam, min_value, out_z: int, lo: int):
    """Pass B chunk program, fft engine: rl_update(psi, ext (x) k2, w)."""
    integral = convolve_spectrum(ext, k_hat)
    integral = jax.lax.slice_in_dim(integral, lo, lo + out_z, axis=0)
    return rl_update(psi_c, integral, w_c, lam, min_value)


@partial(jax.jit, static_argnames=("out_z", "lo"))
def _upd_chunk_dft(ext, k_re, k_im, psi_c, w_c, lam, min_value, out_z: int, lo: int):
    integral = dft_convolve_spectrum(ext, k_re, k_im)
    integral = jax.lax.slice_in_dim(integral, lo, lo + out_z, axis=0)
    return rl_update(psi_c, integral, w_c, lam, min_value)


@partial(jax.jit, static_argnames=("out_z", "lo"))
def _upd_chunk_direct(ext, kernel, psi_c, w_c, lam, min_value, out_z: int, lo: int):
    integral = direct_convolve3d(ext, kernel, mode="circular")
    integral = jax.lax.slice_in_dim(integral, lo, lo + out_z, axis=0)
    return rl_update(psi_c, integral, w_c, lam, min_value)


_QUOT_FNS = {"fft": _quot_chunk_fft, "dft": _quot_chunk_dft, "direct": _quot_chunk_direct}
_UPD_FNS = {"fft": _upd_chunk_fft, "dft": _upd_chunk_dft, "direct": _upd_chunk_direct}


def _kernel_operand(kernel: np.ndarray, ext_shape, algo: str, cache: dict):
    """Forward (or pass through) the kernel for one chunk extent, cached
    across the whole run — each kernel is prepared ONCE per (engine,
    extent), the plan-store analog of the reference's one-time
    generate_forwarded_kernels (src/gpu_deconvolve_methods.cuh:28-65)."""
    key = (id(kernel), algo, tuple(ext_shape))
    op = cache.get(key)
    if op is None:
        if algo == "fft":
            op = (rfft3(wrap_kernel(jnp.asarray(kernel), ext_shape)),)
        elif algo == "dft":
            op = kernel_spectrum_split(jnp.asarray(kernel), ext_shape)
        elif algo == "direct":
            op = (jnp.asarray(kernel),)
        else:
            raise ValueError(f"unknown algorithm {algo!r}")
        cache[key] = op
    return op


def _streamed_pass(
    src: np.ndarray,
    kernel: np.ndarray,
    chunk: int,
    out: np.ndarray,
    spectra_cache: dict,
    algorithm: str,
    chunk_fns: dict,
    extra_per_chunk,
) -> np.ndarray:
    """One chunked device pass over the volume with a bounded in-flight
    pipeline: dispatch chunk i, fetch chunk i-INFLIGHT — the device works
    on chunk i's H2D+compute while the host drains older results."""
    (lo, _, _), (hi, _, _) = halo_widths(kernel.shape)
    Z = src.shape[0]
    bounds = _chunk_bounds(Z, chunk)
    pending: List[Tuple[int, int, jnp.ndarray]] = []
    for z0, z1 in bounds:
        # drain the oldest BEFORE dispatching the next chunk so at most
        # INFLIGHT chunk working sets are ever live on the device
        if len(pending) >= INFLIGHT:
            p0, p1, r = pending.pop(0)
            out[p0:p1] = np.asarray(r)
        bz = z1 - z0
        ext_shape = (bz + lo + hi,) + src.shape[1:]
        algo = resolve_algorithm(algorithm, ext_shape)
        k_ops = _kernel_operand(kernel, ext_shape, algo, spectra_cache)
        ext = jnp.asarray(_gather_extended(src, z0, z1, lo, hi))
        res = chunk_fns[algo](
            ext, *k_ops, *extra_per_chunk(z0, z1), out_z=bz, lo=lo
        )
        pending.append((z0, z1, res))
    for p0, p1, r in pending:
        out[p0:p1] = np.asarray(r)
    return out


def deconvolve_streamed(
    psi: np.ndarray,
    views: Sequence[np.ndarray],
    kernels1: Sequence[np.ndarray],
    kernels2: Sequence[np.ndarray],
    weights: Sequence[np.ndarray],
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    chunk_z="auto",
    algorithm: str = "fft",
) -> np.ndarray:
    """Host-resident multi-view RL; device sees only Z-chunks.

    ``chunk_z``: an int, or "auto" (default) to pick a chunk whose
    extended extent is engine-friendly (:func:`pick_chunk_z`).

    Exact same math as deconv.rl.deconvolve(view_order='sequential') — the
    acceptance contract of the reference's interleaved mode
    (tests/test_gpu_deconvolve_impl.cu compares both strategies to the same
    goldens).  λ/min_value are runtime operands of the chunk programs: a λ
    sweep reuses one program per extent."""
    psi = np.array(psi, np.float32, copy=True)
    if chunk_z == "auto":
        halos = [halo_widths(np.shape(k)) for ks in (kernels1, kernels2) for k in ks]
        chunk_z = pick_chunk_z(
            psi.shape[0], [(h[0][0], h[1][0]) for h in halos]
        )
    quotient = np.empty_like(psi)

    lam, min_value = jnp.float32(lam), jnp.float32(min_value)

    # materialize kernels ONCE so the spectra cache keys stay stable across
    # the whole run (spectra are forwarded once per kernel x chunk extent)
    k1s = [np.asarray(k, np.float32) for k in kernels1]
    k2s = [np.asarray(k, np.float32) for k in kernels2]
    spectra_cache: dict = {}

    for _ in range(num_iterations):
        for v in range(len(views)):
            view_v, w_v = views[v], weights[v]
            # pass A: quotient = view / (psi (x) k1)
            _streamed_pass(
                psi, k1s[v], chunk_z, quotient, spectra_cache, algorithm,
                _QUOT_FNS,
                lambda z0, z1: (jnp.asarray(view_v[z0:z1]),),
            )
            # pass B: psi = rl_update(psi, quotient (x) k2, w)
            _streamed_pass(
                quotient, k2s[v], chunk_z, psi, spectra_cache, algorithm,
                _UPD_FNS,
                lambda z0, z1: (
                    jnp.asarray(psi[z0:z1]),
                    jnp.asarray(w_v[z0:z1]),
                    lam,
                    min_value,
                ),
            )
    return psi
