"""Dense-DFT 3D real convolution transform: DFT by batched matmuls,
with a mixed-radix (Cooley-Tukey) split for long axes.

The reference's FFT engines delegate to FFTW/cuFFT (reference
inc/fft_utils.h, inc/cufft_utils.cuh).  This module is the library's
second spectral engine ('dft'): the transform of each axis is a dense
matrix product, so the whole convolve is a chain of batched einsums that
XLA hands to the backend's matmul units.  The 'fft' engine (XLA's FFT op,
cuFFT on a GPU) is the other; :mod:`deconv.policy` decides which one
'auto' means for a shape and backend.

Design:
  * real rfft along the last (x) axis via cos/sin matrices (real matmuls),
  * full complex DFT along y and z as split re/im real matmuls (einsum),
  * pointwise spectral multiply,
  * inverse transforms with hermitian-doubling weights folded into the
    last-axis matrix, producing the real output directly.

All twiddle matrices are built once per shape in float64 and cast to f32
(a ``DFTPlan``); einsums run at the library matmul precision
(:func:`set_matmul_precision`, default 'highest' = full float32 products).
This is the plan-store analog: the "plan" is a pytree of constant
matrices captured by jit.

Long axes (N > _DENSE_LIMIT) use one decimation-in-time split N = R * M:
reshape the axis to (M, R) [n = R*m + r], dense M-point DFT per residue
class (a full-contraction matmul), twiddle by e^{-2 pi i r p / N}, then an
R-point combine (R small, an einsum over a tiny R x R DFT).  FLOPs per
axis drop from N^2 to ~N*M while every matmul keeps a >=64 contraction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_PRECISIONS = {
    # full float32 products on every backend
    "highest": jax.lax.Precision.HIGHEST,
    # TF32 tensor-core products on an NVIDIA GPU (10-bit mantissa inputs,
    # float32 accumulation; error in docs/STABILITY.md); on the CPU
    # backend the same float32 math as 'highest'
    "high": jax.lax.Precision.HIGH,
}
# default from env (LMVN_MATMUL_PRECISION=high|highest), else f32-faithful
import os as _os

_PREC = _PRECISIONS.get(
    _os.environ.get("LMVN_MATMUL_PRECISION", "highest"), _PRECISIONS["highest"]
)


def set_matmul_precision(name: str) -> None:
    """Select the matmul precision of all DFT einsums: 'highest' (default,
    full float32 products) or 'high' (TF32 tensor-core products on an
    NVIDIA GPU; see ``_PRECISIONS`` and docs/STABILITY.md for its error).

    The precision is part of PROGRAM IDENTITY: besides setting the einsum
    precision used at trace time, this updates jax's
    ``jax_default_matmul_precision`` config, which participates in jit's
    tracing cache key — so switching precision retraces/recompiles every
    affected program instead of silently reusing code compiled at the
    previous precision.  (DFT einsums still pass their precision
    explicitly; the config flip exists to invalidate the cache, and only
    changes the default for ops that don't set precision themselves.)

    .. warning:: This flips the PROCESS-GLOBAL
       ``jax_default_matmul_precision`` (as does importing the library
       with ``LMVN_MATMUL_PRECISION`` set) — in a host application that
       embeds this library, any of the application's own matmuls that do
       not pin a precision will change numerics too.  Embedders who need
       isolation should wrap library calls in
       ``jax.default_matmul_precision(...)`` and leave this setter alone;
       the library's own kernels are precision-pinned either way."""
    global _PREC
    _PREC = _PRECISIONS[name]  # KeyError on unknown name, before config flip
    jax.config.update("jax_default_matmul_precision", name)


# make the process-start env default part of program identity too
if _os.environ.get("LMVN_MATMUL_PRECISION") in _PRECISIONS:
    jax.config.update(
        "jax_default_matmul_precision", _os.environ["LMVN_MATMUL_PRECISION"]
    )


def _EINSUM(*args, **kw):
    return jnp.einsum(*args, precision=_PREC, **kw)


_DENSE_LIMIT = 256  # above this an axis uses the mixed-radix split


class AxisPlan(NamedTuple):
    """One axis of a full-complex transform: dense or split (N = R*M)."""

    n: int
    kind: str  # 'dense' | 'split'
    cm: jnp.ndarray  # dense: (N, N) cos; split: (M, M) cos
    sm: jnp.ndarray  # matching sin
    twc: jnp.ndarray  # split twiddles (R, M) cos; dense: unused (1,1)
    tws: jnp.ndarray
    oc: jnp.ndarray  # split combine (R, R) cos; dense: unused
    osn: jnp.ndarray
    r: int
    m: int


class FullDFTPlan(NamedTuple):
    """Full-complex 3D plan for long-axis shapes (any axis > _DENSE_LIMIT).

    The x axis carries the FULL spectrum (no hermitian halving) so every
    axis can use the same dense/split machinery; the inverse still emits
    the real volume directly."""

    axes: Tuple[AxisPlan, AxisPlan, AxisPlan]  # (z, y, x)
    shape: Tuple[int, int, int]


class DFTPlan(NamedTuple):
    """Constant twiddle matrices for one (z, y, x) spatial shape."""

    # forward, x axis (real -> half spectrum), shapes (X, Kx)
    fcx: jnp.ndarray
    fsx: jnp.ndarray
    # forward, y and z axes (full complex DFT), shapes (N, N)
    cy: jnp.ndarray
    sy: jnp.ndarray
    cz: jnp.ndarray
    sz: jnp.ndarray
    # inverse, x axis with hermitian weights + 1/N (Kx, X)
    bcx: jnp.ndarray
    bsx: jnp.ndarray
    shape: Tuple[int, int, int]

    @property
    def kx(self) -> int:
        return self.fcx.shape[1]


def _pick_split(n: int):
    """Choose N = R*M with M as close to 128 as possible
    (64 <= M <= _DENSE_LIMIT, R <= 16).  None -> stay dense."""
    best = None
    for r in range(2, 17):
        if n % r:
            continue
        m = n // r
        if 64 <= m <= _DENSE_LIMIT:
            score = abs(m - 128)
            if best is None or score < best[0]:
                best = (score, r, m)
    return None if best is None else (best[1], best[2])


def _axis_plan(n: int, dtype) -> AxisPlan:
    f32 = lambda a: jnp.asarray(a, dtype)

    def cs(a, b, denom):
        theta = 2.0 * np.pi * np.outer(np.arange(a), np.arange(b)) / denom
        return np.cos(theta), np.sin(theta)

    split = _pick_split(n) if n > _DENSE_LIMIT else None
    if split is None:
        c, s = cs(n, n, n)
        one = jnp.zeros((1, 1), dtype)
        return AxisPlan(n, "dense", f32(c), f32(s), one, one, one, one, 1, n)
    r, m = split
    cm, sm = cs(m, m, m)
    twc, tws = cs(r, m, n)  # e^{-2 pi i r p / N}
    oc, osn = cs(r, r, r)
    return AxisPlan(
        n, "split", f32(cm), f32(sm), f32(twc), f32(tws), f32(oc), f32(osn), r, m
    )


@functools.lru_cache(maxsize=64)
def make_plan(shape: Tuple[int, int, int], dtype=jnp.float32):
    """Build the transform plan for a (z, y, x) shape: compact rfft-style
    (all axes dense, hermitian-halved x) when every axis fits the dense
    limit, else a FullDFTPlan with per-axis dense/split stages.

    Built under ensure_compile_time_eval so the cached constant matrices
    are real arrays even when first requested inside a jit trace (the
    lru_cache must never capture tracers)."""
    z, y, x = (int(s) for s in shape)
    with jax.ensure_compile_time_eval():
        if max(z, y, x) > _DENSE_LIMIT:
            return FullDFTPlan(
                axes=(
                    _axis_plan(z, dtype),
                    _axis_plan(y, dtype),
                    _axis_plan(x, dtype),
                ),
                shape=(z, y, x),
            )
        return _make_compact_plan((z, y, x), dtype)


def _make_compact_plan(shape: Tuple[int, int, int], dtype=jnp.float32) -> DFTPlan:
    z, y, x = (int(s) for s in shape)
    kx = x // 2 + 1

    def cs(n):
        k = np.arange(n)
        theta = 2.0 * np.pi * np.outer(k, k) / n
        return np.cos(theta), np.sin(theta)

    cx_full, sx_full = cs(x)
    cy, sy = cs(y)
    cz, sz = cs(z)

    # forward x: X[k] = sum_n x[n] e^{-2pi i k n / N} for k < kx
    fcx = cx_full[:, :kx]
    fsx = -sx_full[:, :kx]

    # inverse x from half spectrum with doubling weights:
    # out[n] = (1/N) sum_k w_k (re_k cos - im_k sin), w_0 = w_{N/2} = 1
    w = np.full(kx, 2.0)
    w[0] = 1.0
    if x % 2 == 0:
        w[-1] = 1.0
    bcx = (w[:, None] * cx_full[:kx, :]) / x
    bsx = (w[:, None] * sx_full[:kx, :]) / x

    f32 = lambda a: jnp.asarray(a, dtype)
    return DFTPlan(
        fcx=f32(fcx), fsx=f32(fsx),
        cy=f32(cy), sy=f32(sy), cz=f32(cz), sz=f32(sz),
        bcx=f32(bcx), bsx=f32(bsx), shape=(z, y, x),
    )


# ---------------------------------------------------------------------------
# Full-complex per-axis machinery (long-axis mode)
# ---------------------------------------------------------------------------


def _reshape_axis(a, pos: int, new_dims):
    """Replace the axis at position `pos` from the END with `new_dims`."""
    idx = a.ndim - pos
    return a.reshape(a.shape[:idx] + tuple(new_dims) + a.shape[idx + 1 :])


def _merge_axis_pair(a, pos: int, n: int):
    """Merge the two adjacent axes ending at position `pos` from the END
    (i.e. axes at indices ndim-pos-1 and ndim-pos) into one of size n."""
    idx = a.ndim - pos - 1
    return a.reshape(a.shape[:idx] + (n,) + a.shape[idx + 2 :])


def _axis_fwd(re, im, ap: AxisPlan, pos: int):
    """Forward DFT along the axis `pos` counted from the end (1 = last).
    `im is None` marks real input (first transformed axis)."""
    tail = "ab"[: pos - 1]
    if ap.kind == "dense":
        spec = f"...m{tail},mp->...p{tail}"
        nre = _EINSUM(spec, re, ap.cm)
        nim = -_EINSUM(spec, re, ap.sm)
        if im is not None:
            nre = nre + _EINSUM(spec, im, ap.sm)
            nim = nim + _EINSUM(spec, im, ap.cm)
        return nre, nim
    R, M = ap.r, ap.m
    # n = R*m + r: reshape axis N -> (M, R)
    re2 = _reshape_axis(re, pos, (M, R))
    im2 = None if im is None else _reshape_axis(im, pos, (M, R))
    spec1 = f"...mr{tail},mp->...rp{tail}"
    fre = _EINSUM(spec1, re2, ap.cm)
    fim = -_EINSUM(spec1, re2, ap.sm)
    if im2 is not None:
        fre = fre + _EINSUM(spec1, im2, ap.sm)
        fim = fim + _EINSUM(spec1, im2, ap.cm)
    # twiddle e^{-2 pi i r p / N}
    bshape = (R, M) + (1,) * (pos - 1)
    twc = ap.twc.reshape(bshape)
    tws = ap.tws.reshape(bshape)
    gre = fre * twc + fim * tws
    gim = fim * twc - fre * tws
    # R-point combine: X[q, p] = sum_r G[r, p] e^{-2 pi i r q / R}
    spec2 = f"...rp{tail},rq->...qp{tail}"
    xre = _EINSUM(spec2, gre, ap.oc) + _EINSUM(spec2, gim, ap.osn)
    xim = _EINSUM(spec2, gim, ap.oc) - _EINSUM(spec2, gre, ap.osn)
    # (q, p) -> k = q*M + p
    return (
        _merge_axis_pair(xre, pos, ap.n),
        _merge_axis_pair(xim, pos, ap.n),
    )


def _axis_inv(re, im, ap: AxisPlan, pos: int, real_out: bool = False):
    """Inverse DFT along axis `pos` from the end, scaling by 1/N.  With
    real_out, only the real plane of the result is produced."""
    tail = "ab"[: pos - 1]
    inv_n = 1.0 / ap.n
    if ap.kind == "dense":
        spec = f"...p{tail},pm->...m{tail}"
        nre = (_EINSUM(spec, re, ap.cm) - _EINSUM(spec, im, ap.sm)) * inv_n
        if real_out:
            return nre, None
        nim = (_EINSUM(spec, im, ap.cm) + _EINSUM(spec, re, ap.sm)) * inv_n
        return nre, nim
    R, M = ap.r, ap.m
    # k -> (q, p)
    re2 = _reshape_axis(re, pos, (R, M))
    im2 = _reshape_axis(im, pos, (R, M))
    # combine over q with e^{+2 pi i r q / R}
    spec2 = f"...qp{tail},qr->...rp{tail}"
    hre = _EINSUM(spec2, re2, ap.oc) - _EINSUM(spec2, im2, ap.osn)
    him = _EINSUM(spec2, im2, ap.oc) + _EINSUM(spec2, re2, ap.osn)
    # conjugate twiddle e^{+2 pi i r p / N}
    bshape = (R, M) + (1,) * (pos - 1)
    twc = ap.twc.reshape(bshape)
    tws = ap.tws.reshape(bshape)
    gre = hre * twc - him * tws
    gim = him * twc + hre * tws
    # M-point inverse over p, emitting (m, r) so the flatten is n = R*m + r
    spec1 = f"...rp{tail},pm->...mr{tail}"
    nre = (_EINSUM(spec1, gre, ap.cm) - _EINSUM(spec1, gim, ap.sm)) * inv_n
    nre = _merge_axis_pair(nre, pos, ap.n)
    if real_out:
        return nre, None
    nim = (_EINSUM(spec1, gim, ap.cm) + _EINSUM(spec1, gre, ap.sm)) * inv_n
    return nre, _merge_axis_pair(nim, pos, ap.n)


def _dft3_full(x: jnp.ndarray, plan: FullDFTPlan):
    azp, ayp, axp = plan.axes
    re, im = _axis_fwd(x, None, axp, 1)  # x (real input)
    re, im = _axis_fwd(re, im, ayp, 2)  # y
    re, im = _axis_fwd(re, im, azp, 3)  # z
    return re, im


def _idft3_full(re, im, plan: FullDFTPlan):
    azp, ayp, axp = plan.axes
    re, im = _axis_inv(re, im, azp, 3)
    re, im = _axis_inv(re, im, ayp, 2)
    out, _ = _axis_inv(re, im, axp, 1, real_out=True)
    return out


def dft3(x: jnp.ndarray, plan) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward 3D real DFT over trailing (z, y, x) axes -> (re, im).

    Compact plans emit the hermitian-halved rfftn layout (last axis
    x//2+1); FullDFTPlan (any axis > _DENSE_LIMIT) emits the full
    spectrum."""
    if isinstance(plan, FullDFTPlan):
        return _dft3_full(x, plan)
    # x axis (real input): re/im = x @ [cos, -sin]
    re = _EINSUM("...zyx,xk->...zyk", x, plan.fcx)
    im = _EINSUM("...zyx,xk->...zyk", x, plan.fsx)
    # y axis: (C - iS)(re + i im)
    re, im = (
        _EINSUM("...zyk,ym->...zmk", re, plan.cy)
        + _EINSUM("...zyk,ym->...zmk", im, plan.sy),
        _EINSUM("...zyk,ym->...zmk", im, plan.cy)
        - _EINSUM("...zyk,ym->...zmk", re, plan.sy),
    )
    # z axis
    re, im = (
        _EINSUM("...zmk,zn->...nmk", re, plan.cz)
        + _EINSUM("...zmk,zn->...nmk", im, plan.sz),
        _EINSUM("...zmk,zn->...nmk", im, plan.cz)
        - _EINSUM("...zmk,zn->...nmk", re, plan.sz),
    )
    return re, im


def idft3(re: jnp.ndarray, im: jnp.ndarray, plan) -> jnp.ndarray:
    """Inverse of :func:`dft3`, returning the real volume directly."""
    if isinstance(plan, FullDFTPlan):
        return _idft3_full(re, im, plan)
    z, y, _ = plan.shape
    # z axis: (C + iS)/N
    re, im = (
        (
            _EINSUM("...nmk,nz->...zmk", re, plan.cz)
            - _EINSUM("...nmk,nz->...zmk", im, plan.sz)
        )
        / z,
        (
            _EINSUM("...nmk,nz->...zmk", im, plan.cz)
            + _EINSUM("...nmk,nz->...zmk", re, plan.sz)
        )
        / z,
    )
    # y axis
    re, im = (
        (
            _EINSUM("...zmk,my->...zyk", re, plan.cy)
            - _EINSUM("...zmk,my->...zyk", im, plan.sy)
        )
        / y,
        (
            _EINSUM("...zmk,my->...zyk", im, plan.cy)
            + _EINSUM("...zmk,my->...zyk", re, plan.sy)
        )
        / y,
    )
    # x axis: hermitian-weighted real reconstruction
    return _EINSUM("...zyk,kx->...zyx", re, plan.bcx) - _EINSUM(
        "...zyk,kx->...zyx", im, plan.bsx
    )


def kernel_spectrum_split(
    kernel: jnp.ndarray, shape: Tuple[int, int, int]
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Wrapped kernel spectrum as an (re, im) pair in the dft3 layout."""
    from .wrap import wrap_kernel

    plan = make_plan(tuple(int(s) for s in shape))
    wrapped = wrap_kernel(jnp.asarray(kernel, jnp.float32), shape)
    return dft3(wrapped, plan)


def _axis_fwd_c(u, ap: AxisPlan, pos: int):
    """Complex-valued forward DFT along axis `pos` from the end."""
    tail = "ab"[: pos - 1]
    if ap.kind == "dense":
        f = jax.lax.complex(ap.cm, -ap.sm)
        return _EINSUM(f"...m{tail},mp->...p{tail}", u, f)
    R, M = ap.r, ap.m
    u2 = _reshape_axis(u, pos, (M, R))
    fm = jax.lax.complex(ap.cm, -ap.sm)
    g = _EINSUM(f"...mr{tail},mp->...rp{tail}", u2, fm)
    tw = jax.lax.complex(ap.twc, -ap.tws).reshape((R, M) + (1,) * (pos - 1))
    g = g * tw
    o = jax.lax.complex(ap.oc, -ap.osn)
    g = _EINSUM(f"...rp{tail},rq->...qp{tail}", g, o)
    return _merge_axis_pair(g, pos, ap.n)


def _axis_inv_c(u, ap: AxisPlan, pos: int):
    """Complex-valued inverse DFT along axis `pos` from the end (1/N folded)."""
    tail = "ab"[: pos - 1]
    inv_n = 1.0 / ap.n
    if ap.kind == "dense":
        f = jax.lax.complex(ap.cm, ap.sm)
        return _EINSUM(f"...p{tail},pm->...m{tail}", u, f) * inv_n
    R, M = ap.r, ap.m
    u2 = _reshape_axis(u, pos, (R, M))
    o = jax.lax.complex(ap.oc, ap.osn)
    g = _EINSUM(f"...qp{tail},qr->...rp{tail}", u2, o)
    tw = jax.lax.complex(ap.twc, ap.tws).reshape((R, M) + (1,) * (pos - 1))
    g = g * tw
    fm = jax.lax.complex(ap.cm, ap.sm)
    g = _EINSUM(f"...rp{tail},pm->...mr{tail}", g, fm)
    return _merge_axis_pair(g, pos, ap.n) * inv_n


@functools.lru_cache(maxsize=256)
def _cached_axis_plan(n: int) -> AxisPlan:
    """AxisPlan for a full-complex stage inside the compact convolve.

    Compact stages stay DENSE (n <= _DENSE_LIMIT never splits): the (M, R)
    reshapes of a split force physical transposes in the k-last layout.
    The split exists only in FullDFTPlan (axes > 256), where dense is
    infeasible."""
    with jax.ensure_compile_time_eval():
        return _axis_plan(n, jnp.float32)


def _dft_convolve_complex(x: jnp.ndarray, k_re, k_im, plan: DFTPlan):
    """Compact-plan convolve with complex64 y/z stages: XLA's complex
    matmul reads each operand once per stage, and the y/z stages go
    through the generic dense axis machinery."""
    z, y, _ = plan.shape
    ayp = _cached_axis_plan(y)
    azp = _cached_axis_plan(z)
    re = _EINSUM("...zyx,xk->...zyk", x, plan.fcx)
    im = _EINSUM("...zyx,xk->...zyk", x, plan.fsx)
    u = jax.lax.complex(re, im)
    u = _axis_fwd_c(u, ayp, 2)
    u = _axis_fwd_c(u, azp, 3)
    u = u * jax.lax.complex(k_re, k_im)
    u = _axis_inv_c(u, azp, 3)
    u = _axis_inv_c(u, ayp, 2)
    return _EINSUM("...zyk,kx->...zyx", jnp.real(u), plan.bcx) - _EINSUM(
        "...zyk,kx->...zyx", jnp.imag(u), plan.bsx
    )


def dft_convolve_spectrum(
    x: jnp.ndarray, k_re: jnp.ndarray, k_im: jnp.ndarray
) -> jnp.ndarray:
    """Circular convolution with a pre-forwarded split spectrum — the
    dense-DFT counterpart of core.convolve.convolve_spectrum (identical
    math)."""
    plan = make_plan(tuple(int(s) for s in x.shape[-3:]))
    if isinstance(plan, DFTPlan):
        return _dft_convolve_complex(x, k_re, k_im, plan)
    # long-axis plans keep split re/im stages: promoting the real input to
    # complex64 doubles the bytes of the first stage
    re, im = dft3(x, plan)
    pre = re * k_re - im * k_im
    pim = re * k_im + im * k_re
    return idft3(pre, pim, plan)
