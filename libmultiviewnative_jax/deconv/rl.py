"""Richardson-Lucy deconvolution drivers (single device).

Re-design of the reference's RL loops:
  * CPU driver  ``mvn::cpu::inplace_cpu_deconvolve``
    (reference src/multiviewnative.cpp:101-240)
  * GPU drivers ``inplace_gpu_deconvolve_iteration_{all_on_device,interleaved}``
    (reference src/gpu_deconvolve_methods.cuh:85-562)

One RL view step (reference lines src/multiviewnative.cpp:191-228):

    integral = psi (x) kernel1          # circular FFT convolve
    integral = view / integral          # compute_quotient
    integral = integral (x) kernel2     # circular FFT convolve
    psi      = w*(clamp(update) - psi) + psi

Instead of plan caches, streams, and pinned staging buffers, the whole
iteration is ONE traced XLA program: ``lax.scan`` over views (sequential —
required for parity, each view sees the psi updated by the previous view
within the same sweep) nested in ``lax.scan`` over iterations.  Kernel
spectra are precomputed batched over the view axis (the analog of
``generate_forwarded_kernels``, src/gpu_deconvolve_methods.cuh:28-65).

``view_order="simultaneous"`` is an opt-in, documented divergence: all view
updates are computed batched from the SAME psi and blended additively
(psi' = psi + sum_v w_v (new_v - psi)).  This is the Preibisch-style
efficient variant that makes the view axis shardable over a mesh
(see libmultiviewnative_jax.parallel).

λ and min_value are runtime operands of every jitted driver: a λ sweep
compiles once per shape, as the reference's plan store never re-plans
when λ changes (λ lives in the runtime workspace struct,
inc/multiviewnative.h:28-35; inc/plan_store.h:25-235).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.convolve import convolve_spectrum, direct_convolve3d
from ..core.dft import dft3, dft_convolve_spectrum, make_plan
from ..core.fft import rfft3
from ..core.kernels import rl_update
from ..core.wrap import wrap_kernel
from .policy import resolve_algorithm
from .workspace import MultiViewData, Workspace


def prepare_spectra(
    kernels: jnp.ndarray, spatial_shape: Tuple[int, ...]
) -> jnp.ndarray:
    """Wrap + forward-FFT a (V, kz, ky, kx) kernel stack, batched.

    The analog of the reference's per-view setup loop
    (src/multiviewnative.cpp:146-174) and of the GPU's pre-forwarded pinned
    kernels (src/gpu_deconvolve_methods.cuh:28-65) — but as one batched rfft.
    """
    wrapped = jax.vmap(lambda k: wrap_kernel(k, spatial_shape))(kernels)
    return rfft3(wrapped)


def rl_view_step(
    psi: jnp.ndarray,
    view: jnp.ndarray,
    k1_hat: jnp.ndarray,
    k2_hat: jnp.ndarray,
    weights: jnp.ndarray,
    lam: float,
    min_value: float,
) -> jnp.ndarray:
    """One view's multiplicative update (src/multiviewnative.cpp:191-228)."""
    integral = convolve_spectrum(psi, k1_hat)
    integral = view * (1.0 / integral)  # compute_quotient, inc/cpu_kernels.h:20-26
    integral = convolve_spectrum(integral, k2_hat)
    return rl_update(psi, integral, weights, lam, min_value)


def rl_view_step_dft(
    psi: jnp.ndarray,
    view: jnp.ndarray,
    k1_split: Tuple[jnp.ndarray, jnp.ndarray],
    k2_split: Tuple[jnp.ndarray, jnp.ndarray],
    weights: jnp.ndarray,
    lam: float,
    min_value: float,
) -> jnp.ndarray:
    """Same update with the dense-DFT engine (core.dft): the transforms
    are batched matmuls instead of FFT calls."""
    integral = dft_convolve_spectrum(psi, k1_split[0], k1_split[1])
    integral = view * (1.0 / integral)
    integral = dft_convolve_spectrum(integral, k2_split[0], k2_split[1])
    return rl_update(psi, integral, weights, lam, min_value)


def prepare_spectra_split(
    kernels: jnp.ndarray, spatial_shape: Tuple[int, ...]
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched wrapped-kernel spectra in the split (re, im) dft3 layout."""
    plan = make_plan(tuple(int(s) for s in spatial_shape))
    wrapped = jax.vmap(lambda k: wrap_kernel(k, spatial_shape))(kernels)
    return dft3(wrapped, plan)


def rl_view_step_direct(
    psi: jnp.ndarray,
    view: jnp.ndarray,
    kernel1: jnp.ndarray,
    kernel2: jnp.ndarray,
    weights: jnp.ndarray,
    lam: float,
    min_value: float,
) -> jnp.ndarray:
    """Same update with the direct stencil engine instead of FFTs.

    Kernels stay in the spatial domain; each convolve is a circular-boundary
    ``lax.conv`` — profitable when the PSF support is small (see
    core.convolve.direct_convolve3d).
    """
    integral = direct_convolve3d(psi, kernel1, mode="circular")
    integral = view * (1.0 / integral)
    integral = direct_convolve3d(integral, kernel2, mode="circular")
    return rl_update(psi, integral, weights, lam, min_value)


def _check_adjoint(kernel1) -> None:
    # The true adjoint kernel has center k-1-(k//2), which equals the
    # k//2 floor-center convention (inc/padd_utils.h:25-27) only for odd
    # dims — for spectral engines (conj identity) AND the direct engine
    # (flip + floor-center is off by one voxel on even axes) alike.
    if any(int(d) % 2 == 0 for d in kernel1.shape[-3:]):
        raise ValueError(
            "adjoint_kernel2 requires odd kernel1 dims; got "
            f"{tuple(kernel1.shape[-3:])}"
        )


def _forward_kernels(data: MultiViewData, spatial, algorithm, adjoint_kernel2):
    """(k1, k2) operands of ``algorithm``'s view step: spectra for the
    spectral engines, spatial kernels for 'direct'."""
    if algorithm == "fft":
        k1 = prepare_spectra(data.kernel1, spatial)
        k2 = jnp.conj(k1) if adjoint_kernel2 else prepare_spectra(
            data.kernel2, spatial
        )
    elif algorithm == "dft":
        k1 = prepare_spectra_split(data.kernel1, spatial)
        k2 = (
            (k1[0], -k1[1])
            if adjoint_kernel2
            else prepare_spectra_split(data.kernel2, spatial)
        )
    elif algorithm == "direct":
        k1 = data.kernel1
        k2 = (
            jnp.flip(data.kernel1, axis=(-3, -2, -1))
            if adjoint_kernel2
            else data.kernel2
        )
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return k1, k2


_STEPS = {"fft": rl_view_step, "dft": rl_view_step_dft, "direct": rl_view_step_direct}


def deconvolve(
    psi: jnp.ndarray,
    data: MultiViewData,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
    algorithm: str = "fft",
    adjoint_kernel2: bool = False,
    track_convergence: bool = False,
    prepared: "PreparedSpectra" = None,
) -> jnp.ndarray:
    """Run ``num_iterations`` RL sweeps over all views.

    Parity mode (``view_order="sequential"``) reproduces the reference's
    view-by-view update order exactly (src/multiviewnative.cpp:191-228).
    ``num_iterations``, ``view_order`` and ``algorithm`` are trace-time
    constants; ``lam``/``min_value`` may be traced scalars.

    ``adjoint_kernel2=True`` declares kernel2 == flip(kernel1) (the plain
    per-view RL adjoint): kernel2 spectra are then the CONJUGATE of the
    kernel1 spectra — data.kernel2 is ignored, halving kernel-spectrum
    memory and kernel FFT work.  Weights may be full per-voxel stacks
    (V, Z, Y, X) or per-view scalars (V,) — the uniform-blending case costs
    no device memory.

    ``prepared`` (a :class:`PreparedSpectra` from
    :func:`prepare_workspace`) skips the per-call kernel forwarding and
    selects that store's engine — the serving path shares the WHOLE
    driver (view orders, convergence tracking) with the per-call path;
    ``algorithm``/``adjoint_kernel2`` are then ignored (both were fixed at
    prepare time).
    """
    spatial = tuple(psi.shape[-3:])
    if prepared is not None:
        if tuple(prepared.spatial) != spatial:
            raise ValueError(
                f"prepared spectra are for {prepared.spatial}, psi is "
                f"{spatial}"
            )
        algorithm = prepared.algorithm
        k1, k2 = prepared.k1, prepared.k2
    else:
        if adjoint_kernel2:
            _check_adjoint(data.kernel1)
        algorithm = resolve_algorithm(algorithm, spatial)
        k1, k2 = _forward_kernels(data, spatial, algorithm, adjoint_kernel2)
    step = _STEPS[algorithm]
    views, weights = data.views, data.weights

    if view_order == "sequential":
        num_views = int(views.shape[0])

        def sweep(p, _):
            # The view loop is UNROLLED with constant-index slices: a
            # lax.scan over the stacked views/spectra dynamic-slices its
            # xs every step, materializing a copy of each view's spectra
            # and images per view step; constant-index slices fold into
            # buffer offsets.  V is small (the reference's workspace is a
            # handful of views, multiviewnative.h:71-77), so program size
            # stays modest.
            for v in range(num_views):
                view, k1v, k2v, w = jax.tree_util.tree_map(
                    lambda a: a[v], (views, k1, k2, weights)
                )
                p = step(p, view, k1v, k2v, w, lam, min_value)
            return p, None

    elif view_order == "simultaneous":
        # eager callers get the unnormalized-weights audit here; jitted
        # callers (tracer weights) are covered at the dispatch/model layer
        from .workspace import check_simultaneous_weights

        check_simultaneous_weights(data.weights)

        def sweep(p, _):
            new = jax.vmap(
                lambda v, a, b, w: step(p, v, a, b, w, lam, min_value)
            )(views, k1, k2, weights)
            # additive blend of per-view weighted updates; for weights that
            # sum to 1 across views this is the natural batched counterpart
            # of the sequential w*(new-old)+old.  Documented divergence from
            # the reference's sequential math.
            p = p + jnp.sum(new - p[None], axis=0)
            return p, None

    else:
        raise ValueError(f"unknown view_order {view_order!r}")

    if track_convergence:

        def sweep_tracked(p, _):
            nxt, _unused = sweep(p, None)
            return nxt, jnp.sqrt(jnp.mean((nxt - p) ** 2))

        return lax.scan(sweep_tracked, psi, None, length=num_iterations)

    out, _ = lax.scan(sweep, psi, None, length=num_iterations)
    return out


@partial(
    jax.jit,
    static_argnames=(
        "num_iterations", "view_order", "algorithm", "adjoint_kernel2",
    ),
    donate_argnums=(0,),
)
def _deconvolve_jit(
    psi, data, lam, min_value, num_iterations, view_order, algorithm,
    adjoint_kernel2,
):
    return deconvolve(
        psi, data, num_iterations, lam, min_value, view_order, algorithm,
        adjoint_kernel2,
    )


def deconvolve_jit(
    psi: jnp.ndarray,
    data: MultiViewData,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
    algorithm: str = "fft",
    adjoint_kernel2: bool = False,
) -> jnp.ndarray:
    """Jitted :func:`deconvolve`; psi is donated (the in-place semantics of
    the C ABI's mutate-psi contract, inc/multiviewnative.h:43-55).

    λ/min_value are runtime operands: a λ sweep compiles once per shape."""
    return _deconvolve_jit(
        psi, data, jnp.float32(lam), jnp.float32(min_value),
        num_iterations, view_order, algorithm, adjoint_kernel2,
    )


deconvolve_jit._cache_size = _deconvolve_jit._cache_size


@partial(
    jax.jit,
    static_argnames=(
        "num_iterations", "view_order", "algorithm", "adjoint_kernel2",
    ),
)
def _deconvolve_with_history(
    psi, data, lam, min_value, num_iterations, view_order, algorithm,
    adjoint_kernel2,
):
    return deconvolve(
        psi, data, num_iterations, lam, min_value, view_order, algorithm,
        adjoint_kernel2, track_convergence=True,
    )


def deconvolve_with_history(
    psi: jnp.ndarray,
    data: MultiViewData,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
    algorithm: str = "fft",
    adjoint_kernel2: bool = False,
):
    """Like :func:`deconvolve` but also returns the per-sweep update norms
    ``sqrt(mean((psi_i - psi_{i-1})^2))`` — the convergence monitor users
    build externally around the reference's psi_i snapshots
    (tests/tiff_fixtures.hpp:453-462), computed in-graph for free.

    λ/min_value are runtime operands (a convergence-monitored λ-tuning
    sweep compiles once, the same contract as :func:`deconvolve_jit`).

    Returns (psi, deltas) with deltas shaped (num_iterations,).
    """
    return _deconvolve_with_history(
        psi, data, jnp.float32(lam), jnp.float32(min_value),
        num_iterations, view_order, algorithm, adjoint_kernel2,
    )


deconvolve_with_history._cache_size = _deconvolve_with_history._cache_size


@jax.tree_util.register_pytree_node_class
class PreparedSpectra:
    """Pre-forwarded kernel spectra bound to an (algorithm, shape) pair.

    The serving-path plan store: the reference re-runs its kernel-FFT setup
    on every ``inplace_cpu_deconvolve`` call (src/multiviewnative.cpp:146-174);
    preparing once and reusing across calls removes that cost for repeated
    deconvolutions with fixed PSFs (time-lapse processing)."""

    def __init__(self, algorithm: str, spatial, k1, k2):
        self.algorithm = algorithm
        self.spatial = tuple(spatial)
        self.k1 = k1
        self.k2 = k2

    def tree_flatten(self):
        return (self.k1, self.k2), (self.algorithm, self.spatial)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], *children)


def prepare_workspace(
    data: MultiViewData,
    spatial_shape,
    algorithm: str = "auto",
    adjoint_kernel2: bool = False,
) -> PreparedSpectra:
    """Forward the kernel stacks once for reuse by :func:`deconvolve_prepared`.

    'auto' resolves through the same policy as :func:`deconvolve`, so a
    prepared time-lapse pipeline reuses the production engine's spectra
    (the reference's plan_store covers every transform path,
    inc/plan_store.h:25-235)."""
    spatial = tuple(int(s) for s in spatial_shape)
    if adjoint_kernel2:
        _check_adjoint(data.kernel1)
    algorithm = resolve_algorithm(algorithm, spatial)
    if algorithm not in ("fft", "dft"):
        raise ValueError(
            f"prepare_workspace supports fft/dft, not {algorithm!r}"
        )
    k1, k2 = _forward_kernels(data, spatial, algorithm, adjoint_kernel2)
    return PreparedSpectra(algorithm, spatial, k1, k2)


@partial(jax.jit, static_argnames=("num_iterations", "view_order"),
         donate_argnums=(0,))
def _deconvolve_prepared(
    psi, data, prepared, lam, min_value, num_iterations, view_order,
):
    return deconvolve(
        psi, data, num_iterations, lam, min_value, view_order,
        prepared=prepared,
    )


def deconvolve_prepared(
    psi: jnp.ndarray,
    data: MultiViewData,
    prepared: PreparedSpectra,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    view_order: str = "sequential",
) -> jnp.ndarray:
    """RL using pre-forwarded spectra (no per-call kernel FFTs) — the
    time-lapse serving path.  Shares the WHOLE :func:`deconvolve` driver
    (both view orders), so its contract matches :func:`deconvolve_jit`
    minus the prepare-time options (``algorithm``/``adjoint_kernel2`` were
    fixed by :func:`prepare_workspace`).  psi is donated.

    ``lam``/``min_value`` are runtime operands: a λ sweep — the prepared
    path's core use case — compiles ONCE per shape."""
    return _deconvolve_prepared(
        psi, data, prepared, jnp.float32(lam), jnp.float32(min_value),
        num_iterations, view_order,
    )


deconvolve_prepared._cache_size = _deconvolve_prepared._cache_size


def deconvolve_workspace(psi: jnp.ndarray, ws: Workspace, **kw) -> jnp.ndarray:
    """Convenience wrapper taking a :class:`Workspace` (the C-ABI shape)."""
    return deconvolve_jit(
        psi,
        ws.data,
        num_iterations=ws.num_iterations,
        lam=ws.lambda_,
        min_value=ws.min_value,
        **kw,
    )
