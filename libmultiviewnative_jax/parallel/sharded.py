"""Mesh-sharded multi-view RL deconvolution (view axis × Z-block axis).

The distributed layer the reference does not have (SURVEY.md §2.5): instead
of its single-GPU stream/prefetch strategies, the volume and the view set
are laid out over a ``jax.sharding.Mesh``:

  * ``view`` axis — per-view convolve+quotient+adjoint-convolve is
    embarrassingly parallel; each device computes its views' updates and the
    weighted deltas are combined with one ``psum``.  (Simultaneous
    update rule — a documented divergence from the reference's sequential
    view loop, see deconv.rl.)
  * ``z`` axis — the volume is decomposed into Z blocks; convolutions run
    as overlap-save with ring halo exchange (parallel.halo), exact for the
    global circular boundary.

Everything is ``shard_map`` over a mesh + XLA collectives; the same program
runs on 1 device, four NVLink-joined GPUs, an 8-device virtual CPU mesh,
or several processes (``jax.distributed.initialize`` + the same Mesh).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.kernels import rl_update
from ..core.shapes import halo_widths
from ..deconv.workspace import MultiViewData
from ..deconv.policy import resolve_algorithm
from .halo import (
    convolve_zblock,
    convolve_zblock_dft,
    zblock_kernel_spectrum,
    zblock_kernel_spectrum_split,
)

shard_map = jax.shard_map


def make_mesh(
    view_parallel: int = 1, z_parallel: Optional[int] = None, devices=None
) -> Mesh:
    """Build a ('view', 'z') mesh over the available devices.

    The answer to the reference's device-memory dispatch heuristic
    (reference src/multiviewnative.cu:89-142): capacity comes from adding
    devices along 'z', throughput from 'view'.  The mesh follows the
    algorithm alone; devices are taken in ``jax.devices()`` order.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if z_parallel is None:
        z_parallel = devices.size // view_parallel
    if view_parallel * z_parallel != devices.size:
        raise ValueError(
            f"{view_parallel}x{z_parallel} mesh != {devices.size} devices"
        )
    return Mesh(devices.reshape(view_parallel, z_parallel), ("view", "z"))


def _local_view_sweep(
    psi, views, kernel1, kernel2, weights, lam, min_value, lo1, hi1, lo2, hi2,
    algorithm="fft",
):
    """One simultaneous RL sweep over this shard's views on z-blocks.

    psi: (Bz, Y, X) local block, replicated over 'view'.
    views/weights: (Vl, Bz, Y, X); kernel1/kernel2 are the PRE-FORWARDED
    spectra stacks at the halo-extended extent (hoisted out of the
    iteration loop by the caller — the in-core one-time spectra prep).
    ``algorithm``: 'fft' or 'dft' selects the convolve engine matching the
    spectrum representation.
    """
    local_spatial = psi.shape

    def one_view(view, k1h, k2h, w):
        if algorithm == "dft":
            integral = convolve_zblock_dft(psi, k1h, lo1, hi1, "z")
            integral = view * (1.0 / integral)
            integral = convolve_zblock_dft(integral, k2h, lo2, hi2, "z")
        else:
            integral = convolve_zblock(psi, k1h, lo1, hi1, "z")
            integral = view * (1.0 / integral)
            integral = convolve_zblock(integral, k2h, lo2, hi2, "z")
        return rl_update(psi, integral, w, lam, min_value)

    new = jax.vmap(one_view)(views, kernel1, kernel2, weights)
    delta = jnp.sum(new - psi[None], axis=0)
    # combine weighted deltas across the view axis of the mesh
    delta = lax.psum(delta, "view")
    return psi + delta


def _local_view_sweep_sequential(
    psi, views, kernel1, kernel2, weights, lam, min_value, lo1, hi1, lo2, hi2,
    algorithm="fft",
):
    """One SEQUENTIAL RL sweep over ALL views on this device's z-block —
    the reference's exact view loop (reference src/multiviewnative.cpp:191-228)
    at scale: the z-decomposition lives INSIDE each view step (overlap-save
    ring halo exchange, exact for the circular boundary), so each view
    reads the psi already updated by the previous view within the same
    sweep, bit-matching the parity contract.  Only legal on a z-only mesh
    (view axis == 1: every device holds every view's z-shard), enforced by
    the caller.

    The view loop is unrolled with constant-index slices, mirroring the
    in-core driver (deconv.rl)."""
    V = int(views.shape[0])
    for v in range(V):
        view, k1h, k2h, w = jax.tree_util.tree_map(
            lambda a: a[v], (views, kernel1, kernel2, weights)
        )
        if algorithm == "dft":
            integral = convolve_zblock_dft(psi, k1h, lo1, hi1, "z")
            integral = view * (1.0 / integral)
            integral = convolve_zblock_dft(integral, k2h, lo2, hi2, "z")
        else:
            integral = convolve_zblock(psi, k1h, lo1, hi1, "z")
            integral = view * (1.0 / integral)
            integral = convolve_zblock(integral, k2h, lo2, hi2, "z")
        psi = rl_update(psi, integral, w, lam, min_value)
    return psi


def deconvolve_sharded(
    psi: jnp.ndarray,
    data: MultiViewData,
    num_iterations: int,
    mesh: Mesh,
    lam: float = 0.0,
    min_value: float = 1e-4,
    algorithm: str = "fft",
    view_order: str = "simultaneous",
) -> jnp.ndarray:
    """Sharded RL deconvolution: views over mesh axis 'view', volume Z-blocks
    over mesh axis 'z'.  Returns psi with the same sharding it came in with.

    Requirements (checked): V divisible by the 'view' axis size, Z by the
    'z' axis size, and each Z block at least as large as the PSF halo.

    ``view_order``:
      * ``"simultaneous"`` (the rung's historical native order) — all view
        updates computed from the same psi, weighted deltas psum'd over
        'view'.  The documented divergence from the reference math; the
        only order a view-sharded mesh can compute.
      * ``"sequential"`` — the reference's EXACT view loop
        (reference src/multiviewnative.cpp:191-228) on a **z-only mesh**
        (view axis must be 1; raises otherwise): z-decomposition happens
        inside each view step via overlap-save halo exchange, which is
        exact for the circular boundary, so the parity math scales past
        one device's memory.

    ``algorithm`` 'auto' resolves through :func:`policy.resolve_algorithm`
    at the halo-extended block extent each device transforms.
    """
    vsize, zsize = mesh.shape["view"], mesh.shape["z"]
    if view_order not in ("simultaneous", "sequential"):
        raise ValueError(f"unknown view_order {view_order!r}")
    sequential = view_order == "sequential"
    if sequential and vsize != 1:
        raise ValueError(
            "view_order='sequential' (reference-parity math) requires a "
            f"z-only mesh (view axis == 1); got view axis {vsize}.  The "
            "sequential update chain cannot be computed with views "
            "sharded across devices."
        )
    if not sequential:
        from ..deconv.workspace import check_simultaneous_weights

        check_simultaneous_weights(data.weights)
    V = data.num_views
    Z = psi.shape[-3]
    if V % vsize:
        raise ValueError(f"{V} views not divisible by view axis {vsize}")
    if Z % zsize:
        raise ValueError(f"Z={Z} not divisible by z axis {zsize}")
    (lo1, _, _), (hi1, _, _) = halo_widths(data.kernel1.shape[-3:])
    (lo2, _, _), (hi2, _, _) = halo_widths(data.kernel2.shape[-3:])
    bz = Z // zsize
    if bz < max(lo1, hi1, lo2, hi2):
        raise ValueError(
            f"Z block {bz} smaller than PSF halo "
            f"{max(lo1, hi1, lo2, hi2)}; use fewer z shards"
        )
    if algorithm not in ("fft", "dft", "auto"):
        # a 'direct' (or typo'd) request must not silently become fft —
        # mirror the in-core driver's unknown-algorithm error
        raise ValueError(
            f"sharded rung supports algorithm 'fft'|'dft'|'auto', "
            f"got {algorithm!r}"
        )
    spatial = tuple(int(s) for s in psi.shape[-3:])
    local_spatial = (bz, spatial[1], spatial[2])
    ext = (bz + max(lo1 + hi1, lo2 + hi2), spatial[1], spatial[2])
    algo = resolve_algorithm(algorithm, ext)

    def step(psi_local, views, k1, k2, w):
        # forward every kernel ONCE, outside the iteration scan
        if algo == "dft":
            k1h = jax.vmap(
                lambda k: zblock_kernel_spectrum_split(k, local_spatial)
            )(k1)
            k2h = jax.vmap(
                lambda k: zblock_kernel_spectrum_split(k, local_spatial)
            )(k2)
        else:
            k1h = jax.vmap(lambda k: zblock_kernel_spectrum(k, local_spatial))(k1)
            k2h = jax.vmap(lambda k: zblock_kernel_spectrum(k, local_spatial))(k2)

        sweep_fn = (
            _local_view_sweep_sequential if sequential else _local_view_sweep
        )

        def sweep(p, _):
            p = sweep_fn(
                p, views, k1h, k2h, w, lam, min_value, lo1, hi1, lo2, hi2,
                algo,
            )
            return p, None

        out, _ = lax.scan(sweep, psi_local, None, length=num_iterations)
        return out

    views, weights = data.views, data.weights
    # On the sequential (z-only) mesh nothing is view-sharded — the view
    # dimension of every stack stays whole on each device, so the specs
    # drop the 'view' axis entirely (the view loop consumes all views in
    # reference order; a 'view'-sharded spec would also confuse the vma
    # validation, since no psum closes the sequential chain).
    vax = None if sequential else "view"
    w_spec = (
        P(vax)
        if weights.ndim == 1  # per-view scalar weights
        else P(vax, "z", None, None)
    )
    fn = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P("z", None, None),            # psi: z-blocked, replicated on view
            P(vax, "z", None, None),       # views
            P(vax, None, None, None),      # kernel1
            P(vax, None, None, None),      # kernel2
            w_spec,                        # weights (stacks or scalars)
        ),
        out_specs=P("z", None, None),
    )
    return fn(psi, views, data.kernel1, data.kernel2, weights)


def shard_workspace(
    data: MultiViewData, psi: jnp.ndarray, mesh: Mesh
) -> Tuple[jnp.ndarray, MultiViewData]:
    """Place psi and the stacked views onto the mesh with the layouts
    deconvolve_sharded expects."""
    s_psi = NamedSharding(mesh, P("z", None, None))
    s_vol = NamedSharding(mesh, P("view", "z", None, None))
    s_k = NamedSharding(mesh, P("view", None, None, None))
    s_w = NamedSharding(
        mesh, P("view") if data.weights.ndim == 1 else P("view", "z", None, None)
    )
    return (
        jax.device_put(psi, s_psi),
        MultiViewData(
            views=jax.device_put(data.views, s_vol),
            kernel1=jax.device_put(data.kernel1, s_k),
            kernel2=jax.device_put(data.kernel2, s_k),
            weights=jax.device_put(data.weights, s_w),
        ),
    )


@partial(
    jax.jit,
    static_argnames=("num_iterations", "mesh", "algorithm", "view_order"),
    donate_argnums=(0,),
)
def _deconvolve_sharded_jit(
    psi, data, lam, min_value, num_iterations, mesh, algorithm, view_order,
):
    return deconvolve_sharded(
        psi, data, num_iterations, mesh, lam, min_value, algorithm,
        view_order,
    )


def deconvolve_sharded_jit(
    psi,
    data,
    num_iterations: int,
    mesh: Mesh,
    lam: float = 0.0,
    min_value: float = 1e-4,
    algorithm: str = "fft",
    view_order: str = "simultaneous",
):
    """Jitted :func:`deconvolve_sharded` (psi donated).  λ/min_value are
    runtime operands (the scalars ride into shard_map as replicated
    closure constants): a λ sweep compiles once per shape, the same
    contract as the in-core drivers.  'auto' resolves inside, through the
    one engine policy, at the extent each device transforms."""
    return _deconvolve_sharded_jit(
        psi, data, jnp.float32(lam), jnp.float32(min_value),
        num_iterations, mesh, algorithm, view_order,
    )


deconvolve_sharded_jit._cache_size = _deconvolve_sharded_jit._cache_size
