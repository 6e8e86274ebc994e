"""Execution-strategy dispatch: in-core / mesh-sharded / streamed.

Recast of the reference's GPU dispatch heuristic
(reference src/multiviewnative.cu:89-142): it chose all-on-device iff
``(4V+2)*stack + fft_workarea < 0.9*GMEM``, else PCIe streaming, else
refused.  Here the ladder is:

  1. fits on one device            -> deconvolve_jit (in-core)
  2. >1 device and fits per-shard  -> deconvolve_sharded over ('view','z')
  3. psi+spectra fit, views don't  -> deconvolve_interleaved (psi on
                                      device, views streamed — the
                                      reference's interleaved design point)
  4. otherwise                     -> deconvolve_streamed (host-resident)

The decision is logged under LMVN_TRACE like the reference's stdout notice
(multiviewnative.cu:120-124).
"""

from __future__ import annotations

import math
import warnings

import jax
import numpy as np

from ..core.shapes import halo_widths
from ..utils.trace import trace_print
from .policy import resolve_algorithm
from .rl import deconvolve_jit
from .streamed import deconvolve_streamed
from .workspace import MultiViewData


class DispatchDivergenceWarning(UserWarning):
    """A requested option cannot be honored on the selected execution rung
    and the delivered math differs from the request (e.g. a sequential
    view-order request served by the inherently simultaneous sharded rung)."""


def estimate_workspace_bytes(data: MultiViewData, algorithm: str = "fft") -> int:
    """Device-resident working set of the in-core RL program.

    Counts: stacked views+weights (2V), both kernel spectrum sets, and
    psi/integral/FFT temporaries (~8 volumes) — the analog of the
    reference's ``(4V+2)*stack + workarea`` arithmetic
    (src/multiviewnative.cu:97-114).

    Engine-aware: the fft engine and the compact dft plan store hermitian
    half-spectra (complex64 at (Z, Y, X/2+1) ~= one f32 volume per kernel
    per view), but the long-axis dft engine (any axis > 256, FullDFTPlan)
    keeps FULL split-complex spectra = 2 f32 volumes per kernel per view."""
    spatial = data.spatial_shape
    vol = 4 * math.prod(spatial)
    V = data.num_views
    return (2 * V) * vol + 2 * V * _spectrum_vols(algorithm, spatial) * vol + 8 * vol


def _spectrum_vols(algorithm: str, spatial) -> int:
    """f32 volumes one kernel spectrum of ``algorithm`` occupies."""
    algo = resolve_algorithm(algorithm, spatial)
    if algo == "direct":
        return 0  # kernels stay spatial (negligible vs volumes)
    if algo == "dft" and max(spatial) > 256:
        return 2  # FullDFTPlan: full spectrum, split re/im
    return 1


def estimate_interleaved_bytes(data: MultiViewData, algorithm: str = "auto") -> int:
    """Device working set of the interleaved rung (deconv.interleaved):
    psi + 3 temporaries + the current and prefetched view's chunk uploads
    (the cross-view kick) + both kernel-spectrum sets — views/weights
    stay host-resident and stream through in chunks."""
    spatial = data.spatial_shape
    vol = 4 * math.prod(spatial)
    algo = algorithm if algorithm in ("fft", "dft") else "auto"
    return (6 + 2 * data.num_views * _spectrum_vols(algo, spatial)) * vol


# Capacity assumed for the CPU backend, whose allocator reports no limit.
# It only makes the capacity ladder deterministic in CPU tests.
CPU_TEST_CAPACITY_BYTES = 16 * 1024**3


def device_capacity_bytes(device=None) -> int:
    """The device allocator's limit (``memory_stats()["bytes_limit"]``).

    On the CPU backend, which reports none, :data:`CPU_TEST_CAPACITY_BYTES`.
    An accelerator that reports no limit is an error: the capacity ladder
    must not guess how much memory a card has."""
    d = device or jax.devices()[0]
    stats = d.memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    if limit > 0:
        return limit
    if d.platform == "cpu":
        return CPU_TEST_CAPACITY_BYTES
    raise RuntimeError(
        f"{d.platform} device {d} reports no bytes_limit in memory_stats(); "
        "cannot size the dispatch ladder"
    )


def deconvolve_auto(
    psi,
    data: MultiViewData,
    num_iterations: int,
    lam: float = 0.0,
    min_value: float = 1e-4,
    algorithm: str = "auto",
    headroom: float = 0.9,
    chunk_z="auto",
    adjoint_kernel2: bool = False,
    view_order: str = "sequential",
    strict: bool = False,
):
    """Run RL with the best strategy for the problem size and device fleet.

    Option fidelity contract:
      * ``algorithm`` is forwarded to every rung (in-core, sharded,
        interleaved, streamed); the interleaved and sharded rungs run the
        spectral engines fft/dft only (an explicit 'direct' request skips
        the interleaved rung and diverges loudly to 'auto' on the mesh).
        'auto' resolves through :func:`policy.resolve_algorithm` on every
        rung, at the extent that rung transforms.
      * ``adjoint_kernel2``: the sharded/streamed rungs (which consume
        spatial kernels) receive a materialized flip(kernel1) in place of
        data.kernel2 — equivalent to the in-core conjugate-spectrum path
        (odd kernel dims enforced, matching the in-core guard).
      * view_order: a too-big SEQUENTIAL request first tries a z-only
        mesh, where the reference's exact view loop runs over z-sharded
        overlap-save convolves — parity math at scale, no divergence.
        Only when Z has no legal z-only factorization do the loud
        divergences apply: the view-sharded mesh rung is inherently
        simultaneous, the streamed rung inherently sequential.  A request
        the selected rung cannot honor raises ``ValueError`` when
        ``strict=True``, else emits a :class:`DispatchDivergenceWarning`
        and runs the rung's native order.
    """
    import jax.numpy as jnp

    est = estimate_workspace_bytes(data, algorithm)
    if adjoint_kernel2:
        # Engine-aware discount: the split-spectrum engine (dft beyond the
        # 256 dense limit) shares the re part between k1 and conj(k1) and
        # only re-materializes the negated im -> one f32 volume saved per
        # view.  The fft engine (and the compact dft plan) still
        # materializes a full conj(k1) half-spectrum per view, so assuming
        # a saving there would undercount by ~V*vol right at the capacity
        # boundary.
        if _spectrum_vols(algorithm, data.spatial_shape) == 2:
            est -= data.num_views * 4 * math.prod(data.spatial_shape)
        if any(int(d) % 2 == 0 for d in data.kernel1.shape[-3:]):
            raise ValueError(
                "adjoint_kernel2 requires odd kernel1 dims; got "
                f"{tuple(data.kernel1.shape[-3:])}"
            )
    cap = int(headroom * device_capacity_bytes())
    n_dev = jax.device_count()

    if view_order == "simultaneous":
        from .workspace import check_simultaneous_weights

        check_simultaneous_weights(data.weights)

    def diverge(msg: str):
        if strict:
            raise ValueError(msg + " (strict=True)")
        warnings.warn(msg, DispatchDivergenceWarning, stacklevel=3)

    if est < cap:
        trace_print(
            f"dispatch: in-core (est {est>>20} MiB < {cap>>20} MiB)"
        )
        return deconvolve_jit(
            psi, data, num_iterations=num_iterations, lam=lam,
            min_value=min_value, algorithm=algorithm,
            adjoint_kernel2=adjoint_kernel2, view_order=view_order,
        )

    def demote(rung: str, supported: tuple) -> str:
        """Each off-core rung runs its own per-shard/per-chunk engines; a
        requested engine the rung cannot honor (e.g. 'direct' where only
        spectral engines exist) diverges LOUDLY to the rung's 'auto'
        selection."""
        if algorithm in supported:
            return algorithm
        diverge(
            f"deconvolve_auto selected the {rung} rung, where "
            f"algorithm={algorithm!r} is not available — falling back to "
            "the rung's 'auto' engine selection."
        )
        return "auto"

    if adjoint_kernel2:
        # the remaining rungs consume spatial kernel2 stacks directly
        data = MultiViewData(
            views=data.views,
            kernel1=data.kernel1,
            kernel2=jnp.flip(data.kernel1, axis=(-3, -2, -1)),
            weights=data.weights,
        )

    mesh_engines = ("fft", "dft", "auto")
    if n_dev > 1 and view_order == "sequential" and est < cap * n_dev:
        # Reference-parity math at scale: a too-big SEQUENTIAL request
        # routes to a z-only mesh FIRST — the exact reference view loop
        # (src/multiviewnative.cpp:191-228) over z-sharded overlap-save
        # convolves, no divergence, no warning.  Only when no z-only
        # factorization exists does the request fall through to the
        # simultaneous mesh (loud divergence) or the sequential streaming
        # rungs.
        mesh = _pick_zonly_mesh(data, n_dev, algorithm, cap)
        if mesh is not None and algorithm in mesh_engines:
            from ..parallel.sharded import deconvolve_sharded_jit, shard_workspace

            trace_print(
                f"dispatch: sequential parity on z-only mesh "
                f"{dict(mesh.shape)} (est {est>>20} MiB over "
                f"{mesh.shape['z']} devices)"
            )
            psi_s, data_s = shard_workspace(data, psi, mesh)
            return deconvolve_sharded_jit(
                psi_s, data_s, num_iterations=num_iterations, mesh=mesh,
                lam=lam, min_value=min_value, algorithm=algorithm,
                view_order="sequential",
            )
        if mesh is not None:
            # an engine this rung cannot honor (e.g. 'direct') falls
            # THROUGH — the sequential streaming rungs below honor both
            # the view order and the engine, which beats demoting here
            trace_print(
                f"dispatch: z-only mesh cannot honor algorithm="
                f"{algorithm!r}; trying lower rungs"
            )
        else:
            trace_print(
                "dispatch: no z-only factorization for the sequential "
                "request"
            )

    if n_dev > 1 and est < cap * n_dev:
        mesh = _pick_mesh(data.num_views, data.spatial_shape[0], n_dev)
        if mesh is not None:
            from ..parallel.sharded import deconvolve_sharded_jit, shard_workspace

            if view_order == "sequential":
                diverge(
                    "deconvolve_auto selected the mesh-sharded rung, which "
                    "computes the SIMULTANEOUS view-order update — the "
                    "requested sequential (reference-parity) math will "
                    "differ.  Pass view_order='simultaneous' to opt in "
                    "silently, or strict=True to forbid."
                )
                # the delivered math is simultaneous either way, so the
                # unnormalized-weights audit must run here, EAGERLY — the
                # in-rung check is skipped under jit (tracer weights)
                from .workspace import check_simultaneous_weights

                check_simultaneous_weights(data.weights)
            trace_print(
                f"dispatch: sharded mesh {dict(mesh.shape)} "
                f"(est {est>>20} MiB over {n_dev} devices)"
            )
            psi_s, data_s = shard_workspace(data, psi, mesh)
            return deconvolve_sharded_jit(
                psi_s, data_s, num_iterations=num_iterations, mesh=mesh,
                lam=lam, min_value=min_value,
                algorithm=demote("mesh-sharded", mesh_engines),
            )
        trace_print("dispatch: no valid mesh factorization; streaming")

    views = [np.asarray(data.views[v]) for v in range(data.num_views)]
    k1 = [np.asarray(data.kernel1[v]) for v in range(data.num_views)]
    k2 = [np.asarray(data.kernel2[v]) for v in range(data.num_views)]

    est_il = estimate_interleaved_bytes(data, algorithm)
    if algorithm != "direct" and est_il < cap:
        # interleaved rung: psi device-resident, views streamed — the
        # reference's interleaved mode design point (sequential math, so a
        # simultaneous request diverges; fft/dft engines are honored)
        if view_order == "simultaneous":
            diverge(
                "deconvolve_auto selected the interleaved rung, which runs "
                "the SEQUENTIAL view order — the requested simultaneous "
                "math will differ."
            )
        trace_print(
            f"dispatch: interleaved (est {est_il>>20} MiB device-resident, "
            f"views streamed; in-core would need {est>>20} MiB)"
        )
        from .interleaved import deconvolve_interleaved

        ws_il = [
            np.asarray(data.weights[v]) for v in range(data.num_views)
        ]
        ck = 64 if chunk_z == "auto" else chunk_z
        return jnp.asarray(
            deconvolve_interleaved(
                np.asarray(psi), views, k1, k2, ws_il, num_iterations,
                lam=lam, min_value=min_value, chunk_z=ck,
                algorithm=algorithm,
            )
        )

    trace_print(f"dispatch: streamed (est {est>>20} MiB > {cap>>20} MiB)")
    if view_order == "simultaneous":
        diverge(
            "deconvolve_auto selected the streamed rung, which runs the "
            "SEQUENTIAL view order — the requested simultaneous math will "
            "differ."
        )
    ws = [
        np.asarray(jnp.broadcast_to(data.weights[v], data.spatial_shape))
        for v in range(data.num_views)
    ]
    return deconvolve_streamed(
        np.asarray(psi), views, k1, k2, ws, num_iterations, lam, min_value,
        chunk_z=chunk_z,
        algorithm=demote("streamed", ("fft", "dft", "direct", "auto")),
    )


def estimate_zonly_bytes_per_device(
    data: MultiViewData, zp: int, algorithm: str = "auto"
) -> int:
    """Per-device working set of the z-only mesh rung on ``zp`` devices.

    Each device holds its z-shard of psi, of every view and of every
    per-voxel weight stack, and — because the view loop runs whole on
    every device — BOTH kernel spectra of EVERY view at its
    halo-extended block extent, plus ~8 temporaries at that extent."""
    Z, Y, X = data.spatial_shape
    bz = Z // zp
    (lo1, _, _), (hi1, _, _) = halo_widths(data.kernel1.shape[-3:])
    (lo2, _, _), (hi2, _, _) = halo_widths(data.kernel2.shape[-3:])
    ext = (bz + max(lo1 + hi1, lo2 + hi2), Y, X)
    local = 4 * bz * Y * X
    ext_vol = 4 * math.prod(ext)
    V = data.num_views
    per_voxel_w = data.weights.ndim > 1
    return (
        (V * (1 + per_voxel_w) + 1) * local
        + 2 * V * _spectrum_vols(algorithm, ext) * ext_vol
        + 8 * ext_vol
    )


def _pick_zonly_mesh(data: MultiViewData, n_dev: int, algorithm: str, cap: int):
    """Largest z-only ('view'=1) mesh that divides Z, respects the PSF
    halo (Bz >= halo, the overlap-save legality bound), and whose
    per-device working set (:func:`estimate_zonly_bytes_per_device`) fits
    one device; None if none does."""
    from ..parallel.sharded import make_mesh

    Z = data.spatial_shape[0]
    (lo1, _, _), (hi1, _, _) = halo_widths(data.kernel1.shape[-3:])
    (lo2, _, _), (hi2, _, _) = halo_widths(data.kernel2.shape[-3:])
    halo = max(lo1, hi1, lo2, hi2, 1)
    for zp in range(n_dev, 1, -1):
        if Z % zp or (Z // zp) < halo:
            continue
        if estimate_zonly_bytes_per_device(data, zp, algorithm) >= cap:
            continue
        return make_mesh(
            view_parallel=1, z_parallel=zp,
            devices=np.asarray(jax.devices()[:zp]),
        )
    return None


def _pick_mesh(V: int, Z: int, n_dev: int):
    """Choose a ('view','z') factorization vp*zp == n_dev with V % vp == 0
    and Z % zp == 0; None if no factorization exists (caller streams)."""
    from ..parallel.sharded import make_mesh

    best = None
    for vp in range(1, n_dev + 1):
        if n_dev % vp:
            continue
        zp = n_dev // vp
        if V % vp == 0 and Z % zp == 0:
            # prefer more view-parallelism (cheapest collective pattern)
            if best is None or vp > best[0]:
                best = (vp, zp)
    if best is None:
        return None
    return make_mesh(view_parallel=best[0], z_parallel=best[1])
