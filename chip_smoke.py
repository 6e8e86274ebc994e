#!/usr/bin/env python
"""Chip smoke check: drive the deconvolution main path once on one GPU.

Runs in one process, at the sizes users run, through the entry points a
user calls, and checks every result against the float64 mirror of the
reference math (reference/numpy_ref.py).  Any failed phase ends the run
with a non-zero exit and no result line.

  0. device: card name and power limit, device kind and count, JAX
     version, compile-cache directory.
  1. compile check: every program below lowered and compiled at its real
     shape, with ``compiled.memory_analysis()``.
  2. 4-view 256^3 (bench synthetic: 21^3 kernel1, 25^3 kernel2, per-voxel
     weights, λ = 0.006, 2 iterations, sequential) through
     deconvolve_auto, deconvolve_jit (fft and dft) and prepare_workspace
     + deconvolve_prepared, each against the mirror.
  3. 4-view 512^3, 1 iteration through deconvolve_auto against the
     mirror; then bench.py's 512^3 form (adjoint kernel2, scalar weights),
     checked finite.
  4. the deployment size: 6 views of 300x1024x1024, per-voxel weights,
     separate kernel2, 2 iterations through deconvolve_auto; one
     rl_view_step at that size against the mirror.
  5. findings, printed and not gated: seconds per RL iteration by engine,
     the RL update's bandwidth against a plain copy, and the dense-DFT
     engine's transform error at 'high' and 'highest'.

``--chips 4`` runs only the mesh phase: 4-view 512^3 on a 2x2
('view','z') mesh (simultaneous order) and on a 1x4 z-only mesh
(sequential order) through deconvolve_sharded_jit, each against
deconvolve_jit in the same view order on one card.

Mirror gates (reference/oracle.py): relative L2 < 1e-3 and central-crop
rms / peak < 2e-4.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.

Run:  python chip_smoke.py            (one card)
      python chip_smoke.py --chips 4  (four cards, mesh phase only)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

LAM = 0.006
MIN_VALUE = 1e-4
KERNEL1 = (21, 21, 21)
KERNEL2 = (25, 25, 25)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------


def make_problem(num_views, shape, per_voxel_weights=True,
                 separate_kernel2=True, seed=0):
    """bench.py's synthetic: Gaussian kernel1 (sigma 2 + 0.5 v), kernel2 =
    flip(kernel1) zero-embedded into the larger kernel2 support (or
    kernel1 itself, for the adjoint form), gamma(2, 20) views made on the
    device one view at a time (a shape-2 gamma is the sum of two
    exponentials: -20 log(u1 u2)), weights 1/V (stacks or scalars).
    Returns (MultiViewData, psi0)."""
    import jax
    import jax.numpy as jnp

    from libmultiviewnative_jax.deconv.workspace import (
        MultiViewData,
        pad_kernel_to,
    )
    from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

    k1 = np.stack([
        gaussian_kernel(KERNEL1, 2.0 + 0.5 * v) for v in range(num_views)
    ])
    if separate_kernel2:
        k2 = np.stack([
            pad_kernel_to(np.flip(k).copy(), KERNEL2) for k in k1
        ])
    else:
        k2 = k1
    tiny = float(np.finfo(np.float32).tiny)
    gamma = jax.jit(
        lambda key: -20.0 * jnp.sum(jnp.log(jax.random.uniform(
            key, (2,) + tuple(shape), jnp.float32, minval=tiny, maxval=1.0
        )), axis=0)
    )
    keys = jax.random.split(jax.random.key(seed), num_views)
    views = jnp.stack([gamma(k) for k in keys])
    if per_voxel_weights:
        weights = jnp.full((num_views,) + tuple(shape), 1.0 / num_views,
                           jnp.float32)
    else:
        weights = jnp.full((num_views,), 1.0 / num_views, jnp.float32)
    data = MultiViewData(
        views=views, kernel1=jnp.asarray(k1), kernel2=jnp.asarray(k2),
        weights=weights,
    )
    psi0 = jnp.full(tuple(shape), jnp.mean(views), jnp.float32)
    return data, psi0


def mirror_deconvolve(data, psi0, num_iterations, adjoint_kernel2=False):
    """Float64 host mirror of the sequential RL run on ``data``."""
    from libmultiviewnative_jax.reference.numpy_ref import np_deconvolve

    shape = tuple(data.spatial_shape)
    V = data.num_views
    k1 = np.asarray(data.kernel1)
    k2 = (
        [np.flip(k) for k in k1] if adjoint_kernel2
        else list(np.asarray(data.kernel2))
    )
    w = np.asarray(data.weights)
    weights = [np.broadcast_to(w[v], shape) for v in range(V)]
    views = [np.asarray(data.views[v]) for v in range(V)]
    return np_deconvolve(
        np.asarray(psi0), views, list(k1), k2, weights, num_iterations,
        lam=LAM, min_value=MIN_VALUE,
    )


def gate(name, got, want) -> dict:
    """Compare against the mirror, print the errors, raise on a miss."""
    from libmultiviewnative_jax.reference.oracle import (
        MIRROR_CROP_RMS_MAX,
        MIRROR_REL_L2_MAX,
        mirror_errors,
    )

    got = np.asarray(got)
    errs = mirror_errors(got, want)
    log(
        f"  {name}: rel_l2 {errs['rel_l2']:.3e} (< {MIRROR_REL_L2_MAX:g}), "
        f"crop_rms/peak {errs['crop_rms']:.3e} (< {MIRROR_CROP_RMS_MAX:g})"
        f"  {'ok' if errs['ok'] else 'FAIL'}"
    )
    if not errs["ok"]:
        raise AssertionError(f"{name} misses the float64 mirror gates: {errs}")
    return errs


def check_finite(name, x) -> None:
    import jax.numpy as jnp

    if not bool(jnp.all(jnp.isfinite(x))):
        raise AssertionError(f"{name}: non-finite values in the result")
    log(f"  {name}: finite, shape {tuple(x.shape)}")


def compile_report(name, jitted, *args, **static) -> None:
    """Lower + compile ``jitted`` at the arguments' shapes and print the
    compiled program's memory analysis."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **static).compile()
    ma = compiled.memory_analysis()
    gib = lambda b: f"{b / 2**30:.3f} GiB"
    log(
        f"  {name}: compiled in {time.perf_counter() - t0:.1f} s; "
        f"arguments {gib(ma.argument_size_in_bytes)}, "
        f"outputs {gib(ma.output_size_in_bytes)}, "
        f"temporaries {gib(ma.temp_size_in_bytes)}, "
        f"aliased {gib(ma.alias_size_in_bytes)}"
    )


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_compile(shape256, shape512, deploy_shape, deploy_views):
    """Phase 1: compile every program of phases 2-4 at its real shape."""
    import jax
    import jax.numpy as jnp

    from libmultiviewnative_jax.deconv import rl
    from libmultiviewnative_jax.deconv.policy import resolve_algorithm
    from libmultiviewnative_jax.deconv.workspace import MultiViewData

    lam, mv = jnp.float32(LAM), jnp.float32(MIN_VALUE)

    def abstract_data(V, shape, per_voxel=True, separate=True):
        k2 = KERNEL2 if separate else KERNEL1
        return MultiViewData(
            views=_sds_of((V,) + shape),
            kernel1=_sds_of((V,) + KERNEL1),
            kernel2=_sds_of((V,) + k2),
            weights=_sds_of((V,) + shape if per_voxel else (V,)),
        )

    for V, shape, iters, per_voxel, separate, adjoint, label in (
        (4, shape256, 2, True, True, False, "4-view 256^3"),
        (4, shape512, 1, True, True, False, "4-view 512^3"),
        (4, shape512, 1, False, False, True, "4-view 512^3 adjoint/scalar"),
        (deploy_views, deploy_shape, 2, True, True, False, "deployment"),
    ):
        data = abstract_data(V, shape, per_voxel, separate)
        psi = _sds_of(shape)
        engines = ["auto"] + (["dft"] if shape == shape256 else [])
        for algorithm in engines:
            engine = resolve_algorithm(algorithm, shape)
            compile_report(
                f"deconvolve_jit {label} {algorithm}->{engine} x{iters}",
                rl._deconvolve_jit, psi, data, lam, mv,
                num_iterations=iters, view_order="sequential",
                algorithm=algorithm, adjoint_kernel2=adjoint,
            )
    # the prepared path's program takes the spectra as operands
    data = abstract_data(4, shape256)
    prepared = jax.eval_shape(
        lambda d: rl.prepare_workspace(d, shape256, algorithm="auto"), data
    )
    compile_report(
        f"deconvolve_prepared 4-view 256^3 {prepared.algorithm} x2",
        rl._deconvolve_prepared, _sds_of(shape256), data, prepared,
        lam, mv, num_iterations=2, view_order="sequential",
    )
    # one view step at the deployment size
    spec = _sds_of(
        deploy_shape[:2] + (deploy_shape[2] // 2 + 1,), jnp.complex64
    )
    compile_report(
        "rl_view_step deployment fft", _view_step_jit(),
        _sds_of(deploy_shape), _sds_of(deploy_shape), spec, spec,
        _sds_of(deploy_shape), lam, mv,
    )


def _sds_of(shape, dtype=None):
    import jax
    import jax.numpy as jnp

    return jax.ShapeDtypeStruct(tuple(shape), dtype or jnp.float32)


def _view_step_jit():
    import jax

    from libmultiviewnative_jax.deconv.rl import rl_view_step

    return jax.jit(rl_view_step)


def phase_256(shape):
    """Phase 2: every in-core driver at 4-view ``shape`` vs the mirror."""
    import jax.numpy as jnp

    from libmultiviewnative_jax.deconv.dispatch import deconvolve_auto
    from libmultiviewnative_jax.deconv.rl import (
        deconvolve_jit,
        deconvolve_prepared,
        prepare_workspace,
    )

    data, psi0 = make_problem(4, shape)
    t0 = time.perf_counter()
    want = mirror_deconvolve(data, psi0, 2)
    log(f"  float64 mirror: {time.perf_counter() - t0:.1f} s")
    kw = dict(num_iterations=2, lam=LAM, min_value=MIN_VALUE)
    gate("deconvolve_auto", deconvolve_auto(jnp.copy(psi0), data, **kw), want)
    for engine in ("fft", "dft"):
        # deconvolve_jit donates psi: hand it a copy
        got = deconvolve_jit(jnp.copy(psi0), data, algorithm=engine, **kw)
        gate(f"deconvolve_jit {engine}", got, want)
    prepared = prepare_workspace(data, shape, algorithm="auto")
    got = deconvolve_prepared(jnp.copy(psi0), data, prepared, **kw)
    gate(f"prepare_workspace+deconvolve_prepared ({prepared.algorithm})",
         got, want)


def phase_512(shape):
    """Phase 3: 4-view ``shape`` general form vs the mirror, then the
    bench's adjoint/scalar form, checked finite."""
    import jax.numpy as jnp

    from libmultiviewnative_jax.deconv.dispatch import deconvolve_auto
    from libmultiviewnative_jax.deconv.rl import deconvolve_jit

    data, psi0 = make_problem(4, shape, seed=1)
    got = deconvolve_auto(
        jnp.copy(psi0), data, 1, lam=LAM, min_value=MIN_VALUE
    )
    got = np.asarray(got)
    t0 = time.perf_counter()
    want = mirror_deconvolve(data, psi0, 1)
    log(f"  float64 mirror: {time.perf_counter() - t0:.1f} s")
    gate("deconvolve_auto per-voxel weights + kernel2", got, want)
    del data, psi0, got, want

    data, psi0 = make_problem(
        4, shape, per_voxel_weights=False, separate_kernel2=False, seed=2
    )
    out = deconvolve_jit(
        psi0, data, 1, lam=LAM, min_value=MIN_VALUE, algorithm="auto",
        adjoint_kernel2=True,
    )
    check_finite("bench form (adjoint kernel2, scalar weights)", out)


def phase_deployment(shape, num_views):
    """Phase 4: the deployment size through deconvolve_auto, plus one
    rl_view_step there against the mirror."""
    import jax
    import jax.numpy as jnp

    from libmultiviewnative_jax.deconv.dispatch import (
        deconvolve_auto,
        device_capacity_bytes,
        estimate_workspace_bytes,
    )
    from libmultiviewnative_jax.deconv.policy import resolve_algorithm
    from libmultiviewnative_jax.deconv.rl import prepare_spectra
    from libmultiviewnative_jax.reference.numpy_ref import (
        np_rfftn,
        np_rl_view_step,
        np_wrap_kernel,
    )

    data, psi0 = make_problem(num_views, shape, seed=3)
    dev = jax.devices()[0]
    est = estimate_workspace_bytes(data, "auto")
    cap = int(0.9 * device_capacity_bytes(dev))
    rung = "in-core" if est < cap else "off-core"
    log(
        f"  rung {rung} (estimate {est / 2**30:.2f} GiB, 0.9 x capacity "
        f"{cap / 2**30:.2f} GiB), engine {resolve_algorithm('auto', shape)}"
    )
    t0 = time.perf_counter()
    out = deconvolve_auto(
        jnp.copy(psi0), data, 2, lam=LAM, min_value=MIN_VALUE
    )
    out.block_until_ready()
    wall = time.perf_counter() - t0
    stats = dev.memory_stats() or {}
    log(
        f"  deconvolve_auto x2: {wall:.2f} s wall (compile included), "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 0) / 2**30:.2f} "
        f"GiB of bytes_limit {stats.get('bytes_limit', 0) / 2**30:.2f} GiB"
    )
    check_finite("deployment result", out)
    del out

    # one view step against the mirror
    v = 0
    k1h = prepare_spectra(data.kernel1[v:v + 1], shape)[0]
    k2h = prepare_spectra(data.kernel2[v:v + 1], shape)[0]
    step = _view_step_jit()
    got = np.asarray(step(
        psi0, data.views[v], k1h, k2h, data.weights[v],
        jnp.float32(LAM), jnp.float32(MIN_VALUE),
    ))
    del k1h, k2h
    t0 = time.perf_counter()
    want = np_rl_view_step(
        np.asarray(psi0, np.float64), np.asarray(data.views[v], np.float64),
        np_rfftn(np_wrap_kernel(np.asarray(data.kernel1[v]), shape)),
        np_rfftn(np_wrap_kernel(np.asarray(data.kernel2[v]), shape)),
        np.asarray(data.weights[v], np.float64), LAM, MIN_VALUE,
    )
    log(f"  float64 mirror view step: {time.perf_counter() - t0:.1f} s")
    gate("rl_view_step at the deployment size", got, want)


def seconds_per_iteration(run_n, lo=1, hi=3):
    """Two-point fit (t(hi) - t(lo)) / (hi - lo) of RL calls, each ended
    by block_until_ready — per-call kernel forwarding cancels."""
    import jax

    t = {}
    for n in (lo, hi):
        jax.block_until_ready(run_n(n))  # compile
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            jax.block_until_ready(run_n(n))
            best = min(best, time.perf_counter() - t0)
        t[n] = best
    return (t[hi] - t[lo]) / (hi - lo)


def _best_time(fn, reps=5):
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def phase_findings(shape256, shape512, direct_budget_s=120.0):
    """Phase 5 (not gated): engine ladder, update-vs-copy bandwidth,
    dense-DFT transform error by precision."""
    import jax
    import jax.numpy as jnp

    from libmultiviewnative_jax.core import dft
    from libmultiviewnative_jax.core.convolve import convolve_spectrum
    from libmultiviewnative_jax.core.fft import forward_kernel_spectrum
    from libmultiviewnative_jax.core.kernels import rl_update
    from libmultiviewnative_jax.deconv.rl import (
        deconvolve_jit,
        rl_view_step_direct,
    )
    from libmultiviewnative_jax.reference.numpy_ref import (
        np_convolve_spectrum,
        np_rfftn,
        np_wrap_kernel,
    )
    from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

    # -- seconds per RL iteration, by engine (4 views, per-voxel weights)
    for shape in (shape256, shape512):
        data, psi0 = make_problem(4, shape, seed=4)
        for engine in ("fft", "dft"):
            run = lambda n, e=engine: deconvolve_jit(
                psi0 + 0.0, data, n, lam=LAM, min_value=MIN_VALUE,
                algorithm=e,
            )
            s = seconds_per_iteration(run)
            log(f"  finding: {engine} {shape}: {s:.4f} s/iteration "
                f"({1.0 / s:.2f} it/s)")
        if shape == shape256:
            # direct: time one view step on a z-slab first, then the full
            # iteration only if the slab predicts it fits the budget
            slab = (max(shape[0] // 8, KERNEL2[0]),) + shape[1:]
            w_slab = jnp.full(slab, 0.25, jnp.float32)
            p_slab = jnp.full(slab, 40.0, jnp.float32)
            step = jax.jit(rl_view_step_direct)
            t_slab = _best_time(lambda: step(
                p_slab, p_slab, data.kernel1[0], data.kernel2[0], w_slab,
                jnp.float32(LAM), jnp.float32(MIN_VALUE),
            ), reps=2)
            predicted = 4 * t_slab * shape[0] / slab[0]
            log(f"  finding: direct view step on {slab}: {t_slab:.3f} s; "
                f"predicted {predicted:.2f} s/iteration at {shape}")
            if predicted <= direct_budget_s:
                run = lambda n: deconvolve_jit(
                    psi0 + 0.0, data, n, lam=LAM, min_value=MIN_VALUE,
                    algorithm="direct",
                )
                t1 = _best_time(lambda: run(1), reps=1)
                log(f"  finding: direct {shape}: {t1:.4f} s per 1-iteration "
                    "call (kernel preparation included)")
            else:
                log(f"  finding: direct {shape}: full size not run "
                    f"(predicted over {direct_budget_s:.0f} s)")
        del data, psi0

    # -- the RL update's bandwidth against a plain device copy, 512^3
    vol = jnp.full(shape512, 40.0, jnp.float32)
    integral = jnp.full(shape512, 1.01, jnp.float32)
    weights = jnp.full(shape512, 0.25, jnp.float32)
    upd = jax.jit(rl_update)
    t_upd = _best_time(lambda: upd(
        vol, integral, weights, jnp.float32(LAM), jnp.float32(MIN_VALUE)
    ))
    pair = jnp.stack([vol, integral])
    scale_copy = jax.jit(lambda x: x * 2.0)
    t_copy = _best_time(lambda: scale_copy(pair))
    nbytes = 4 * 4 * int(np.prod(shape512))  # 3 reads + 1 write, f32
    log(
        f"  finding: rl_update {shape512}: {t_upd * 1e3:.3f} ms "
        f"({nbytes / t_upd / 1e9:.1f} GB/s); copy of the same bytes "
        f"(2 volumes read, 2 written): {t_copy * 1e3:.3f} ms "
        f"({nbytes / t_copy / 1e9:.1f} GB/s); update/copy time "
        f"{t_upd / t_copy:.3f}"
    )
    del vol, integral, weights, pair

    # -- dense-DFT transform error at 'high' and 'highest' vs float64
    rng = np.random.default_rng(5)
    k = np.asarray(gaussian_kernel(KERNEL1, 2.0))
    for shape in (shape256, shape512):
        x = rng.gamma(2.0, 20.0, shape).astype(np.float32)
        want = np_convolve_spectrum(
            x.astype(np.float64), np_rfftn(np_wrap_kernel(k, shape))
        )
        norm = np.linalg.norm(want)
        for prec in ("highest", "high"):
            dft.set_matmul_precision(prec)
            try:
                kre, kim = dft.kernel_spectrum_split(jnp.asarray(k), shape)
                conv = jax.jit(dft.dft_convolve_spectrum)
                got = np.asarray(conv(jnp.asarray(x), kre, kim), np.float64)
            finally:
                dft.set_matmul_precision("highest")
            log(f"  finding: dft convolve {shape} precision={prec}: "
                f"rel L2 {np.linalg.norm(got - want) / norm:.3e}")
        k_hat = forward_kernel_spectrum(jnp.asarray(k), shape)
        got = np.asarray(
            jax.jit(convolve_spectrum)(jnp.asarray(x), k_hat), np.float64
        )
        log(f"  finding: fft convolve {shape}: rel L2 "
            f"{np.linalg.norm(got - want) / norm:.3e}")


def phase_mesh(shape, num_views=4):
    """``--chips 4``: the mesh rung against one card, both view orders."""
    import jax
    import jax.numpy as jnp

    from libmultiviewnative_jax.deconv.rl import deconvolve_jit
    from libmultiviewnative_jax.parallel.sharded import (
        deconvolve_sharded_jit,
        make_mesh,
        shard_workspace,
    )
    from libmultiviewnative_jax.reference.oracle import rms

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--chips 4 needs 4 devices, JAX has {len(devices)}")
    data, psi0 = make_problem(num_views, shape, seed=6)
    for vp, zp, order in ((2, 2, "simultaneous"), (1, 4, "sequential")):
        mesh = make_mesh(view_parallel=vp, z_parallel=zp,
                         devices=np.asarray(devices[:4]))
        want = np.asarray(deconvolve_jit(
            jnp.copy(psi0), data, 1, lam=LAM, min_value=MIN_VALUE,
            view_order=order, algorithm="fft",
        ))
        psi_s, data_s = shard_workspace(data, psi0, mesh)
        t0 = time.perf_counter()
        out = deconvolve_sharded_jit(
            psi_s, data_s, 1, mesh, lam=LAM, min_value=MIN_VALUE,
            algorithm="fft", view_order=order,
        )
        out.block_until_ready()
        wall = time.perf_counter() - t0
        placed = sorted({d.id for d in out.sharding.device_set})
        out = np.asarray(out)
        err = rms(out, want)
        rel = float(np.linalg.norm(out - want) / np.linalg.norm(want))
        log(
            f"  mesh {vp}x{zp} {order}: rms vs one card {err:.3e} (the "
            f"suite's bar at 16^3: 1e-5), rel L2 {rel:.3e} "
            f"(< {MESH_REL_L2_MAX:g}), result on devices {placed}, "
            f"{wall:.2f} s wall (compile included)"
        )
        if not np.all(np.isfinite(out)) or len(placed) != 4:
            raise AssertionError(f"mesh {vp}x{zp}: bad result placement")
        if rel > MESH_REL_L2_MAX:
            raise AssertionError(
                f"mesh {vp}x{zp} {order} differs from one card: rel {rel}"
            )


# Mesh vs one card, both in float32 on the same engine: only the
# transform extents differ (halo-extended blocks vs the whole volume).
MESH_REL_L2_MAX = 1e-5


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"chip_smoke.py needs a GPU; JAX's default device is "
            f"{dev.platform}", file=sys.stderr,
        )
        return 2

    from libmultiviewnative_jax.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    log("phase 0: device")
    log(f"  {card_line()}")
    log(f"  device_kind {dev.device_kind}, device count {len(jax.devices())}, "
        f"jax {jax.__version__}, compile cache {cache}")

    t_start = time.perf_counter()
    shape256, shape512 = (256, 256, 256), (512, 512, 512)
    deploy_shape, deploy_views = (300, 1024, 1024), 6
    if args.chips == 4:
        log("phase 6: mesh (4 cards)")
        phase_mesh(shape512)
    else:
        log("phase 1: compile check")
        phase_compile(shape256, shape512, deploy_shape, deploy_views)
        log("phase 2: 4-view 256^3 vs float64 mirror")
        phase_256(shape256)
        log("phase 3: 4-view 512^3 vs float64 mirror")
        phase_512(shape512)
        log("phase 4: deployment 6 x 300x1024x1024")
        phase_deployment(deploy_shape, deploy_views)
        log("phase 5: findings")
        phase_findings(shape256, shape512)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
