#!/usr/bin/env python
"""Headline benchmark: multi-view RL deconvolution throughput on a GPU.

Prints one JSON line per tracked config (headline FIRST):
  {"metric": ..., "value": N, "unit": "iterations/s", "slope": N,
   "platform": "gpu", "device_kind": ..., "device_count": N,
   "power_limit": ...}

Workloads (kernel/iteration defaults from the reference synthetic bench,
reference bench/bench_cpu_deconvolve_synthetic.cpp:55-71):
  1. headline — 4 views at 256^3, 21^3/25^3 Gaussian kernels, per-voxel
     weights, 10 RL iterations, algorithm='auto'.
  1b. headline_prepared — the same workload through prepare_workspace +
     deconvolve_prepared (the time-lapse serving contract: kernel
     spectra forwarded once, reused across calls).
  2. 4 views at 512^3 with adjoint kernel2 and per-view scalar weights,
     10 RL iterations, algorithm='auto'.

``value`` is iterations/s of whole 10-iteration calls (per-call kernel
forwarding included); ``slope`` is the step-level rate from a two-point
fit in the iteration count, in which per-call constants cancel.  Every
call is timed to ``block_until_ready``.  The library runs at its default
'highest' matmul precision.

Refuses (exit 2, no JSON line) when JAX finds no GPU; exits non-zero when
a config fails.
"""

import json
import subprocess
import sys
import time

import numpy as np


def card_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def _emit(metric, iters_per_sec, slope, device):
    row = {
        "metric": metric,
        "value": iters_per_sec,
        "unit": "iterations/s",
        "slope": slope,
    }
    row.update(device)
    print(json.dumps(row), flush=True)


def _time_config(run, iters, reps, passes=2):
    """Best-of-passes mean time of ``reps`` back-to-back calls, each ended
    by ``block_until_ready``; returns iterations/s."""
    import jax

    jax.block_until_ready(run())  # warmup/compile
    dt = float("inf")
    for _pass in range(passes):
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(run())
        dt = min(dt, (time.perf_counter() - t0) / reps)
    return iters / dt


def _slope_config(run_n, iters, passes=2):
    """Step-level slope: time the same program at n/3 and n iterations
    and fit (n - n/3) / (t_n - t_{n/3}) — per-call constants (kernel
    forwarding, dispatch) cancel in the difference.  The larger point is
    the headline config itself, so the slope never runs a bigger program
    than the one being timed."""
    import jax

    lo = max(1, iters // 3)
    if lo >= iters:
        return None
    t = {}
    for n in (lo, iters):
        jax.block_until_ready(run_n(n))  # warmup/compile
        best = float("inf")
        for _ in range(passes):
            t0 = time.perf_counter()
            jax.block_until_ready(run_n(n))
            best = min(best, time.perf_counter() - t0)
        t[n] = best
    dt = t[iters] - t[lo]
    return (iters - lo) / dt if dt > 0 else None


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"bench.py measures a GPU; JAX's default device is "
            f"{dev.platform}", file=sys.stderr,
        )
        return 2

    from libmultiviewnative_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from libmultiviewnative_jax.deconv.rl import (
        deconvolve_jit,
        deconvolve_prepared,
        prepare_workspace,
    )
    from libmultiviewnative_jax.deconv.workspace import (
        MultiViewData,
        pad_kernel_to,
    )
    from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

    device = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "power_limit": card_power_limit(),
    }

    V = 4
    iters = 10
    rng = np.random.default_rng(0)
    k1 = np.stack([gaussian_kernel((21,) * 3, 2.0 + 0.5 * v) for v in range(V)])
    k2 = np.stack(
        [
            pad_kernel_to(
                np.flip(gaussian_kernel((21,) * 3, 2.0 + 0.5 * v)).copy(),
                (25,) * 3,
            )
            for v in range(V)
        ]
    )

    # ---- config 1: headline (4-view 256^3, full kernel2 + full weights)
    shape = (256, 256, 256)
    data = MultiViewData(
        views=jnp.asarray(rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(k2),
        weights=jnp.full((V,) + shape, 1.0 / V, jnp.float32),
    )
    psi0 = jnp.full(shape, float(jnp.mean(data.views)), jnp.float32)

    def run_n(n):
        return deconvolve_jit(
            psi0 + 0.0, data, num_iterations=n, lam=0.006, min_value=1e-4,
            algorithm="auto",
        )

    value = _time_config(lambda: run_n(iters), iters, reps=4)
    _emit(
        f"rl_deconv_iters_per_sec_{V}view_{shape[0]}cubed",
        value, _slope_config(run_n, iters), device,
    )

    # ---- config 1b: headline through the SERVING path (prepare once,
    # deconvolve repeatedly — the time-lapse contract; the reference's
    # plan_store exists precisely to make repeat calls this cheap,
    # inc/plan_store.h:25-235)
    prepared = prepare_workspace(data, shape, algorithm="auto")

    def run_prepared_n(n):
        return deconvolve_prepared(
            psi0 + 0.0, data, prepared, num_iterations=n,
            lam=0.006, min_value=1e-4,
        )

    value = _time_config(lambda: run_prepared_n(iters), iters, reps=4)
    _emit(
        f"rl_deconv_iters_per_sec_{V}view_{shape[0]}cubed_prepared",
        value, _slope_config(run_prepared_n, iters), device,
    )
    del data, psi0, prepared

    # ---- config 2: 4-view 512^3, adjoint kernel2 + scalar weights
    shape = (512, 512, 512)
    data = MultiViewData(
        views=jnp.asarray(rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(k1),  # ignored under adjoint_kernel2
        weights=jnp.full((V,), 1.0 / V, jnp.float32),
    )
    psi0 = jnp.full(shape, float(jnp.mean(data.views)), jnp.float32)

    def run512_n(n):
        return deconvolve_jit(
            psi0 + 0.0, data, num_iterations=n, lam=0.006, min_value=1e-4,
            algorithm="auto", adjoint_kernel2=True,
        )

    value = _time_config(lambda: run512_n(iters), iters, reps=2)
    _emit(
        f"rl_deconv_iters_per_sec_{V}view_{shape[0]}cubed",
        value, _slope_config(run512_n, iters), device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
