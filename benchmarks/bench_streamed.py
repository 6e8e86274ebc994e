#!/usr/bin/env python
"""Out-of-core deconvolution benchmark (both streaming rungs).

The reference benchmarks its out-of-core strategy as the interleaved
mode (bench/bench_gpu_deconvolve_synthetic.cu --mode interleaved).  The
library has two rungs below in-core, both measured here:

  --mode interleaved  psi device-resident, only views/weights stream in
                      z-chunks (deconv/interleaved.py — the reference
                      design point: ~V*S host->device bytes/iteration);
  --mode streamed     psi itself chunked through the device with the
                      bounded in-flight pipeline (deconv/streamed.py —
                      psi > device-memory territory; ~(5V+2)*S bytes/iteration).

Emits the standard logging row plus iterations/s.

    python benchmarks/bench_streamed.py -s 512x512x512 --views 4 \
        --iterations 2 --chunk-z 64 --mode interleaved
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from benchmarks.common import base_parser, emit_row, setup_platform


def main():
    p = base_parser("streamed out-of-core RL deconvolve")
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--chunk-z", default="auto",
                   help="int or 'auto' (engine-friendly extended extent)")
    p.add_argument("--algorithm", default="auto",
                   choices=["fft", "dft", "direct", "auto"])
    p.add_argument("--mode", default="streamed",
                   choices=["streamed", "interleaved"])
    p.add_argument("--scalar-weights", action="store_true",
                   help="uniform 1/V scalar weights (interleaved rung "
                        "streams nothing for them)")
    args = p.parse_args()
    if args.chunk_z != "auto":
        args.chunk_z = int(args.chunk_z)
    setup_platform(args.platform)

    from libmultiviewnative_jax.deconv.interleaved import deconvolve_interleaved
    from libmultiviewnative_jax.deconv.streamed import deconvolve_streamed
    from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

    Z, Y, X = args.stack_dims
    V = args.views
    rng = np.random.default_rng(0)
    views = [
        rng.gamma(2.0, 20.0, (Z, Y, X)).astype(np.float32) for _ in range(V)
    ]
    k1s = [gaussian_kernel((21, 21, 21), 2.0 + 0.5 * v) for v in range(V)]
    k2s = [np.flip(k).copy() for k in k1s]
    if args.scalar_weights and args.mode == "interleaved":
        ws = [np.float32(1.0 / V) for _ in range(V)]
    elif args.scalar_weights:
        # the streamed rung slices weights[v][z0:z1] per chunk — scalars
        # are not subscriptable there, so materialize the uniform stacks
        # (host RAM only; the rung still streams them chunk-wise)
        print("# --scalar-weights on the streamed rung: materializing "
              "uniform weight stacks (the rung streams per-voxel weights)")
        ws = [np.full((Z, Y, X), 1.0 / V, np.float32) for _ in range(V)]
    else:
        ws = [np.full((Z, Y, X), 1.0 / V, np.float32) for _ in range(V)]
    psi0 = np.full((Z, Y, X), float(np.mean(views[0])), np.float32)

    if args.mode == "interleaved":
        chunk = 64 if args.chunk_z == "auto" else args.chunk_z

        def run(iters):
            return deconvolve_interleaved(
                psi0, views, k1s, k2s, ws, iters, lam=0.006,
                chunk_z=chunk, algorithm=args.algorithm,
            )
    else:

        def run(iters):
            return deconvolve_streamed(
                psi0, views, k1s, k2s, ws, iters, lam=0.006,
                chunk_z=args.chunk_z, algorithm=args.algorithm,
            )

    # warmup (compiles every chunk program)
    run(1)
    t0 = time.perf_counter()
    run(args.iterations)
    dt = time.perf_counter() - t0
    total_ms = 1e3 * dt
    emit_row(
        args.iterations, total_ms, (Z, Y, X),
        f"{args.mode}_rl_{V}view_chunk{args.chunk_z}_{args.algorithm}",
    )
    print(
        f"{args.mode}: {args.iterations / dt:.3f} iterations/s "
        f"({total_ms / args.iterations:.1f} ms/iter)"
    )


if __name__ == "__main__":
    main()
