#!/usr/bin/env python
"""Synthetic multi-view RL deconvolution benchmark.

Replaces bench_cpu_deconvolve_synthetic / bench_gpu_deconvolve_synthetic
(reference bench/bench_cpu_deconvolve_synthetic.cpp:55-165,
bench_gpu_deconvolve_synthetic.cu:81-229): default workload 6 views,
kernels 21^3/25^3, 10 RL iterations on the given volume.  The reference's
GPU execution modes all_on_device/interleaved become ``--view_order
{sequential,simultaneous}`` and ``--engine {fft,dft,direct,auto}`` — the
strategy axes of this library.  ``--sharded VxZ`` runs the mesh-parallel
driver.
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from benchmarks.common import base_parser, emit_row, parse_dims, setup_platform, time_fn


def main(argv=None):
    p = base_parser("synthetic multi-view RL deconvolution benchmark")
    p.add_argument("-v", "--num_views", type=int, default=6)
    p.add_argument("-i", "--iterations", type=int, default=10)
    p.add_argument("-k1", "--kernel1_dims", type=parse_dims, default=(21, 21, 21))
    p.add_argument("-k2", "--kernel2_dims", type=parse_dims, default=(25, 25, 25))
    p.add_argument("--kernel", choices=["delta", "gaussian"], default="delta")
    p.add_argument("--lambda_", type=float, default=0.006)
    p.add_argument("--view_order", choices=["sequential", "simultaneous"],
                   default="sequential")
    p.add_argument("--engine", choices=["fft", "dft", "direct", "auto"], default="fft")
    p.add_argument("--sharded", default=None,
                   help="VxZ mesh, e.g. 2x4 (requires that many devices)")
    p.add_argument("--uniform_weights", action="store_true",
                   help="per-view scalar weights 1/V (no weight stacks on the device)")
    p.add_argument("--adjoint_kernel2", action="store_true",
                   help="kernel2 = flip(kernel1): reuse conj spectra")
    args = p.parse_args(argv)
    jax = setup_platform(args.platform)
    import jax.numpy as jnp
    import numpy as np

    from libmultiviewnative_jax.deconv.rl import deconvolve_jit
    from libmultiviewnative_jax.deconv.workspace import (
        Workspace,
        initial_psi,
    )
    from libmultiviewnative_jax.utils.synthetic import multiview_data

    views = multiview_data(
        args.num_views,
        args.stack_dims,
        kernel1_shape=args.kernel1_dims,
        kernel2_shape=args.kernel2_dims,
        kernel=args.kernel,
    )
    ws = Workspace.from_views(views, lambda_=args.lambda_,
                              num_iterations=args.iterations)
    if args.uniform_weights:
        from libmultiviewnative_jax.deconv.workspace import MultiViewData

        ws.data = MultiViewData(
            views=ws.data.views,
            kernel1=ws.data.kernel1,
            kernel2=ws.data.kernel2,
            weights=jnp.full((args.num_views,), 1.0 / args.num_views, jnp.float32),
        )
    psi0 = jax.block_until_ready(initial_psi(ws.data, "average"))

    if args.sharded:
        if args.adjoint_kernel2:
            p.error("--sharded does not support --adjoint_kernel2")
        if args.engine not in ("fft", "dft", "auto"):
            p.error("--sharded supports --engine fft, dft or auto")
        vp, zp = (int(t) for t in args.sharded.lower().split("x"))
        from libmultiviewnative_jax.parallel.sharded import (
            deconvolve_sharded_jit,
            make_mesh,
            shard_workspace,
        )

        mesh = make_mesh(view_parallel=vp, z_parallel=zp)
        psi_s, data_s = shard_workspace(ws.data, psi0, mesh)

        def fn():
            return deconvolve_sharded_jit(
                psi_s + 0, data_s, num_iterations=args.iterations, mesh=mesh,
                lam=args.lambda_, algorithm=args.engine,
            )

    else:
        data = ws.data

        def fn():
            return deconvolve_jit(
                psi0 + 0,
                data,
                num_iterations=args.iterations,
                lam=args.lambda_,
                view_order=args.view_order,
                algorithm=args.engine,
                adjoint_kernel2=args.adjoint_kernel2,
            )

    total_ms = time_fn(fn, args.repeats, args.warmup)
    mode = args.sharded and f"sharded{args.sharded}" or args.view_order
    comment = (
        f"rl_{mode}_{args.engine}_v{args.num_views}_i{args.iterations}"
        + (f"_{args.comment}" if args.comment else "")
    )
    emit_row(args.repeats, total_ms, args.stack_dims, comment)
    # derived headline: iterations/s
    iters_per_sec = args.iterations * args.repeats / (total_ms / 1e3)
    print(f"# iterations_per_second {iters_per_sec:.4f}", flush=True)


if __name__ == "__main__":
    main()
