#!/usr/bin/env python
"""Batched convolution ("folds") benchmark.

Replaces bench_cpu_many_nd_folds / bench_gpu_many_nd_folds
(reference bench/bench_cpu_many_nd_folds.cpp:90-93,
bench_gpu_many_nd_folds.cu:300-360): N stacks convolved by a PSF with the
kernel pre-forwarded (the half_inplace fast path) — here one batched
spectrum multiply; ``--engine dft`` benches the dense-DFT engine and
``--engine direct`` the spatial stencil path, an alternative the
reference cannot express.
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from benchmarks.common import base_parser, emit_row, parse_dims, setup_platform, time_fn


def main(argv=None):
    p = base_parser("batched 3D convolution (folds) benchmark")
    p.add_argument("-n", "--num_stacks", type=int, default=8)
    p.add_argument("-k", "--kernel_dims", type=parse_dims, default=(21, 21, 21))
    p.add_argument("--engine", choices=["fft", "dft", "direct"],
                   default="fft")
    args = p.parse_args(argv)
    jax = setup_platform(args.platform)
    import numpy as np

    from libmultiviewnative_jax.core.convolve import (
        convolve_spectrum,
        direct_convolve3d,
    )
    from libmultiviewnative_jax.core.fft import forward_kernel_spectrum
    from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

    rng = np.random.default_rng(0)
    stacks = jax.device_put(
        rng.normal(size=(args.num_stacks,) + tuple(args.stack_dims)).astype(
            np.float32
        )
    )
    kernel = jax.device_put(gaussian_kernel(args.kernel_dims, 2.0))

    if args.engine == "fft":
        k_hat = jax.block_until_ready(
            forward_kernel_spectrum(kernel, args.stack_dims)
        )
        fn = jax.jit(lambda x: convolve_spectrum(x, k_hat))
    elif args.engine == "dft":
        from libmultiviewnative_jax.core.dft import (
            dft_convolve_spectrum,
            kernel_spectrum_split,
        )

        kre, kim = kernel_spectrum_split(kernel, tuple(args.stack_dims))
        fn = jax.jit(lambda x: dft_convolve_spectrum(x, kre, kim))
    else:
        fn = jax.jit(lambda x: direct_convolve3d(x, kernel, mode="circular"))

    total_ms = time_fn(lambda: fn(stacks), args.repeats, args.warmup)
    kz, ky, kx = args.kernel_dims
    comment = (
        f"folds_{args.engine}_n{args.num_stacks}_k{kz}x{ky}x{kx}"
        + (f"_{args.comment}" if args.comment else "")
    )
    emit_row(args.repeats, total_ms, args.stack_dims, comment)
    # content bandwidth (BASELINE.md metric "3D FFT-convolve GB/s per
    # chip"): volume bytes in + out per convolve over wall time
    import math

    nbytes = 2 * args.num_stacks * 4 * math.prod(args.stack_dims)
    print(
        f"# convolve_content_gbps "
        f"{nbytes / (total_ms * 1e-3) / 1e9:.2f}"
    )


if __name__ == "__main__":
    main()
