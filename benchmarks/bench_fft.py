#!/usr/bin/env python
"""3D FFT benchmark — single and batched stacks.

Replaces the reference FFT bench family:
  * bench_gpu_nd_fft (/root/reference/bench/bench_gpu_nd_fft.cu:122-273):
    modes incl/excl transfer, cached vs throwaway plan → here
    ``--tx_mode {incl,excl}`` (device_put inside/outside the timed region)
    and ``--plan {cached,first}`` (reuse the jitted program vs include the
    first compile, the jit-cache analog of plan_store vs cufftPlan3d).
  * bench_cpu_many_nd_fft (bench/bench_cpu_many_nd_fft.cpp:169-244) and
    batched_fft_* strategies (inc/cufft_utils.cuh:88-187) → ``--num_stacks``
    batches on the leading axis; XLA owns the overlap the reference
    hand-rolled with 2 streams.

Row schema: bench/logging.hpp.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from benchmarks.common import base_parser, emit_row, setup_platform, time_fn


def main(argv=None):
    p = base_parser("3D rfft+irfft roundtrip benchmark")
    p.add_argument("-n", "--num_stacks", type=int, default=1)
    p.add_argument("--tx_mode", choices=["incl", "excl"], default="excl",
                   help="include host->device transfer in the timing")
    p.add_argument("--plan", choices=["cached", "first"], default="cached",
                   help="'first' includes jit compile time (throwaway-plan analog)")
    args = p.parse_args(argv)
    jax = setup_platform(args.platform)
    import jax.numpy as jnp
    import numpy as np

    from libmultiviewnative_jax.core.fft import irfft3, rfft3

    shape = (args.num_stacks,) + tuple(args.stack_dims)
    host = np.random.default_rng(0).normal(size=shape).astype(np.float32)

    @jax.jit
    def roundtrip(x):
        return irfft3(rfft3(x), x.shape[-3:])

    if args.tx_mode == "excl":
        dev = jax.device_put(host)
        fn = lambda: roundtrip(dev)
    else:
        fn = lambda: roundtrip(jax.device_put(host))

    warmup = 0 if args.plan == "first" else max(args.warmup, 1)
    total_ms = time_fn(fn, args.repeats, warmup)
    comment = (
        f"fft_{args.tx_mode}_tx_{args.plan}_plan_n{args.num_stacks}"
        + (f"_{args.comment}" if args.comment else "")
    )
    emit_row(args.repeats, total_ms, args.stack_dims, comment)


if __name__ == "__main__":
    main()
