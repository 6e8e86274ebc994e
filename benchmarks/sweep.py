#!/usr/bin/env python
"""Sweep driver: run a bench over a dims ladder × mode matrix.

Replaces the reference tooling layer (reference python/sweep_gpu.py:125-196
and generate_dims.py:4-48): generates the same power-of-2 anisotropic dims
ladder, crosses it with per-bench mode matrices, runs each config in-process
(one process per card: a second JAX process on the card would find its
memory already reserved), and appends rows to a .data file.  nvprof wrapping becomes the
LMVN_PROFILE_DIR jax.profiler hook (utils/trace.py).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def generate_dims(start: int = 16, limit: int = 256):
    """Anisotropic 2^n ladder: 16x16x16, 32x16x16, 32x32x16, ... — mirrors
    /root/reference/python/generate_dims.py:4-48 (grown axis rotates)."""
    dims = [start, start, start]
    out = [tuple(dims)]
    axis = 0
    while True:
        dims[axis] *= 2
        if max(dims) > limit:
            break
        out.append(tuple(dims))
        axis = (axis + 1) % 3
    return out


MODE_MATRIX = {
    # per-bench flag matrices, the analog of sweep_gpu.py:144-160
    "fft": [
        ["--tx_mode", "excl", "--plan", "cached"],
        ["--tx_mode", "incl", "--plan", "cached"],
        ["--tx_mode", "excl", "--plan", "cached", "-n", "8"],
    ],
    "convolve": [
        ["--engine", "fft"],
        ["--engine", "direct", "-k", "5x5x5"],
    ],
    "deconvolve": [
        ["--view_order", "sequential"],
        ["--view_order", "simultaneous"],
    ],
    # engine ladder: the in-core spectral engines head-to-head
    "engines": [
        ["--engine", "fft"],
        ["--engine", "dft"],
    ],
}
MODE_BENCH = {"engines": "deconvolve"}  # alias matrices -> bench CLI


def main(argv=None):
    p = argparse.ArgumentParser(description="bench sweep driver")
    p.add_argument("bench", choices=sorted(MODE_MATRIX))
    p.add_argument("-o", "--output", default=None, help=".data output file")
    p.add_argument("--start", type=int, default=16)
    p.add_argument("--limit", type=int, default=128)
    p.add_argument("-r", "--repeats", type=int, default=3)
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)

    from benchmarks import bench_convolve, bench_deconvolve, bench_fft

    runner = {
        "fft": bench_fft.main,
        "convolve": bench_convolve.main,
        "deconvolve": bench_deconvolve.main,
    }[MODE_BENCH.get(args.bench, args.bench)]

    out_f = open(args.output, "a") if args.output else None
    try:
        for dims in generate_dims(args.start, args.limit):
            for mode in MODE_MATRIX[args.bench]:
                argv_run = [
                    "-s", "x".join(str(d) for d in dims),
                    "-r", str(args.repeats),
                ] + mode
                if args.platform:
                    argv_run += ["--platform", args.platform]
                buf = io.StringIO()
                try:
                    with contextlib.redirect_stdout(buf):
                        runner(argv_run)
                except Exception as exc:  # OOM / device crash: keep sweeping
                    print(f"# config {dims} {mode} failed: {exc}")
                    continue
                for line in buf.getvalue().splitlines():
                    if line and not line.startswith("#") and out_f:
                        # append per row so a crash never loses prior results
                        out_f.write(line + "\n")
                        out_f.flush()
                    print(line)
    finally:
        if out_f:
            out_f.close()


if __name__ == "__main__":
    main()
