"""Shared bench plumbing: timing, dims parsing, row emission.

Replaces the reference bench scaffolding: ``split<'x'>`` dims parsing
(reference bench/synthetic_data.hpp:11-35), the program_options flags
(e.g. bench/bench_gpu_deconvolve_synthetic.cu:76-101), and the logging row
(bench/logging.hpp:9-60 — schema kept verbatim so the reference's sweep
tooling can parse our output).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Sequence, Tuple

import numpy as np


def parse_dims(text: str) -> Tuple[int, int, int]:
    """'64x64x64' → (z, y, x) (reference split<'x'>, synthetic_data.hpp:11-35)."""
    parts = [int(t) for t in text.lower().split("x")]
    if len(parts) == 1:
        parts = parts * 3
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"bad dims {text!r}; want ZxYxX")
    return tuple(parts)  # type: ignore[return-value]


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("-s", "--stack_dims", type=parse_dims, default=(64, 64, 64),
                   help="volume dims ZxYxX (default 64x64x64)")
    p.add_argument("-r", "--repeats", type=int, default=10)
    p.add_argument("-w", "--warmup", type=int, default=1,
                   help="untimed warmup runs (compile)")
    p.add_argument("-c", "--comment", default="")
    p.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu)")
    return p


def setup_platform(platform):
    import jax

    from libmultiviewnative_jax.utils.compile_cache import enable_compile_cache

    if platform:
        jax.config.update("jax_platforms", platform)
    # persistent compilation cache (plan-store analog): reruns start hot
    enable_compile_cache()
    return jax


def time_fn(fn: Callable[[], object], repeats: int, warmup: int = 1) -> float:
    """Total wall ms for `repeats` executions (post-warmup), each ended by
    ``block_until_ready`` — like the reference's boost timer loops around
    the hot section."""
    import jax

    for _ in range(max(warmup, 0)):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(repeats):
        jax.block_until_ready(fn())
    return 1e3 * (time.perf_counter() - t0)


def time_fn_net(fn: Callable[[], object], repeats: int, warmup: int = 1) -> float:
    """Per-execution ms with the per-call dispatch overhead amortized: all
    `repeats` executions are DISPATCHED asynchronously and only the last
    result is waited for.  A single device executes launches in dispatch
    order, so completion of the last implies completion of all."""
    import jax

    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(repeats):
        out = fn()
    jax.block_until_ready(out)
    return 1e3 * (time.perf_counter() - t0) / repeats


def emit_row(repeats: int, total_ms: float, dims: Sequence[int], comment: str) -> None:
    """Print one bench/logging.hpp-format row.  dims logged (x, y, z) as the
    reference does."""
    from libmultiviewnative_jax.utils.logging import current_device_row

    z, y, x = dims
    print(current_device_row(repeats, total_ms, (x, y, z), comment).line())
    sys.stdout.flush()
