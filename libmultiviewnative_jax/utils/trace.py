"""Tracing / profiling hooks.

Equivalent of the reference's observability layer: the
compile-time ``LMVN_TRACE`` verbose-dump macro
(/root/reference/src/gpu_deconvolve_methods.cuh:426-457 etc., wired in
tests/CMakeLists.txt:55-63) becomes a runtime env flag gating structured
step logging, and the ``cudaProfilerStart/Stop`` brackets + external nvprof
(/root/reference/bench/bench_gpu_nd_fft.cu:170-250, python/parse_nvprof.py)
become ``jax.profiler`` trace contexts producing TensorBoard xplane dumps.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

TRACE_ENV = "LMVN_TRACE"


def trace_enabled() -> bool:
    """Runtime analog of the reference's compile-time LMVN_TRACE flag."""
    return os.environ.get(TRACE_ENV, "0") not in ("", "0", "false", "False")


def trace_print(*args) -> None:
    if trace_enabled():
        print("[lmvn-trace]", *args, flush=True)


@contextlib.contextmanager
def profile_region(name: str, logdir: Optional[str] = None) -> Iterator[None]:
    """Profile a region: jax.profiler trace when ``logdir`` given (or
    LMVN_PROFILE_DIR set), else a wall-clock bracket under LMVN_TRACE.

    The analog of the cudaProfilerStart/Stop brackets around bench hot
    loops."""
    import jax

    logdir = logdir or os.environ.get("LMVN_PROFILE_DIR")
    t0 = time.perf_counter()
    if logdir:
        with jax.profiler.trace(logdir):
            with jax.profiler.TraceAnnotation(name):
                yield
    else:
        yield
    trace_print(f"{name}: {1e3 * (time.perf_counter() - t0):.3f} ms")


@contextlib.contextmanager
def debug_context(
    nan_checks: bool = True, disable_jit: bool = False
) -> Iterator[None]:
    """Numerical-debugging scope — the sanitizer tier the reference lacks
    (SURVEY.md §5 "race detection/sanitizers: none").  Enables jax NaN
    checking (every primitive output scanned, error at the producing op)
    and optionally interpreted execution for step-through debugging."""
    import jax

    prev_nans = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", nan_checks)
    try:
        if disable_jit:
            with jax.disable_jit():
                yield
        else:
            yield
    finally:
        jax.config.update("jax_debug_nans", prev_nans)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an existing profiler trace (shows up on the
    TensorBoard timeline)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
