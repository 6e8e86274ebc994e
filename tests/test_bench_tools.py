"""Bench tooling tests: row schema, dims parsing, ladder generator.

Parity targets: reference bench/logging.hpp:9-60 (row format),
bench/synthetic_data.hpp:11-35 (dims split), python/generate_dims.py:4-48
(anisotropic 2^n ladder)."""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

from benchmarks.common import parse_dims
from benchmarks.sweep import generate_dims
from libmultiviewnative_jax.utils.logging import BenchRow


def test_parse_dims():
    assert parse_dims("64x64x64") == (64, 64, 64)
    assert parse_dims("16x32x64") == (16, 32, 64)
    assert parse_dims("128") == (128, 128, 128)
    with pytest.raises(Exception):
        parse_dims("4x5")


def test_bench_row_schema():
    row = BenchRow(
        n_devices=1, dev_type="gpu", dev_name="NVIDIA H100 80GB HBM3", n_repeats=10,
        total_time_ms=123.456, dims=(64, 32, 16), comment="rl bench",
    ).line()
    fields = row.split()
    # n_devices dev_type dev_name n_repeats total_time_ms x y z width comment
    assert fields[0] == "1"
    assert fields[1] == "gpu"
    assert fields[2] == "NVIDIA_H100_80GB_HBM3"  # spaces escaped
    assert fields[3] == "10"
    assert float(fields[4]) == pytest.approx(123.456)
    assert fields[5:8] == ["64", "32", "16"]
    assert fields[8] == "4"
    assert fields[9] == "rl_bench"


def test_generate_dims_ladder():
    ladder = generate_dims(16, 64)
    assert ladder[0] == (16, 16, 16)
    assert ladder[1] == (32, 16, 16)  # axis 0 grows first
    assert all(max(d) <= 64 for d in ladder)
    # strictly doubling total volume each step
    vols = [d[0] * d[1] * d[2] for d in ladder]
    assert all(b == 2 * a for a, b in zip(vols, vols[1:]))


def test_bench_slope_helper(monkeypatch):
    """bench._slope_config: two-point fit at (n/3, n) — the larger point
    is the timed config itself; degenerate iteration counts return None.
    Every call is waited for with block_until_ready."""
    import jax

    import bench

    # linear cost model: t(n) = overhead + n * per_iter
    calls = []
    waited = []

    def run_n(n):
        calls.append(n)
        return n

    monkeypatch.setattr(jax, "block_until_ready", lambda x: waited.append(x))
    # emulate timing by monkeypatching perf_counter around a deterministic
    # schedule: warmup + 2 passes per point
    times = iter(
        # n=3: two passes of (start, end) with dt=0.5+3*0.1
        [0.0, 0.8, 10.0, 10.8]
        # n=10: dt=0.5+10*0.1
        + [20.0, 21.5, 30.0, 31.5]
    )
    monkeypatch.setattr(
        bench.time, "perf_counter", lambda: next(times)
    )
    s = bench._slope_config(run_n, 10)
    # slope = (10-3)/(1.5-0.8) = 10 it/s on the synthetic cost model
    assert abs(s - 10.0) < 1e-6, s
    assert calls == [3, 3, 3, 10, 10, 10]  # warmup + 2 passes each
    assert waited == calls  # every call ended by block_until_ready

    assert bench._slope_config(run_n, 1) is None  # lo >= iters


def test_bench_time_config_waits_for_every_call(monkeypatch):
    import jax

    import bench

    waited = []
    monkeypatch.setattr(jax, "block_until_ready", lambda x: waited.append(x))
    times = iter([0.0, 2.0, 10.0, 11.0])
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(times))
    rate = bench._time_config(lambda: "out", iters=10, reps=2)
    # best pass: 1.0 s for 2 reps -> 0.5 s per 10-iteration call
    assert rate == pytest.approx(20.0)
    assert len(waited) == 1 + 2 * 2  # warmup + 2 passes x 2 reps


def test_bench_emit_names_the_device(capsys):
    import json

    import bench

    device = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
              "device_count": 1, "power_limit": "NVIDIA H100 80GB HBM3, 700.00 W"}
    bench._emit("rl_deconv_iters_per_sec_4view_256cubed", 12.5, 13.0, device)
    row = json.loads(capsys.readouterr().out.strip())
    assert row["metric"] == "rl_deconv_iters_per_sec_4view_256cubed"
    assert row["unit"] == "iterations/s"
    assert row["value"] == 12.5 and row["slope"] == 13.0
    for key in ("platform", "device_kind", "device_count", "power_limit"):
        assert row[key] == device[key]
    assert "fallback" not in row and "vs_baseline" not in row
