"""chip_smoke.py and bench.py off the card: both refuse a CPU backend, and
every chip_smoke phase rehearses here at tiny sizes through the same
functions the card runs (the script itself has no CPU mode)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_script(name, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, name), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("script,args", [
    ("chip_smoke.py", ()),
    ("chip_smoke.py", ("--chips", "4")),
    ("bench.py", ()),
])
def test_script_refuses_cpu_backend(script, args):
    res = _run_script(script, *args)
    assert res.returncode != 0, res.stdout
    assert "needs a GPU" in res.stderr or "measures a GPU" in res.stderr
    for line in res.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)  # no result line of any kind


@pytest.fixture
def tiny_kernels(monkeypatch):
    monkeypatch.setattr(chip_smoke, "KERNEL1", (5, 5, 5))
    monkeypatch.setattr(chip_smoke, "KERNEL2", (7, 7, 7))


def test_rehearse_compile_check(tiny_kernels, capsys):
    chip_smoke.phase_compile((16, 16, 16), (24, 16, 16), (12, 32, 32), 3)
    out = capsys.readouterr().out
    assert out.count("compiled in") == 7
    assert "deconvolve_prepared" in out and "rl_view_step" in out


def test_rehearse_256_phase(tiny_kernels, capsys):
    chip_smoke.phase_256((16, 16, 16))
    out = capsys.readouterr().out
    assert out.count("  ok") == 4, out
    for name in ("deconvolve_auto", "deconvolve_jit fft",
                 "deconvolve_jit dft", "deconvolve_prepared"):
        assert name in out


def test_rehearse_512_phase(tiny_kernels, capsys):
    chip_smoke.phase_512((24, 16, 16))
    out = capsys.readouterr().out
    assert "  ok" in out and "finite" in out


def test_rehearse_deployment_phase(tiny_kernels, capsys):
    chip_smoke.phase_deployment((12, 32, 32), 3)
    out = capsys.readouterr().out
    assert "rung in-core" in out and "engine dft" in out
    assert "rl_view_step at the deployment size" in out and "  ok" in out


def test_rehearse_findings_phase(tiny_kernels, capsys):
    chip_smoke.phase_findings((16, 16, 16), (24, 16, 16))
    out = capsys.readouterr().out
    for what in ("fft (16, 16, 16)", "dft (24, 16, 16)", "direct",
                 "rl_update", "precision=high:", "precision=highest:",
                 "fft convolve"):
        assert what in out, what


def test_rehearse_mesh_phase(tiny_kernels, capsys):
    """--chips 4's phase on 4 of the suite's 8 virtual CPU devices."""
    chip_smoke.phase_mesh((32, 16, 16))
    out = capsys.readouterr().out
    assert "mesh 2x2 simultaneous" in out and "mesh 1x4 sequential" in out
    assert "[0, 1, 2, 3]" in out


def test_gate_rejects_a_miss():
    want = np.full((8, 8, 8), 40.0)
    chip_smoke.gate("same", want.astype(np.float32), want)
    with pytest.raises(AssertionError, match="mirror gates"):
        chip_smoke.gate("off by 1%", (want * 1.01).astype(np.float32), want)
