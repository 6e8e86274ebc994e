"""NaN/Inf guard + tracing flag tests (reference: the contains_nan/inf scans
at src/multiviewnative.cpp:18-58 and the LMVN_TRACE machinery)."""

import numpy as np
import pytest

from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.utils.trace import profile_region, trace_enabled
from libmultiviewnative_jax.utils.validate import check_finite, validate_workspace


def _data(bad=None):
    import jax.numpy as jnp

    v = np.ones((2, 4, 4, 4), np.float32)
    k = np.ones((2, 3, 3, 3), np.float32)
    w = np.ones((2, 4, 4, 4), np.float32)
    if bad == "nan":
        v[0, 0, 0, 0] = np.nan
    if bad == "inf":
        w[1, 1, 1, 1] = np.inf
    return MultiViewData(jnp.asarray(v), jnp.asarray(k), jnp.asarray(k), jnp.asarray(w))


def test_clean_workspace_passes():
    assert validate_workspace(_data()) == []


def test_nan_detected():
    with pytest.raises(ValueError, match="views contains NaN"):
        validate_workspace(_data("nan"))


def test_inf_detected():
    problems = validate_workspace(_data("inf"), raise_on_bad=False)
    assert problems == ["weights contains Inf"]


def test_check_finite_raise():
    with pytest.raises(ValueError, match="x contains NaN"):
        check_finite(np.array([np.nan]), "x", raise_on_bad=True)


def test_trace_flag(monkeypatch):
    monkeypatch.setenv("LMVN_TRACE", "0")
    assert not trace_enabled()
    monkeypatch.setenv("LMVN_TRACE", "1")
    assert trace_enabled()


def test_profile_region_wallclock(capsys, monkeypatch):
    monkeypatch.setenv("LMVN_TRACE", "1")
    monkeypatch.delenv("LMVN_PROFILE_DIR", raising=False)
    with profile_region("unit"):
        pass
    out = capsys.readouterr().out
    assert "unit:" in out and "ms" in out
