"""Failure-recovery + debug-context tests (the aux tiers absent from the
reference, SURVEY.md §5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libmultiviewnative_jax.deconv.workspace import Workspace, initial_psi
from libmultiviewnative_jax.io.checkpoint import (
    CheckpointManager,
    deconvolve_checkpointed,
    deconvolve_resilient,
)
from libmultiviewnative_jax.utils.synthetic import multiview_data
from libmultiviewnative_jax.utils.trace import debug_context


def _problem():
    views = multiview_data(2, (12, 12, 12), kernel="gaussian", seed=6)
    ws = Workspace.from_views(views)
    psi0 = np.asarray(initial_psi(ws.data, "average"))
    return psi0, ws.data


def test_resilient_recovers_from_midrun_crash(tmp_path, monkeypatch):
    psi0, data = _problem()
    mgr = CheckpointManager(str(tmp_path / "r"))

    import libmultiviewnative_jax.io.checkpoint as ckpt

    real = ckpt.deconvolve_checkpointed
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            # simulate a device crash after 2 of 4 iterations: run the
            # first chunk for real, then die
            real(args[0], args[1], 2, args[3], **kw)
            raise RuntimeError("device worker process crashed or restarted")
        return real(*args, **kw)

    monkeypatch.setattr(ckpt, "deconvolve_checkpointed", flaky)
    out = np.asarray(
        deconvolve_resilient(psi0, data, 4, mgr, checkpoint_every=1)
    )
    assert calls["n"] == 2  # one crash, one successful resume

    mgr2 = CheckpointManager(str(tmp_path / "clean"))
    want = np.asarray(
        real(psi0, data, 4, mgr2, checkpoint_every=1)
    )
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


def test_resilient_gives_up_after_max_retries(tmp_path, monkeypatch):
    psi0, data = _problem()
    mgr = CheckpointManager(str(tmp_path / "g"))
    import libmultiviewnative_jax.io.checkpoint as ckpt

    def always_dead(*a, **k):
        raise RuntimeError("dead device")

    monkeypatch.setattr(ckpt, "deconvolve_checkpointed", always_dead)
    failures = []
    with pytest.raises(RuntimeError, match="dead device"):
        deconvolve_resilient(
            psi0, data, 4, mgr, max_retries=2,
            on_failure=lambda e, i: failures.append(i),
        )
    assert failures == [1, 2, 3]


def test_debug_context_flags_nan():
    with pytest.raises(FloatingPointError):
        with debug_context(nan_checks=True):
            jnp.log(jnp.zeros(4) - 1.0).block_until_ready()
    # flag restored afterwards
    assert not jax.config.jax_debug_nans
