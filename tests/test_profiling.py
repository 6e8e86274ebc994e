"""Profiler hook smoke test: profile_region with a log dir must produce a
TensorBoard-consumable trace dump (the nvprof-wrapping analog)."""

import glob
import os

import numpy as np

from libmultiviewnative_jax.utils.trace import annotate, profile_region


def test_profile_region_writes_trace(tmp_path):
    import jax.numpy as jnp

    logdir = str(tmp_path / "trace")
    with profile_region("unit-profile", logdir=logdir):
        with annotate("inner-op"):
            float(jnp.sum(jnp.ones((64, 64)) * 2.0))
    dumped = glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
    assert any(os.path.isfile(f) for f in dumped), "no trace files written"
