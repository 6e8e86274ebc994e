"""IO + checkpoint tests.

Mirrors the reference's TIFF write-reload roundtrip test
(test_tiff_stack_fixture.cpp:111-176) and formalizes its psi_i external
checkpoint convention (SURVEY.md §5) as resume tests."""

import numpy as np
import pytest

from libmultiviewnative_jax.io.checkpoint import (
    CheckpointManager,
    deconvolve_checkpointed,
)
from libmultiviewnative_jax.io.stacks import (
    load_stack_npz,
    read_shape_sidecar,
    read_tiff_stack,
    save_stack_npz,
    write_shape_sidecar,
    write_tiff_stack,
)
from libmultiviewnative_jax.deconv.workspace import MultiViewData, Workspace, initial_psi
from libmultiviewnative_jax.utils.synthetic import multiview_data


def test_tiff_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    stack = rng.normal(size=(6, 10, 12)).astype(np.float32)
    p = str(tmp_path / "stack.tif")
    write_tiff_stack(p, stack)
    back = read_tiff_stack(p)
    np.testing.assert_allclose(back, stack, rtol=1e-6)
    assert back.shape == (6, 10, 12)


def test_tiff_rejects_all_nan(tmp_path):
    p = str(tmp_path / "nan.tif")
    write_tiff_stack(p, np.full((2, 4, 4), np.nan, np.float32))
    with pytest.raises(ValueError, match="entirely NaN"):
        read_tiff_stack(p)


def test_shape_sidecar(tmp_path):
    p = str(tmp_path / "stack.tif.shape")
    write_shape_sidecar(p, (6, 10, 12))
    assert read_shape_sidecar(p) == (6, 10, 12)


def test_npz_roundtrip(tmp_path):
    p = str(tmp_path / "g.npz")
    a = np.arange(24.0, dtype=np.float32).reshape(2, 3, 4)
    save_stack_npz(p, psi=a, other=a * 2)
    back = load_stack_npz(p)
    np.testing.assert_array_equal(back["psi"], a)
    np.testing.assert_array_equal(back["other"], a * 2)


def test_checkpoint_manager_roundtrip_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    a = np.ones((4, 4, 4), np.float32)
    mgr.save(0, a)
    mgr.save(3, a * 3)
    it, psi = mgr.latest()
    assert it == 3
    np.testing.assert_allclose(psi, a * 3)


def test_deconvolve_checkpointed_resume_equivalence(tmp_path):
    views = multiview_data(2, (12, 12, 12), kernel="gaussian", seed=6)
    ws = Workspace.from_views(views)
    psi0 = np.asarray(initial_psi(ws.data, "average"))

    # uninterrupted 4 iterations
    mgr_a = CheckpointManager(str(tmp_path / "a"))
    out_a = np.asarray(
        deconvolve_checkpointed(psi0, ws.data, 4, mgr_a, checkpoint_every=1)
    )

    # interrupted after 2, then resumed
    mgr_b = CheckpointManager(str(tmp_path / "b"))
    deconvolve_checkpointed(psi0, ws.data, 2, mgr_b, checkpoint_every=1)
    out_b = np.asarray(
        deconvolve_checkpointed(psi0, ws.data, 4, mgr_b, checkpoint_every=1)
    )
    np.testing.assert_allclose(out_a, out_b, rtol=1e-6, atol=1e-6)
    # psi_3 snapshot exists and equals the final state
    it, snap = mgr_b.latest()
    assert it == 3
    np.testing.assert_allclose(snap, out_b, rtol=1e-6)


def test_checkpoint_tif_format(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "t"), fmt="tif")
    a = np.ones((3, 4, 5), np.float32) * 7
    mgr.save(1, a)
    it, psi = mgr.latest()
    assert it == 1
    np.testing.assert_allclose(psi, a)
