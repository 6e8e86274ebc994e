"""Per-iteration psi checkpointing and resume.

The reference has no in-library checkpointing; its ecosystem convention is
iteration-indexed ``psi_i.tif`` snapshots written externally
(/root/reference/tests/tiff_fixtures.hpp:453-462) — any iteration output is
a valid restart point because the RL update is a pure function of psi
(SURVEY.md §5).  Here that convention is formalized: a CheckpointManager
that writes psi each sweep (TIFF for Fiji interop, NPZ for fidelity) and a
``deconvolve_checkpointed`` driver that resumes from the newest snapshot.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Optional, Tuple

import numpy as np

from ..deconv.rl import deconvolve_jit
from ..deconv.workspace import MultiViewData
from .stacks import load_stack_npz, read_tiff_stack, save_stack_npz, write_tiff_stack

_PSI_RE = re.compile(r"psi_(\d+)\.(npz|tif|tiff)$")


class CheckpointManager:
    """Writes/loads iteration-indexed psi snapshots in a directory.

    File naming follows the golden-data convention psi_<i>.<ext>
    (/root/reference/tests/tiff_fixtures.hpp:453-462): psi_i is the state
    AFTER iteration i (0-based)."""

    def __init__(self, directory: str, fmt: str = "npz") -> None:
        if fmt not in ("npz", "tif"):
            raise ValueError(f"unknown checkpoint format {fmt!r}")
        self.directory = directory
        self.fmt = fmt
        os.makedirs(directory, exist_ok=True)

    def path(self, iteration: int) -> str:
        return os.path.join(self.directory, f"psi_{iteration}.{self.fmt}")

    def save(self, iteration: int, psi: np.ndarray) -> str:
        p = self.path(iteration)
        if self.fmt == "npz":
            save_stack_npz(p, psi=np.asarray(psi, np.float32))
        else:
            write_tiff_stack(p, psi)
        return p

    def load(self, iteration: int) -> np.ndarray:
        p = self.path(iteration)
        if self.fmt == "npz":
            return load_stack_npz(p)["psi"]
        return read_tiff_stack(p)

    def latest(self) -> Optional[Tuple[int, np.ndarray]]:
        """Newest (iteration, psi) snapshot, or None."""
        best = -1
        best_path = None
        for p in glob.glob(os.path.join(self.directory, "psi_*.*")):
            m = _PSI_RE.search(os.path.basename(p))
            if m and int(m.group(1)) > best:
                best, best_path = int(m.group(1)), p
        if best_path is None:
            return None
        return best, self.load(best)


def deconvolve_resilient(
    psi: np.ndarray,
    data: MultiViewData,
    num_iterations: int,
    manager: CheckpointManager,
    max_retries: int = 3,
    on_failure=None,
    **kw,
):
    """Checkpointed deconvolve that survives device/runtime failures.

    The failure-recovery tier the reference lacks entirely (SURVEY.md §5:
    its only resilience is NaN clamping).  On a runtime error (e.g. a device
    or runtime crash/restart) the JAX backends are cleared, device state is
    re-established, and the run resumes from the newest psi_i snapshot.
    ``on_failure(exc, attempt)`` is an optional observer hook.
    """
    attempt = 0
    while True:
        try:
            return deconvolve_checkpointed(
                psi, data, num_iterations, manager, resume=True, **kw
            )
        except Exception as exc:  # jax runtime errors don't share one base
            attempt += 1
            if on_failure is not None:
                on_failure(exc, attempt)
            if attempt > max_retries:
                raise
            try:
                from jax.extend.backend import clear_backends

                clear_backends()
            except Exception:
                pass


def deconvolve_checkpointed(
    psi: np.ndarray,
    data: MultiViewData,
    num_iterations: int,
    manager: CheckpointManager,
    lam: float = 0.0,
    min_value: float = 1e-4,
    checkpoint_every: int = 1,
    resume: bool = True,
    **kw,
):
    """RL deconvolve with periodic psi checkpoints and resume.

    Iterations are chunked outside jit (each chunk is one cached jit program)
    so a crash resumes from the last snapshot: the formalization of the
    reference's 'psi_i.tif as external checkpoint' design (SURVEY.md §5)."""
    start = 0
    if resume:
        latest = manager.latest()
        if latest is not None:
            start, psi = latest
            start += 1  # psi_i is the state AFTER iteration i
    import jax.numpy as jnp

    psi = jnp.asarray(np.asarray(psi, np.float32))
    it = start
    while it < num_iterations:
        chunk = min(checkpoint_every, num_iterations - it)
        psi = deconvolve_jit(
            psi, data, num_iterations=chunk, lam=lam, min_value=min_value, **kw
        )
        it += chunk
        manager.save(it - 1, np.asarray(psi))
    return psi
