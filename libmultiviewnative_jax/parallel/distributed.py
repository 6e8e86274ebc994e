"""Multi-host initialization and process-level helpers.

The reference is strictly single-process (SURVEY.md §2.5: no MPI/NCCL/
anything).  This library scales across processes the JAX way: every
process runs the same program, ``jax.distributed.initialize`` wires them
together, and the SAME ('view','z') mesh programs from parallel.sharded run
unchanged — XLA routes the collectives (NCCL between GPUs).  This module holds the thin host-topology glue.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-process cluster.  No-ops when single-process (so the
    same entry script runs everywhere).  Arguments fall back to the standard
    env (JAX_COORDINATOR_ADDRESS etc.)."""
    if num_processes is None and coordinator_address is None:
        auto = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if auto is None:
            return  # single-host run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def describe_topology() -> dict:
    """Structured topology record (the reference's device-query printfs,
    inc/cuda_helpers.cuh:84-136, generalized to a fleet)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": [str(d) for d in jax.local_devices()],
        "global_device_count": jax.device_count(),
        "platform": jax.devices()[0].platform,
    }


def host_local_views(num_views: int) -> range:
    """The contiguous block of view indices this host loads — convention for
    multi-host data loading (each host feeds only its shard; paired with
    jax.make_array_from_process_local_data)."""
    per = -(-num_views // jax.process_count())
    lo = jax.process_index() * per
    return range(lo, min(lo + per, num_views))
