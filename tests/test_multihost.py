"""Two-process multi-host smoke test over localhost.

Validates the parallel.distributed glue with a REAL jax.distributed
cluster: 2 CPU processes, a global mesh, one psum — the multi-host tier
the reference has no notion of (SURVEY.md §2.5)."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
coordinator, n, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

from libmultiviewnative_jax.parallel.distributed import (
    describe_topology,
    host_local_views,
    initialize_multihost,
)

initialize_multihost(coordinator_address=coordinator, num_processes=n,
                     process_id=pid)
topo = describe_topology()
assert topo["process_count"] == n, topo
assert topo["process_index"] == pid, topo

# every process owns a disjoint slice of the views
mine = set(host_local_views(6))
assert len(mine) == 3

import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import numpy as np

mesh = Mesh(np.asarray(jax.devices()), ("d",))
# global array: each process contributes its local block
local = np.full((1, 4), float(pid), np.float32)
arr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("d", None)), local, (n, 4)
)
total = jax.jit(lambda a: jnp.sum(a))(arr)
# sum over both process blocks = 0*4 + 1*4 = 4
assert float(total) == 4.0, float(total)
print(f"proc {pid} OK", flush=True)
"""


_DECONV_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
coordinator, n, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

from libmultiviewnative_jax.parallel.distributed import initialize_multihost

initialize_multihost(coordinator_address=coordinator, num_processes=n,
                     process_id=pid)
assert jax.device_count() == 4 * n

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from libmultiviewnative_jax.deconv.rl import deconvolve
from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.parallel.sharded import (
    deconvolve_sharded_jit,
    make_mesh,
)
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

# identical data generated on every host (same seed)
rng = np.random.default_rng(0)
V, shape = 4, (8, 8, 8)
views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
k1 = np.stack([gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(V)])
k2 = np.flip(k1, axis=(1, 2, 3)).copy()
w = np.full((V,) + shape, 1.0 / V, np.float32)
psi0 = np.full(shape, float(views.mean()), np.float32)

# 4 view-shards x 2 z-blocks over the 8 global devices (2 processes)
mesh = make_mesh(view_parallel=4, z_parallel=2)


def mk(arr, spec):
    s = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        arr.shape, s, lambda idx: arr[idx]
    )


data = MultiViewData(
    views=mk(views, P("view", "z", None, None)),
    kernel1=mk(k1, P("view", None, None, None)),
    kernel2=mk(k2, P("view", None, None, None)),
    weights=mk(w, P("view", "z", None, None)),
)
psi = mk(psi0, P("z", None, None))
out = deconvolve_sharded_jit(
    psi, data, num_iterations=2, mesh=mesh, lam=0.006
)

# single-process truth: the simultaneous update on one local device
want = np.asarray(
    deconvolve(
        jnp.asarray(psi0),
        MultiViewData(
            views=jnp.asarray(views), kernel1=jnp.asarray(k1),
            kernel2=jnp.asarray(k2), weights=jnp.asarray(w),
        ),
        2, lam=0.006, view_order="simultaneous",
    )
)
for sh in out.addressable_shards:
    got = np.asarray(sh.data)
    np.testing.assert_allclose(got, want[sh.index], rtol=2e-5, atol=2e-4)

# ---- shard-wise loader: each process must read ONLY the views whose
# shards it addresses (the multi-host loading contract, parallel.loader)
from libmultiviewnative_jax.parallel.loader import load_sharded_workspace

calls = []


def reader_for(v):
    def r(zs):
        calls.append(v)
        return views[v][zs]

    return r


psi_l, data_l = load_sharded_workspace(
    mesh, [reader_for(v) for v in range(V)], list(k1), list(k2),
    [w[v] for v in range(V)], shape, psi0=lambda zs: psi0[zs],
)
local_views = {
    sh.index[0].start for sh in data_l.views.addressable_shards
}
assert calls and set(calls) <= local_views, (sorted(set(calls)), local_views)
for sh in data_l.views.addressable_shards:
    np.testing.assert_array_equal(np.asarray(sh.data), views[sh.index])
out2 = deconvolve_sharded_jit(psi_l, data_l, num_iterations=2, mesh=mesh,
                              lam=0.006)
for sh in out2.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(sh.data), want[sh.index], rtol=2e-5, atol=2e-4
    )

# ---- the dense-DFT engine through the real process boundary: explicit
# algorithm='dft' runs the z-block overlap-save einsum path on this CPU
# cluster; every process's shards must match the single-device
# simultaneous result.
out3 = deconvolve_sharded_jit(
    mk(psi0, P("z", None, None)), data, num_iterations=1, mesh=mesh,
    lam=0.006, algorithm="dft",
)
want_f = np.asarray(
    deconvolve(
        jnp.asarray(psi0),
        MultiViewData(
            views=jnp.asarray(views), kernel1=jnp.asarray(k1),
            kernel2=jnp.asarray(k2), weights=jnp.asarray(w),
        ),
        1, lam=0.006, view_order="simultaneous",
    )
)
for sh in out3.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(sh.data), want_f[sh.index], rtol=5e-4, atol=5e-4
    )
print(f"proc {pid} DFT OK", flush=True)

# ---- round-5: SEQUENTIAL (reference-parity) math on a z-only mesh
# across the SAME 2-process cluster — the reference's exact view loop
# over z-sharded overlap-save convolves (8 z-shards, bz == halo == 1)
mesh_z = make_mesh(view_parallel=1, z_parallel=8)


def mkz(arr, spec):
    s = NamedSharding(mesh_z, spec)
    return jax.make_array_from_callback(arr.shape, s, lambda idx: arr[idx])


data_z = MultiViewData(
    views=mkz(views, P(None, "z", None, None)),
    kernel1=mkz(k1, P(None, None, None, None)),
    kernel2=mkz(k2, P(None, None, None, None)),
    weights=mkz(w, P(None, "z", None, None)),
)
out4 = deconvolve_sharded_jit(
    mkz(psi0, P("z", None, None)), data_z, num_iterations=2, mesh=mesh_z,
    lam=0.006, view_order="sequential",
)
want_seq = np.asarray(
    deconvolve(
        jnp.asarray(psi0),
        MultiViewData(
            views=jnp.asarray(views), kernel1=jnp.asarray(k1),
            kernel2=jnp.asarray(k2), weights=jnp.asarray(w),
        ),
        2, lam=0.006, view_order="sequential",
    )
)
for sh in out4.addressable_shards:
    np.testing.assert_allclose(
        np.asarray(sh.data), want_seq[sh.index], rtol=2e-5, atol=2e-4
    )
print(f"proc {pid} DECONV OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(420)
def test_two_process_sharded_deconvolve(tmp_path):
    """The distributed claim, backed by the actual RL program: a 2-process
    x 4-device ('view','z') mesh runs deconvolve_sharded end to end and
    every process's output shards match the single-device simultaneous
    result (SURVEY.md §4's missing multi-host tier).  The dense-DFT
    engine and the sequential z-only parity mode each cross the process
    boundary too."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", "-c", _DECONV_WORKER, coordinator, "2",
             str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=390)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed CPU cluster timed out in this environment")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    for pid in (0, 1):
        for tag in ("DFT OK", "DECONV OK"):
            assert any(f"proc {pid} {tag}" in o for o in outs), (pid, tag)


@pytest.mark.timeout(180)
def test_two_process_cluster(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", "-c", _WORKER, coordinator, "2", str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed CPU cluster timed out in this environment")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    assert any("proc 0 OK" in o for o in outs)
    assert any("proc 1 OK" in o for o in outs)
