"""Shard-wise multi-host data loading for the ('view','z') mesh.

The reference loads whole TIFF volumes into host RAM and pushes them over
PCIe (tests/tiff_fixtures.hpp ViewFromDisk + inc/cuda_memory.cuh push) —
one process, one device, full copies.  With several processes the idiomatic
load path is the inverse: EVERY host runs this same code, and each host reads
only the bytes its addressable device shards need.  The mechanism is
``jax.make_array_from_callback`` — JAX hands us the global index of every
addressable shard, we fetch exactly that slab from storage (z-chunked
HDF5 makes the read O(slab)), and the result is a single global
``jax.Array`` laid out for parallel.sharded's programs.

Sources per view may be:
  * ``np.ndarray``            — already in host RAM (sliced per shard),
  * ``"file.h5:dataset"``     — z-chunked HDF5 (io.stacks.save_stack_h5),
    each shard read touches only its z-slab's chunks,
  * ``"file.tif"`` / ``"file.npz:name"`` — whole-file formats (read once
    per process, then sliced; fine for small stacks),
  * ``callable(zslice) -> np.ndarray`` — anything else (e.g. a network
    fetch); must return the (len(zslice), Y, X) slab.

This is the loader leg of the multi-host story (ROADMAP #5): pair with
parallel.distributed.initialize_multihost + parallel.sharded.make_mesh,
and the same script scales from 1 chip to a multi-slice fleet with no
per-host data staging logic.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..deconv.workspace import MultiViewData

Source = Union[np.ndarray, str, Callable[[slice], np.ndarray]]


def as_reader(src: Source) -> Callable[[slice], np.ndarray]:
    """Normalize a view source to ``reader(zslice) -> (dz, Y, X) float32``."""
    if callable(src):
        return src
    if isinstance(src, np.ndarray):
        arr = np.asarray(src, np.float32)
        return lambda zs: arr[zs]
    if isinstance(src, str):
        if ".h5:" in src or ".hdf5:" in src:
            path, name = src.rsplit(":", 1)

            def read_h5(zs: slice) -> np.ndarray:
                import h5py

                # open per read: h5py handles are not picklable/shareable
                # across the loader's callers, and chunked reads are cheap
                with h5py.File(path, "r") as f:
                    return np.asarray(f[name][zs], np.float32)

            return read_h5
        if ".npz:" in src:
            path, name = src.rsplit(":", 1)
            from ..io.stacks import load_stack_npz

            arr = load_stack_npz(path)[name].astype(np.float32)
            return lambda zs: arr[zs]
        # whole-file formats: TIFF (or extensionless)
        from ..io.stacks import read_tiff_stack

        arr = read_tiff_stack(src)
        return lambda zs: arr[zs]
    raise TypeError(f"unsupported view source {type(src).__name__}")


def make_sharded_stack(
    mesh: Mesh,
    readers: Sequence[Callable[[slice], np.ndarray]],
    spatial_shape: Sequence[int],
    spec: P = P("view", "z", None, None),
) -> jax.Array:
    """Assemble a global (V, Z, Y, X) array on the mesh, reading only the
    slabs addressable from this process (one reader call per (view, z-slab)
    shard; JAX dedups identical shard indices across local devices)."""
    V = len(readers)
    gshape = (V,) + tuple(int(s) for s in spatial_shape)
    sharding = NamedSharding(mesh, spec)

    def cb(idx: Tuple[slice, ...]) -> np.ndarray:
        vsl, zsl = idx[0], idx[1]
        vs = range(*vsl.indices(V))
        slabs = [readers[v](zsl)[(...,) + tuple(idx[2:])] for v in vs]
        return np.ascontiguousarray(np.stack(slabs).astype(np.float32))

    return jax.make_array_from_callback(gshape, sharding, cb)


def load_sharded_workspace(
    mesh: Mesh,
    views: Sequence[Source],
    kernel1: Sequence[np.ndarray],
    kernel2: Sequence[np.ndarray],
    weights: Union[Sequence[Source], Sequence[float], np.ndarray],
    spatial_shape: Sequence[int],
    psi0: Optional[Source] = None,
) -> Tuple[jax.Array, MultiViewData]:
    """Build (psi0, MultiViewData) fully placed for deconvolve_sharded,
    reading per-shard slabs only (multi-host safe: call on every process).

    * ``views`` / per-voxel ``weights``: per-view sources (see as_reader).
    * ``weights`` may instead be a (V,) vector of scalars — zero bytes read.
    * kernels are small; they are loaded whole on every process and
      sharded over 'view' (the reference forwards them whole per view too,
      src/gpu_deconvolve_methods.cuh:28-65).
    * ``psi0=None`` gives the reference's flat-average initial guess
      (tests/tiff_fixtures.hpp:453-462 psi_0 convention), computed from
      the already-sharded views with one global mean (a psum under jit).
    """
    shape = tuple(int(s) for s in spatial_shape)
    V = len(views)
    v_readers = [as_reader(s) for s in views]
    views_arr = make_sharded_stack(mesh, v_readers, shape)

    s_k = NamedSharding(mesh, P("view", None, None, None))
    k1 = jax.device_put(np.stack([np.asarray(k, np.float32) for k in kernel1]), s_k)
    k2 = jax.device_put(np.stack([np.asarray(k, np.float32) for k in kernel2]), s_k)

    def _is_scalar(x) -> bool:
        return (
            not callable(x) and not isinstance(x, str) and np.ndim(x) == 0
        )

    if all(_is_scalar(x) for x in weights):
        w = jax.device_put(
            np.asarray([float(x) for x in weights], np.float32),
            NamedSharding(mesh, P("view")),
        )
    else:
        w = make_sharded_stack(mesh, [as_reader(s) for s in weights], shape)

    s_psi = NamedSharding(mesh, P("z", None, None))
    if psi0 is None:
        # flat average initial guess; jnp.mean over the global sharded
        # array compiles to local means + psum — no host gather
        mean = float(jax.jit(jnp.mean)(views_arr))
        psi = jax.device_put(np.full(shape, mean, np.float32), s_psi)
    else:
        r = as_reader(psi0)
        psi = jax.make_array_from_callback(
            shape, s_psi,
            lambda idx: np.ascontiguousarray(
                r(idx[0])[(...,) + tuple(idx[1:])].astype(np.float32)
            ),
        )
    return psi, MultiViewData(views=views_arr, kernel1=k1, kernel2=k2, weights=w)
