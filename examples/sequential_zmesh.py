#!/usr/bin/env python
"""Reference-parity deconvolution at scale: the sequential view loop on a
z-only device mesh (round 5).

The reference's math is view-SEQUENTIAL (each view reads the psi already
updated by the previous view in the same sweep,
/root/reference/src/multiviewnative.cpp:191-228) — which historically
ended at one device's memory.  On a z-only mesh the z-decomposition
lives INSIDE each view step (overlap-save ring halos, exact for the
circular boundary), so the exact reference math scales across devices.

This example runs on 8 virtual CPU devices; on several GPUs the same code
runs over their interconnect (set --platform accordingly / initialize
jax.distributed for several processes).

Run:  python examples/sequential_zmesh.py [--size 32] [--zshards 4]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--zshards", type=int, default=4)
    p.add_argument("--iterations", type=int, default=10)
    args = p.parse_args()

    import jax

    # virtual multi-device CPU mesh for the demo (pre-backend-init)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", max(args.zshards, 1))

    import jax.numpy as jnp

    from libmultiviewnative_jax.deconv.rl import deconvolve_jit
    from libmultiviewnative_jax.deconv.workspace import MultiViewData
    from libmultiviewnative_jax.parallel.sharded import (
        deconvolve_sharded_jit,
        make_mesh,
        shard_workspace,
    )
    from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

    shape = (args.size,) * 3
    rng = np.random.default_rng(0)
    views = rng.gamma(2.0, 20.0, (args.views,) + shape).astype(np.float32)
    k1 = np.stack(
        [gaussian_kernel((7, 7, 7), 1.0 + 0.2 * v) for v in range(args.views)]
    )
    data = MultiViewData(
        views=jnp.asarray(views),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
        weights=jnp.full((args.views,) + shape, 1.0 / args.views, jnp.float32),
    )
    psi0 = jnp.full(shape, float(views.mean()), jnp.float32)

    # z-only mesh: view axis 1 (every device holds every view's z-shard)
    mesh = make_mesh(view_parallel=1, z_parallel=args.zshards)
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    out = np.asarray(
        deconvolve_sharded_jit(
            psi_s, data_s, num_iterations=args.iterations, mesh=mesh,
            lam=0.006, view_order="sequential",
        )
    )

    # the parity claim, checked: identical math to the single-device
    # sequential driver (f32 overlap-save roundoff only)
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, num_iterations=args.iterations, lam=0.006,
            view_order="sequential",
        )
    )
    rms = float(np.sqrt(np.mean((out - want) ** 2)))
    print(f"mesh {dict(mesh.shape)}  sequential parity rms vs single-device: "
          f"{rms:.2e}  (f32 overlap-save roundoff class)")
    assert rms < 5e-5


if __name__ == "__main__":
    main()
