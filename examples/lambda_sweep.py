#!/usr/bin/env python
"""Regularization tuning: sweep Tikhonov λ over a prepared workspace.

Round-5 contract showcase: on the fft/dft engines λ/min_value are RUNTIME
operands, so the whole sweep below reuses ONE compiled program (and the
kernel spectra are forwarded once by prepare_workspace) — the tuning loop
the reference's plan store was built around, with zero recompiles.

Run:  python examples/lambda_sweep.py [--size 48] [--views 4] [--platform cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libmultiviewnative_jax.deconv.rl import (
    deconvolve_prepared,
    prepare_workspace,
)
from libmultiviewnative_jax.deconv.workspace import MultiViewData, initial_psi
from libmultiviewnative_jax.reference.numpy_ref import (
    np_convolve_spectrum,
    np_wrap_kernel,
)
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=48)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--iterations", type=int, default=15)
    p.add_argument("--noise", type=float, default=8.0,
                   help="gaussian read-noise sigma added to the views")
    p.add_argument("--platform", default=None)
    args = p.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    shape = (args.size,) * 3
    rng = np.random.default_rng(0)

    # bead phantom on a flat background
    phantom = np.full(shape, 1.0)
    for _ in range(8):
        z, y, x = (rng.integers(6, s - 6) for s in shape)
        phantom[z, y, x] = 500.0

    views, k1s = [], []
    for v in range(args.views):
        k1 = gaussian_kernel((9, 9, 9), 1.1 + 0.25 * v)
        blur = np_convolve_spectrum(
            phantom, np.fft.rfftn(np_wrap_kernel(k1, shape))
        )
        noisy = blur + rng.normal(0.0, args.noise, shape)
        views.append(np.clip(noisy, 0.0, None).astype(np.float32))
        k1s.append(k1)

    data = MultiViewData(
        views=jnp.asarray(np.stack(views)),
        kernel1=jnp.asarray(np.stack(k1s)),
        kernel2=jnp.asarray(np.stack([np.flip(k) for k in k1s])),
        weights=jnp.full((args.views,), 1.0 / args.views, jnp.float32),
    )

    # forward the kernel spectra ONCE; every sweep call reuses them AND
    # (on this engine) the single compiled RL program
    prepared = prepare_workspace(data, shape, algorithm="fft")
    psi0 = initial_psi(data, "average")

    print(f"{'lambda':>10}  {'rmse vs truth':>14}  cache")
    n0 = deconvolve_prepared._cache_size()  # before the loop: the first
    best = (None, np.inf)                   # row shows its real compile
    for lam in (0.0, 1e-3, 3e-3, 6e-3, 1e-2, 3e-2, 1e-1):
        out = np.asarray(
            deconvolve_prepared(
                jnp.asarray(np.asarray(psi0)), data, prepared,
                num_iterations=args.iterations, lam=lam,
            )
        )
        rmse = float(np.sqrt(np.mean((out - phantom) ** 2)))
        n = deconvolve_prepared._cache_size()
        print(f"{lam:>10.4g}  {rmse:>14.4f}  "
              f"{'compiled' if n != n0 else 'reused'}")
        n0 = n
        if rmse < best[1]:
            best = (lam, rmse)
    print(f"\nbest lambda: {best[0]:g} (rmse {best[1]:.4f}); "
          f"one compiled program served the whole sweep")


if __name__ == "__main__":
    main()
