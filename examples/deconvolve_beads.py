#!/usr/bin/env python
"""End-to-end example: synthesize a multi-view acquisition of a bead
phantom, deconvolve it, and write TIFF stacks.

Run:  python examples/deconvolve_beads.py [--size 64] [--views 4]
                                          [--iterations 20] [--out out_dir]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import libmultiviewnative_jax as mvn
from libmultiviewnative_jax.io import write_tiff_stack
from libmultiviewnative_jax.models import RichardsonLucy, WienerFilter
from libmultiviewnative_jax.reference.numpy_ref import (
    np_convolve_spectrum,
    np_wrap_kernel,
)
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--lambda_", type=float, default=0.006)
    p.add_argument("--out", default="beads_out")
    p.add_argument("--platform", default=None,
                   help="force a jax platform, e.g. cpu")
    args = p.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    shape = (args.size,) * 3
    rng = np.random.default_rng(0)

    # ground truth: dim background + bright beads
    phantom = np.full(shape, 1.0)
    for _ in range(args.size // 4):
        z, y, x = (rng.integers(5, s - 5) for s in shape)
        phantom[z, y, x] = 500.0

    # simulate per-view anisotropic blur + Poisson noise
    views = []
    for v in range(args.views):
        psf = gaussian_kernel((9, 9, 9), sigma=1.0 + 0.4 * v)
        blurred = np_convolve_spectrum(
            phantom, np.fft.rfftn(np_wrap_kernel(psf, shape))
        )
        noisy = rng.poisson(np.clip(blurred, 0, None) * 10.0) / 10.0
        views.append(
            mvn.View(
                image=noisy.astype(np.float32),
                kernel1=psf,
                kernel2=np.flip(psf).copy(),
                weights=np.full(shape, 1.0 / args.views, np.float32),
            )
        )

    data = mvn.MultiViewData.from_views(views)

    # fast closed-form preview, then RL from it
    wiener = WienerFilter(nsr=1e-3).run(data)
    import jax.numpy as jnp

    rl = RichardsonLucy(
        num_iterations=args.iterations, lambda_=args.lambda_, auto_dispatch=True
    )
    psi = np.asarray(rl.run(data, psi0=jnp.maximum(wiener, 1e-3)))

    os.makedirs(args.out, exist_ok=True)
    write_tiff_stack(os.path.join(args.out, "phantom.tif"), phantom)
    write_tiff_stack(os.path.join(args.out, "view_0.tif"), np.asarray(views[0].image))
    write_tiff_stack(os.path.join(args.out, "wiener.tif"), np.asarray(wiener))
    write_tiff_stack(os.path.join(args.out, "deconvolved.tif"), psi)

    def rmse(a):
        return float(np.sqrt(np.mean((np.asarray(a, np.float64) - phantom) ** 2)))

    print(f"rmse vs truth: view0={rmse(views[0].image):.3f} "
          f"wiener={rmse(wiener):.3f} rl={rmse(psi):.3f}")
    print(f"wrote {args.out}/{{phantom,view_0,wiener,deconvolved}}.tif")


if __name__ == "__main__":
    main()
