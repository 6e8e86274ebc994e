#!/usr/bin/env python
"""Generate the numerical-stability envelope table (docs/STABILITY.md).

Runs the same ladder as tests/test_stability_envelope.py on the current
backend and prints a markdown table of relative L2 roundtrip errors for
both engines.  Run with the default backend for the GPU envelope, or
``--platform cpu`` for the host (pocketfft) column.  ``--precision high``
runs the dense-DFT engine's einsums at 'high' (TF32 on a GPU) instead of
the default 'highest'.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default=None)
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high"])
    args = p.parse_args()

    import jax

    from libmultiviewnative_jax.utils.compile_cache import enable_compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    import jax.numpy as jnp

    from libmultiviewnative_jax.core import dft
    from libmultiviewnative_jax.core.fft import irfft3, rfft3

    dft.set_matmul_precision(args.precision)

    families = [
        ("2^n", [8, 64, 256, 512]),
        ("3^n", [27, 243]),
        ("5^n", [25, 125]),
        ("7^n", [49, 343]),
        ("prime", [13, 127, 251, 509]),
        ("mixed", [96, 160, 320, 384]),
    ]
    dev = jax.devices()[0]
    print(
        f"backend: {dev.platform} ({getattr(dev, 'device_kind', '?')}), "
        f"dft precision: {args.precision}\n"
    )
    print("| family | N (axis) | fft engine rel err | dft engine rel err |")
    print("|---|---|---|---|")
    rng = np.random.default_rng(0)
    worst = 0.0
    for fam, ns in families:
        for n in ns:
            shape = (n, 4, 8)
            x = rng.normal(size=shape).astype(np.float32)
            ref = x.astype(np.float64)

            back_f = np.asarray(irfft3(rfft3(jnp.asarray(x)), shape))
            plan = dft.make_plan(shape)
            re, im = dft.dft3(jnp.asarray(x), plan)
            back_d = np.asarray(dft.idft3(re, im, plan))
            ef = np.linalg.norm(back_f - ref) / np.linalg.norm(ref)
            ed = np.linalg.norm(back_d - ref) / np.linalg.norm(ref)
            worst = max(worst, ef, ed)
            print(f"| {fam} | {n} | {ef:.2e} | {ed:.2e} |")
    print(f"\nworst-case: {worst:.2e}  (test gate: 5e-6)")


if __name__ == "__main__":
    main()
