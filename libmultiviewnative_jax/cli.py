"""Command-line deconvolution tool.

End-user surface the reference delegates to the Fiji plugin: read per-view
stacks (TIFF or HDF5), run the configured model, write the result.

    python -m libmultiviewnative_jax.cli \
        --view v0.tif --psf psf0.tif --view v1.tif --psf psf1.tif \
        --iterations 20 --lambda 0.006 --output deconvolved.tif

kernel2 defaults to the flipped PSF (plain RL adjoint); pass --kernel2 per
view to supply plugin-computed compound kernels instead.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load(path: str) -> np.ndarray:
    from .io.stacks import load_stack_h5, read_tiff_stack

    if path.endswith((".h5", ".hdf5")):
        data = load_stack_h5(path)
        if len(data) != 1:
            raise SystemExit(f"{path}: expected exactly one dataset, "
                             f"got {sorted(data)}; use name.h5:dataset")
        return next(iter(data.values()))
    if ":" in path and path.rsplit(":", 1)[0].endswith((".h5", ".hdf5")):
        fname, dset = path.rsplit(":", 1)
        from .io.stacks import load_stack_h5

        return load_stack_h5(fname, dset)
    return read_tiff_stack(path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="libmultiviewnative_jax",
        description="multi-view Richardson-Lucy deconvolution (JAX)",
    )
    p.add_argument("--view", action="append", required=True,
                   help="per-view observed stack (repeatable)")
    p.add_argument("--psf", action="append", required=True,
                   help="per-view PSF / kernel1 (repeatable, same order)")
    p.add_argument("--kernel2", action="append", default=None,
                   help="optional per-view compound kernel (default: flip(psf))")
    p.add_argument("--weights", action="append", default=None,
                   help="optional per-view weight stack (default: uniform 1/V)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-i", "--iterations", type=int, default=10)
    p.add_argument("--lambda", dest="lambda_", type=float, default=0.006)
    p.add_argument("--min_value", type=float, default=1e-4)
    p.add_argument("--algorithm", default="auto",
                   choices=["auto", "fft", "dft", "direct"])
    p.add_argument("--dispatch", default="incore", choices=["incore", "auto"],
                   help="'auto' = capacity ladder (in-core / mesh-sharded "
                        "/ interleaved / streamed, deconv.dispatch); "
                        "'incore' = single-device program (default)")
    p.add_argument("--strict", action="store_true",
                   help="with --dispatch auto: error instead of warning "
                        "when a rung cannot honor a requested option")
    p.add_argument("--view_order", default="sequential",
                   choices=["sequential", "simultaneous"])
    p.add_argument("--init", default="average",
                   choices=["average", "copy", "ones", "wiener"])
    p.add_argument("--precision", default="highest", choices=["highest", "high"])
    p.add_argument("--platform", default=None)
    args = p.parse_args(argv)

    if len(args.view) != len(args.psf):
        p.error("need one --psf per --view")
    if args.kernel2 and len(args.kernel2) != len(args.view):
        p.error("need one --kernel2 per --view (or none)")
    if args.weights and len(args.weights) != len(args.view):
        p.error("need one --weights per --view (or none)")

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    from .core.dft import set_matmul_precision

    set_matmul_precision(args.precision)

    import jax.numpy as jnp

    from .deconv.rl import deconvolve_jit
    from .deconv.workspace import MultiViewData, initial_psi, pad_kernel_to
    from .io.stacks import write_tiff_stack
    from .utils.validate import validate_workspace

    V = len(args.view)
    views = [_load(v) for v in args.view]
    psfs = [_load(k).astype(np.float32) for k in args.psf]
    if args.kernel2:
        k2s = [_load(k).astype(np.float32) for k in args.kernel2]
    else:
        # default adjoint kernel2 = flip(psf): under the k//2 wrap-center
        # convention (inc/padd_utils.h:25-27) a flipped EVEN-dim kernel is
        # a one-voxel-shifted adjoint — the exact case the library's
        # adjoint_kernel2 guard rejects.  Refuse instead of silently
        # deconvolving with shifted math.
        for psf_path, k in zip(args.psf, psfs):
            if any(int(d) % 2 == 0 for d in k.shape):
                p.error(
                    f"--psf {psf_path} has even dims {tuple(k.shape)}; the "
                    "default kernel2=flip(psf) is only a valid adjoint for "
                    "odd kernel dims — pass --kernel2 explicitly"
                )
        k2s = [np.flip(k).copy() for k in psfs]
    k1_shape = tuple(max(int(k.shape[d]) for k in psfs) for d in range(3))
    k2_shape = tuple(max(int(k.shape[d]) for k in k2s) for d in range(3))
    weights = (
        jnp.asarray(np.stack([_load(w) for w in args.weights]), jnp.float32)
        if args.weights
        else jnp.full((V,), 1.0 / V, jnp.float32)
    )
    data = MultiViewData(
        views=jnp.asarray(np.stack(views), jnp.float32),
        kernel1=jnp.asarray(np.stack([pad_kernel_to(k, k1_shape) for k in psfs])),
        kernel2=jnp.asarray(np.stack([pad_kernel_to(k, k2_shape) for k in k2s])),
        weights=weights,
    )
    validate_workspace(data)

    if args.init == "wiener":
        from .models.wiener import wiener_deconvolve

        psi0 = jnp.maximum(wiener_deconvolve(data), args.min_value)
    else:
        psi0 = initial_psi(data, args.init)

    if args.dispatch == "auto":
        from .deconv.dispatch import deconvolve_auto

        out = deconvolve_auto(
            psi0,
            data,
            num_iterations=args.iterations,
            lam=args.lambda_,
            min_value=args.min_value,
            view_order=args.view_order,
            algorithm=args.algorithm,
            strict=args.strict,
        )
    else:
        out = deconvolve_jit(
            psi0,
            data,
            num_iterations=args.iterations,
            lam=args.lambda_,
            min_value=args.min_value,
            view_order=args.view_order,
            algorithm=args.algorithm,
        )
    result = np.asarray(out)
    if args.output.endswith((".h5", ".hdf5")):
        from .io.stacks import save_stack_h5

        save_stack_h5(args.output, psi=result)
    else:
        write_tiff_stack(args.output, result)
    print(f"wrote {args.output}  shape={result.shape}  "
          f"range=[{result.min():.4g}, {result.max():.4g}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
