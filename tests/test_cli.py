"""CLI end-to-end test: TIFF views in, deconvolved TIFF out."""

import numpy as np
import pytest

from libmultiviewnative_jax.cli import main as cli_main
from libmultiviewnative_jax.io.stacks import read_tiff_stack, write_tiff_stack
from libmultiviewnative_jax.reference.numpy_ref import (
    np_convolve_spectrum,
    np_wrap_kernel,
)
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


def test_cli_roundtrip(tmp_path, capsys):
    shape = (16, 16, 16)
    rng = np.random.default_rng(3)
    phantom = np.full(shape, 1.0)
    phantom[8, 8, 8] = 300.0

    view_args = []
    for v in range(2):
        psf = gaussian_kernel((5, 5, 5), 1.0 + 0.3 * v)
        blurred = np_convolve_spectrum(
            phantom, np.fft.rfftn(np_wrap_kernel(psf, shape))
        ).astype(np.float32)
        vp = str(tmp_path / f"view{v}.tif")
        kp = str(tmp_path / f"psf{v}.tif")
        write_tiff_stack(vp, blurred)
        write_tiff_stack(kp, psf)
        view_args += ["--view", vp, "--psf", kp]

    out = str(tmp_path / "deconv.tif")
    rc = cli_main(view_args + [
        "-o", out, "-i", "8", "--lambda", "0", "--algorithm", "fft",
    ])
    assert rc == 0
    assert "wrote" in capsys.readouterr().out
    result = read_tiff_stack(out)
    assert result.shape == shape
    # deconvolution sharpened the bead
    blurred0 = read_tiff_stack(str(tmp_path / "view0.tif"))
    assert result[8, 8, 8] > blurred0[8, 8, 8]


def test_cli_arg_validation(tmp_path):
    with pytest.raises(SystemExit):
        cli_main(["--view", "a.tif", "-o", "x.tif"])  # missing --psf


def test_cli_h5_roundtrip(tmp_path, capsys):
    """h5 inputs (file:dataset) and h5 output."""
    import h5py

    from libmultiviewnative_jax.io.stacks import save_stack_h5, load_stack_h5

    shape = (12, 12, 12)
    rng = np.random.default_rng(5)
    psf = gaussian_kernel((5, 5, 5), 1.2)
    blurred = np_convolve_spectrum(
        np.full(shape, 1.0), np.fft.rfftn(np_wrap_kernel(psf, shape))
    ).astype(np.float32)

    vp = str(tmp_path / "views.h5")
    save_stack_h5(vp, v0=blurred)
    kp = str(tmp_path / "psf.tif")
    write_tiff_stack(kp, psf)
    out = str(tmp_path / "out.h5")

    rc = cli_main([
        "--view", f"{vp}:v0", "--psf", kp, "-o", out, "-i", "3",
        "--lambda", "0", "--init", "wiener",
    ])
    assert rc == 0
    result = load_stack_h5(out, "psi")
    assert result.shape == shape and np.isfinite(result).all()


def test_open_stack_h5_chunked_reads(tmp_path):
    from libmultiviewnative_jax.io.stacks import open_stack_h5, save_stack_h5

    a = np.random.default_rng(1).normal(size=(20, 6, 6)).astype(np.float32)
    p = str(tmp_path / "c.h5")
    save_stack_h5(p, chunks_z=4, vol=a)
    f, dset = open_stack_h5(p, "vol")
    try:
        np.testing.assert_array_equal(np.asarray(dset[4:8]), a[4:8])
    finally:
        f.close()


def test_cli_rejects_even_psf_without_kernel2(tmp_path):
    """Default kernel2=flip(psf) is a shifted adjoint for even kernel dims
    (the case rl.py's adjoint guard rejects) — the CLI must refuse it."""
    shape = (8, 8, 8)
    view = np.ones(shape, np.float32)
    psf = np.ones((4, 4, 4), np.float32) / 64.0  # even dims
    vp, kp = str(tmp_path / "v.tif"), str(tmp_path / "k.tif")
    write_tiff_stack(vp, view)
    write_tiff_stack(kp, psf)
    with pytest.raises(SystemExit):
        cli_main(["--view", vp, "--psf", kp, "-o", str(tmp_path / "o.tif")])


def test_cli_dispatch_auto(tmp_path):
    """--dispatch auto routes through the capacity ladder (in-core here)
    and produces the same result as the in-core path."""
    shape = (16, 16, 16)
    rng = np.random.default_rng(5)
    view = rng.gamma(2.0, 20.0, shape).astype(np.float32)
    psf = gaussian_kernel((5, 5, 5), 1.0)
    vp, kp = str(tmp_path / "v.tif"), str(tmp_path / "k.tif")
    write_tiff_stack(vp, view)
    write_tiff_stack(kp, psf)
    outs = []
    for mode in ("incore", "auto"):
        op = str(tmp_path / f"out_{mode}.tif")
        rc = cli_main([
            "--view", vp, "--psf", kp, "-o", op, "-i", "2",
            "--dispatch", mode,
        ])
        assert rc == 0
        outs.append(read_tiff_stack(op))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)
