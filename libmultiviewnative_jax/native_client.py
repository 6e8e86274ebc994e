"""ctypes client for the native ABI shim — what a JNA/Fiji caller does,
from Python.

Loads native/build/libmultiviewnative_jax.so (building it via make on
first use if needed) and exposes the reference C ABI
(/root/reference/inc/multiviewnative.h) with ctypes structs.  Used by the
ABI parity tests; also a reference for how external hosts bind the shim.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libmultiviewnative_jax.so")


class ViewData(ctypes.Structure):
    """ABI twin of struct view_data (reference inc/multiviewnative.h:15-26)."""

    _fields_ = [
        ("image_", ctypes.POINTER(ctypes.c_float)),
        ("kernel1_", ctypes.POINTER(ctypes.c_float)),
        ("kernel2_", ctypes.POINTER(ctypes.c_float)),
        ("weights_", ctypes.POINTER(ctypes.c_float)),
        ("image_dims_", ctypes.POINTER(ctypes.c_int)),
        ("kernel1_dims_", ctypes.POINTER(ctypes.c_int)),
        ("kernel2_dims_", ctypes.POINTER(ctypes.c_int)),
        ("weights_dims_", ctypes.POINTER(ctypes.c_int)),
    ]


class WorkspaceStruct(ctypes.Structure):
    """ABI twin of struct workspace (reference inc/multiviewnative.h:28-35)."""

    _fields_ = [
        ("data_", ctypes.POINTER(ViewData)),
        ("num_views_", ctypes.c_ushort),
        ("lambda_", ctypes.c_double),
        ("minValue_", ctypes.c_float),
        ("num_iterations_", ctypes.c_int),
    ]


def build_native(force: bool = False) -> str:
    """Build the shim with make; returns the .so path."""
    if force or not os.path.exists(_SO_PATH):
        subprocess.run(
            ["make", "-C", _NATIVE_DIR], check=True, capture_output=True, text=True
        )
    return _SO_PATH


def load_native(path: Optional[str] = None) -> ctypes.CDLL:
    lib = ctypes.CDLL(path or build_native(), mode=ctypes.RTLD_GLOBAL)
    lib.inplace_cpu_deconvolve.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        WorkspaceStruct,
        ctypes.c_int,
    ]
    lib.inplace_cpu_convolution.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.getNumDevicesCUDA.restype = ctypes.c_int
    lib.getMemDeviceCUDA.restype = ctypes.c_longlong
    lib.getMemDeviceCUDA.argtypes = [ctypes.c_int]
    lib.getNameDeviceCUDA.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.selectDeviceWithHighestComputeCapability.restype = ctypes.c_int
    lib.mvn_jax_last_error.restype = ctypes.c_char_p
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dims(a: np.ndarray):
    return (ctypes.c_int * 3)(*a.shape)


class NativeWorkspace:
    """Builds and OWNS the C structs + dims arrays for a deconvolve call
    (keeps every buffer alive for the duration)."""

    def __init__(
        self,
        images: Sequence[np.ndarray],
        kernels1: Sequence[np.ndarray],
        kernels2: Sequence[np.ndarray],
        weights: Sequence[np.ndarray],
        lambda_: float = 0.0,
        min_value: float = 1e-4,
        num_iterations: int = 1,
    ) -> None:
        n = len(images)
        self._keep: List[object] = []
        self.views = (ViewData * n)()
        for v in range(n):
            arrs = [
                np.ascontiguousarray(a, np.float32)
                for a in (images[v], kernels1[v], kernels2[v], weights[v])
            ]
            dims = [_dims(a) for a in arrs]
            self._keep += arrs + dims
            self.views[v] = ViewData(
                _fptr(arrs[0]),
                _fptr(arrs[1]),
                _fptr(arrs[2]),
                _fptr(arrs[3]),
                dims[0],
                dims[1],
                dims[2],
                dims[3],
            )
        self.struct = WorkspaceStruct(
            ctypes.cast(self.views, ctypes.POINTER(ViewData)),
            n,
            float(lambda_),
            float(min_value),
            int(num_iterations),
        )


def native_deconvolve(
    lib: ctypes.CDLL, psi: np.ndarray, ws: NativeWorkspace
) -> np.ndarray:
    """Run inplace_cpu_deconvolve through the C ABI; psi mutated in place."""
    psi = np.ascontiguousarray(psi, np.float32)
    lib.inplace_cpu_deconvolve(_fptr(psi), ws.struct, 1)
    return psi


def native_convolution(
    lib: ctypes.CDLL, image: np.ndarray, kernel: np.ndarray
) -> np.ndarray:
    image = np.ascontiguousarray(image, np.float32)
    kernel = np.ascontiguousarray(kernel, np.float32)
    lib.inplace_cpu_convolution(
        _fptr(image), _dims(image), _fptr(kernel), _dims(kernel), 1
    )
    return image
