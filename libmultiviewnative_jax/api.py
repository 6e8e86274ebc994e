"""Flat functional API — parity surface for the reference's C ABI.

Mirrors every ``extern "C"`` entry point of
/root/reference/inc/multiviewnative.h:43-109 with numpy-in/numpy-out
functions (the shapes a JNA/ctypes shim marshals; the actual C shim lives
in native/).  The reference mutates ``psi`` in place through raw pointers;
here each call returns the new array (the C shim copies it back into the
caller's buffer, preserving in-place semantics at the ABI boundary).

| reference symbol                              | here                      |
|-----------------------------------------------|---------------------------|
| inplace_cpu_deconvolve (.h:46)                | deconvolve_flat           |
| inplace_gpu_deconvolve (.h:55)                | deconvolve_flat (device=) |
| inplace_cpu_convolution (.h:50)               | convolution3d             |
| inplace_gpu_convolution (.h:60)               | convolution3d (device=)   |
| convolution3DfftCUDAInPlace{,_core} (.h:64-77)| convolution3d (legacy wrap)|
| compute_quotient (.h:84)                      | quotient_flat             |
| compute_final_values (.h:86)                  | final_values_flat         |
| iterate_fft_plain (.h:90)                     | iterate_fft_plain         |
| iterate_fft_tikhonov (.h:95)                  | iterate_fft_tikhonov      |
| getNumDevicesCUDA (.h:101)                    | get_num_devices           |
| getNameDeviceCUDA (.h:103)                    | get_device_name           |
| getMemDeviceCUDA (.h:105)                     | get_device_mem            |
| getMaxThreadsDeviceCUDA / selectDevice... (.h:99,107) | get_device_info   |
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .core.convolve import fft_convolve3d
from .core.kernels import compute_quotient as _quotient
from .core.kernels import final_values as _final_values
from .core.kernels import regularized_final_values as _reg_final_values
from .deconv.rl import deconvolve_jit, prepare_spectra, rl_view_step
from .deconv.workspace import MultiViewData, pad_kernel_to


def _stack(arrays: Sequence[np.ndarray], dtype=np.float32) -> jnp.ndarray:
    return jnp.asarray(np.stack([np.asarray(a, dtype) for a in arrays]))


def deconvolve_flat(
    psi: np.ndarray,
    images: Sequence[np.ndarray],
    kernels1: Sequence[np.ndarray],
    kernels2: Sequence[np.ndarray],
    weights: Sequence[np.ndarray],
    num_iterations: int,
    lambda_: float = 0.006,
    min_value: float = 1e-4,
    view_order: str = "sequential",
) -> np.ndarray:
    """Full multi-view RL — ``inplace_cpu_deconvolve``
    (/root/reference/inc/multiviewnative.h:46, impl src/multiviewnative.cpp:244-256)
    and its GPU twin (.h:55).  Returns the deconvolved psi."""
    k1_shape = tuple(
        max(int(k.shape[d]) for k in kernels1) for d in range(3)
    )
    k2_shape = tuple(
        max(int(k.shape[d]) for k in kernels2) for d in range(3)
    )
    data = MultiViewData(
        views=_stack(images),
        kernel1=_stack([pad_kernel_to(np.asarray(k), k1_shape) for k in kernels1]),
        kernel2=_stack([pad_kernel_to(np.asarray(k), k2_shape) for k in kernels2]),
        weights=_stack(weights),
    )
    out = deconvolve_jit(
        jnp.asarray(np.asarray(psi, np.float32)),
        data,
        num_iterations=int(num_iterations),
        lam=float(lambda_),
        min_value=float(min_value),
        view_order=view_order,
    )
    return np.asarray(out)


def convolution3d(
    image: np.ndarray, kernel: np.ndarray, mode: str = "circular"
) -> np.ndarray:
    """Single 3D FFT convolution — ``inplace_cpu_convolution``
    (/root/reference/inc/multiviewnative.h:50, impl src/multiviewnative.cpp:273-293),
    ``inplace_gpu_convolution`` (.h:60) and the legacy Fiji path
    ``convolution3DfftCUDAInPlace`` (.h:64, impl src/multiviewnative.cu:199-238)."""
    out = fft_convolve3d(
        jnp.asarray(np.asarray(image, np.float32)),
        jnp.asarray(np.asarray(kernel, np.float32)),
        mode=mode,
    )
    return np.asarray(out)


def quotient_flat(input_image: np.ndarray, output_image: np.ndarray) -> np.ndarray:
    """out = input / output — ``compute_quotient``
    (/root/reference/inc/multiviewnative.h:84, impl src/multiviewnative.cu:321-355)."""
    return np.asarray(
        _quotient(
            jnp.asarray(np.asarray(input_image, np.float32)),
            jnp.asarray(np.asarray(output_image, np.float32)),
        )
    )


def final_values_flat(
    psi: np.ndarray,
    integral: np.ndarray,
    weights: np.ndarray,
    lambda_: float = 0.006,
    min_value: float = 1e-4,
) -> np.ndarray:
    """One clamped multiplicative update — ``compute_final_values``
    (/root/reference/inc/multiviewnative.h:86, impl src/multiviewnative.cu:357-393).
    Like the reference, lambda > 0 selects the Tikhonov variant."""
    p = jnp.asarray(np.asarray(psi, np.float32))
    i = jnp.asarray(np.asarray(integral, np.float32))
    w = jnp.asarray(np.asarray(weights, np.float32))
    if lambda_ > 0:
        return np.asarray(_reg_final_values(p, i, w, float(lambda_), float(min_value)))
    return np.asarray(_final_values(p, i, w, float(min_value)))


def _iterate_fft(
    psi, image, kernel1, kernel2, weights, lambda_, min_value
) -> np.ndarray:
    spatial = tuple(np.asarray(psi).shape)
    k1 = prepare_spectra(_stack([kernel1]), spatial)[0]
    k2 = prepare_spectra(_stack([kernel2]), spatial)[0]
    out = rl_view_step(
        jnp.asarray(np.asarray(psi, np.float32)),
        jnp.asarray(np.asarray(image, np.float32)),
        k1,
        k2,
        jnp.asarray(np.asarray(weights, np.float32)),
        float(lambda_),
        float(min_value),
    )
    return np.asarray(out)


def iterate_fft_plain(
    psi, image, kernel1, kernel2, weights, min_value: float = 1e-4
) -> np.ndarray:
    """One full RL view step, plain update — ``iterate_fft_plain``
    (/root/reference/inc/multiviewnative.h:90, impl src/multiviewnative.cu:395-494)."""
    return _iterate_fft(psi, image, kernel1, kernel2, weights, 0.0, min_value)


def iterate_fft_tikhonov(
    psi,
    image,
    kernel1,
    kernel2,
    weights,
    lambda_: float = 0.006,
    min_value: float = 1e-4,
) -> np.ndarray:
    """One full RL view step, Tikhonov update — ``iterate_fft_tikhonov``
    (/root/reference/inc/multiviewnative.h:95, impl src/multiviewnative.cu:496-595)."""
    return _iterate_fft(psi, image, kernel1, kernel2, weights, lambda_, min_value)


# ---------------------------------------------------------------------------
# Device queries — the reference's CUDA device surface
# (/root/reference/inc/multiviewnative.h:99-109, impl inc/cuda_helpers.cuh:47-136)
# recast over jax.devices().
# ---------------------------------------------------------------------------


def get_num_devices() -> int:
    """``getNumDevicesCUDA`` (.h:101)."""
    return jax.device_count()


def get_device_name(device_id: int = 0) -> str:
    """``getNameDeviceCUDA`` (.h:103)."""
    d = jax.devices()[device_id]
    return getattr(d, "device_kind", d.platform)


def get_device_mem(device_id: int = 0) -> int:
    """``getMemDeviceCUDA`` (.h:105) — bytes of device memory, 0 if unknown."""
    d = jax.devices()[device_id]
    try:
        stats = d.memory_stats()
        return int(stats.get("bytes_limit", 0))
    except Exception:
        return 0


def get_device_info(device_id: int = 0) -> dict:
    """``getMaxThreadsDeviceCUDA`` + ``selectDeviceWithHighestComputeCapability``
    analog (.h:99,107): one structured record per device."""
    d = jax.devices()[device_id]
    return {
        "id": d.id,
        "platform": d.platform,
        "kind": getattr(d, "device_kind", ""),
        "process_index": d.process_index,
        "memory_bytes": get_device_mem(device_id),
    }


def select_device() -> int:
    """``selectDeviceWithHighestComputeCapability`` (.h:107): on a homogeneous
    mesh every device is equal — return the default device's id."""
    return jax.devices()[0].id
