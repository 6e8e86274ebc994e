"""libmultiviewnative_jax — multi-view Richardson-Lucy deconvolution in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
psteinb/libmultiviewnative (Bayesian multi-view RL deconvolution per
arXiv:1308.0730 Eq. 70; see /root/reference/src/multiviewnative.cpp:62).

Design (not a port):
  * stacks are static-shaped jnp arrays in (z, y, x) C order; views ride a
    leading batch axis so FFTs/convolutions hit the hardware batched,
  * the reference's FFTW/cuFFT plan stores become jit's compilation cache;
    its "forwarded kernels" become precomputed rfft spectra,
  * its OpenMP/CUDA elementwise kernels become one fused XLA elementwise
    chain,
  * its all-on-device/interleaved streaming strategies become sharding:
    views across a mesh axis, Z-blocks with halo exchange for volumes
    beyond one device's memory.
"""

from .core.shapes import (
    as_shape,
    halo_widths,
    kernel_center,
    next_fast_shape,
    zero_pad_extents,
    zero_pad_offsets,
)
from .core.wrap import crop_at_offsets, embed_at_offsets, wrap_kernel
from .core.fft import (
    KernelSpectrumCache,
    default_spectrum_cache,
    forward_kernel_spectrum,
    irfft3,
    rfft3,
)
from .core.kernels import (
    compute_quotient,
    final_values,
    regularized_final_values,
    rl_update,
)
from .core.convolve import (
    convolve3d,
    convolve_spectrum,
    direct_convolve3d,
    fft_convolve3d,
)
from .core.dft import (
    dft3,
    dft_convolve_spectrum,
    idft3,
    kernel_spectrum_split,
    make_plan,
)
from .deconv.workspace import MultiViewData, View, Workspace, initial_psi
from .deconv.rl import deconvolve, deconvolve_jit, rl_view_step
from .deconv.dispatch import deconvolve_auto
from .deconv.streamed import deconvolve_streamed

__version__ = "0.1.0"

__all__ = [
    "as_shape",
    "halo_widths",
    "kernel_center",
    "next_fast_shape",
    "zero_pad_extents",
    "zero_pad_offsets",
    "crop_at_offsets",
    "embed_at_offsets",
    "wrap_kernel",
    "KernelSpectrumCache",
    "default_spectrum_cache",
    "forward_kernel_spectrum",
    "irfft3",
    "rfft3",
    "compute_quotient",
    "final_values",
    "regularized_final_values",
    "rl_update",
    "convolve3d",
    "convolve_spectrum",
    "direct_convolve3d",
    "fft_convolve3d",
    "MultiViewData",
    "View",
    "Workspace",
    "initial_psi",
    "deconvolve",
    "deconvolve_jit",
    "deconvolve_auto",
    "deconvolve_streamed",
    "rl_view_step",
    "dft3",
    "idft3",
    "make_plan",
    "dft_convolve_spectrum",
    "kernel_spectrum_split",
]
