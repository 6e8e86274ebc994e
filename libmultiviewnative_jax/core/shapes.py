"""Shape arithmetic for padding / cropping / FFT layout.

Re-design of the reference's padding policies (reference
``inc/padd_utils.h:42-249``) and FFT shape helpers (reference
``inc/image_stack_utils.h:24-94``).  Everything here is *static* Python
arithmetic executed at trace time, so the resulting XLA programs have fully
static shapes (jit compiles one program per shape).

Conventions (identical to the reference):
  * stacks are 3D, C-order, axes (z, y, x)
    (``/root/reference/inc/image_stack_utils.h:10-21``)
  * ``zero_pad`` extents  = image + kernel - 1   per axis
    (``/root/reference/inc/padd_utils.h:133-134``)
  * ``zero_pad`` offsets  = (kernel - 1) // 2    per axis
    (``/root/reference/inc/padd_utils.h:136-137``)
  * the kernel "center" used by the wrap is kernel_dim // 2 (floor),
    valid for odd *and even* kernel dims
    (``/root/reference/inc/padd_utils.h:25-27``)
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

Shape = Tuple[int, ...]


def as_shape(dims: Sequence[int]) -> Shape:
    """Normalize any integer sequence into a tuple of Python ints."""
    return tuple(int(d) for d in dims)


def zero_pad_extents(image_shape: Sequence[int], kernel_shape: Sequence[int]) -> Shape:
    """Padded extents for linear ('same') convolution: image + kernel - 1.

    Parity: ``add_minus_1`` at /root/reference/inc/padd_utils.h:42-49,133-134.
    """
    image_shape, kernel_shape = as_shape(image_shape), as_shape(kernel_shape)
    if len(image_shape) != len(kernel_shape):
        raise ValueError(f"rank mismatch: {image_shape} vs {kernel_shape}")
    return tuple(i + k - 1 for i, k in zip(image_shape, kernel_shape))


def zero_pad_offsets(kernel_shape: Sequence[int]) -> Shape:
    """Embedding offsets of the image inside the padded buffer: (k - 1) // 2.

    Parity: ``minus_1_div_2`` at /root/reference/inc/padd_utils.h:51-55,136-137.
    """
    return tuple((k - 1) // 2 for k in as_shape(kernel_shape))


def kernel_center(kernel_shape: Sequence[int]) -> Shape:
    """Index of the kernel's center voxel: k // 2 (floor) per axis.

    This is the origin the wrap moves to index 0 — floor semantics hold for
    even dims too (/root/reference/inc/padd_utils.h:25-27).
    """
    return tuple(k // 2 for k in as_shape(kernel_shape))


def halo_widths(kernel_shape: Sequence[int]) -> Tuple[Shape, Shape]:
    """(lo, hi) halo plane counts needed per axis for a block convolution.

    For out[p] = sum_i kernel[i] * x[p + c - i]  with c = k // 2, the output
    at p reads x over [p - (k-1-c), p + c]; so a block needs ``k-1-c`` planes
    below and ``c`` planes above.  For odd k both equal (k-1)//2.
    """
    ks = as_shape(kernel_shape)
    c = kernel_center(ks)
    lo = tuple(k - 1 - ci for k, ci in zip(ks, c))
    hi = c
    return lo, hi


def num_elements(shape: Sequence[int]) -> int:
    return math.prod(as_shape(shape))


# ---------------------------------------------------------------------------
# FFT-friendly sizes.
#
# The reference does NOT pad to fast FFT sizes (plans are built for the raw
# shape, reference inc/plan_store.h:99-124).  FFT libraries (cuFFT included)
# are far happier with 2^a·3^b·5^c sizes, so we expose an *opt-in* fast-size policy;
# parity mode keeps raw shapes.
# ---------------------------------------------------------------------------

_FAST_RADICES = (2, 3, 5)


def is_fast_size(n: int) -> bool:
    if n < 1:
        return False
    for r in _FAST_RADICES:
        while n % r == 0:
            n //= r
    return n == 1


def next_fast_size(n: int) -> int:
    """Smallest m >= n with m = 2^a · 3^b · 5^c."""
    m = int(n)
    while not is_fast_size(m):
        m += 1
    return m


def next_fast_shape(shape: Sequence[int]) -> Shape:
    return tuple(next_fast_size(d) for d in as_shape(shape))
