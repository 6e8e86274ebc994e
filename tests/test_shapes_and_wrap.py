"""Tier-1 unit tests: shape arithmetic and kernel wrapping.

Ports the expectations of /root/reference/tests/test_padd_utils.cpp
(no_padd identity :34-42, zero_padd extents/offsets/inserting :116-160)
and the wrap semantics of inc/padd_utils.h:11-40.
"""

import numpy as np
import pytest

from libmultiviewnative_jax.core.shapes import (
    halo_widths,
    is_fast_size,
    kernel_center,
    next_fast_size,
    zero_pad_extents,
    zero_pad_offsets,
)
from libmultiviewnative_jax.core.wrap import (
    crop_at_offsets,
    embed_at_offsets,
    wrap_kernel,
)
from libmultiviewnative_jax.reference.numpy_ref import np_wrap_kernel


def test_zero_pad_extents_and_offsets():
    # test_padd_utils.cpp:116-133 semantics: extents = im + k - 1,
    # offsets = (k - 1)/2
    assert zero_pad_extents((8, 8, 8), (3, 3, 3)) == (10, 10, 10)
    assert zero_pad_offsets((3, 3, 3)) == (1, 1, 1)
    assert zero_pad_extents((8, 9, 10), (4, 3, 2)) == (11, 11, 11)
    assert zero_pad_offsets((4, 3, 2)) == (1, 1, 0)


def test_kernel_center_floor_even_odd():
    # inc/padd_utils.h:25-27 — center = k // 2 (floor), even dims included
    assert kernel_center((3, 3, 3)) == (1, 1, 1)
    assert kernel_center((4, 3, 2)) == (2, 1, 1)


def test_halo_widths():
    lo, hi = halo_widths((3, 3, 3))
    assert lo == (1, 1, 1) and hi == (1, 1, 1)
    lo, hi = halo_widths((4, 3, 2))
    assert lo == (1, 1, 0) and hi == (2, 1, 1)
    assert all(l + h == k - 1 for l, h, k in zip(lo, hi, (4, 3, 2)))


def test_wrap_kernel_places_center_at_origin():
    k = np.zeros((3, 3, 3), np.float32)
    k[1, 1, 1] = 7.0  # center voxel
    w = np.asarray(wrap_kernel(k, (8, 8, 8)))
    assert w[0, 0, 0] == 7.0
    assert np.count_nonzero(w) == 1


def test_wrap_kernel_quadrant_wrap():
    # a full 3^3 ramp: elements "left of center" must land at the far end
    k = np.arange(27, dtype=np.float32).reshape(3, 3, 3) + 1.0
    w = np.asarray(wrap_kernel(k, (6, 6, 6)))
    # kernel[1,1,1] (value 14) is the center -> origin
    assert w[0, 0, 0] == 14.0
    # kernel[0,0,0] (value 1) is at (-1,-1,-1) -> wraps to (5,5,5)
    assert w[5, 5, 5] == 1.0
    # kernel[2,2,2] (value 27) is at (+1,+1,+1)
    assert w[1, 1, 1] == 27.0
    assert np.isclose(w.sum(), k.sum())


def test_wrap_kernel_matches_numpy_reference_even_dims():
    rng = np.random.default_rng(0)
    for kshape in [(3, 3, 3), (4, 3, 2), (2, 2, 2), (5, 4, 3)]:
        k = rng.normal(size=kshape).astype(np.float32)
        ours = np.asarray(wrap_kernel(k, (9, 8, 7)))
        ref = np_wrap_kernel(k, (9, 8, 7))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=0)


def test_embed_and_crop_roundtrip():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(8, 8, 8)).astype(np.float32)
    extents, offsets = (10, 10, 10), (1, 1, 1)
    emb = np.asarray(embed_at_offsets(img, extents, offsets))
    assert emb.shape == extents
    assert np.isclose(emb.sum(), img.sum())
    back = np.asarray(crop_at_offsets(emb, (8, 8, 8), offsets))
    np.testing.assert_array_equal(back, img)


def test_no_padd_is_identity():
    # test_padd_utils.cpp:34-42: no_padd == embed with extents=shape, offsets=0
    img = np.arange(27, dtype=np.float32).reshape(3, 3, 3)
    out = np.asarray(embed_at_offsets(img, (3, 3, 3), (0, 0, 0)))
    np.testing.assert_array_equal(out, img)


def test_fast_sizes():
    assert is_fast_size(8) and is_fast_size(60) and is_fast_size(729)
    assert not is_fast_size(7) and not is_fast_size(61)
    assert next_fast_size(61) == 64
    assert next_fast_size(100) == 100
