"""Workspace container tests (the C-struct mirror layer)."""

import numpy as np
import pytest

import jax.numpy as jnp

from libmultiviewnative_jax.deconv.workspace import (
    MultiViewData,
    View,
    Workspace,
    initial_psi,
    pad_kernel_to,
)
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel, multiview_data


def test_workspace_knob_defaults():
    views = multiview_data(2, (8, 8, 8))
    ws = Workspace.from_views(views, lambda_=0.006, min_value=1e-4,
                              num_iterations=7)
    # mirrors inc/multiviewnative.h:28-35 semantics
    assert ws.lambda_ == 0.006
    assert ws.min_value == 1e-4
    assert ws.num_iterations == 7
    assert ws.data.num_views == 2
    assert ws.data.spatial_shape == (8, 8, 8)


def test_initial_psi_modes():
    views = multiview_data(3, (6, 6, 6))
    data = MultiViewData.from_views(views)
    avg = np.asarray(initial_psi(data, "average"))
    # views are constant 128 -> flat average field of 128
    np.testing.assert_allclose(avg, 128.0, rtol=1e-6)
    copy = np.asarray(initial_psi(data, "copy"))
    np.testing.assert_allclose(copy, np.asarray(data.views[0]))
    ones = np.asarray(initial_psi(data, "ones"))
    np.testing.assert_allclose(ones, 1.0)
    with pytest.raises(ValueError, match="unknown initial psi"):
        initial_psi(data, "nope")


def test_pad_kernel_to_rejects_shrink():
    k = gaussian_kernel((5, 5, 5))
    with pytest.raises(ValueError, match="does not fit"):
        pad_kernel_to(k, (3, 5, 5))


def test_pytree_roundtrip():
    import jax

    views = multiview_data(2, (6, 6, 6))
    data = MultiViewData.from_views(views)
    leaves, treedef = jax.tree_util.tree_flatten(data)
    assert len(leaves) == 4
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    np.testing.assert_array_equal(np.asarray(back.views), np.asarray(data.views))


class TestShapePolicy:
    """Per-view image-shape semantics — the reference's FIXME
    (src/multiviewnative.cpp:154,180: psi shape should be min over views)
    implemented as shape_policy='common'."""

    def _hetero_views(self, rng):
        from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

        shapes = [(12, 10, 10), (10, 12, 10), (10, 10, 12)]
        views = []
        for i, s in enumerate(shapes):
            k = gaussian_kernel((3, 3, 3), 1.0 + 0.2 * i)
            views.append(
                View(
                    image=rng.gamma(2.0, 20.0, s).astype(np.float32),
                    kernel1=k,
                    kernel2=np.flip(k).copy(),
                    weights=np.full(s, 1.0 / 3, np.float32),
                )
            )
        return views

    def test_strict_raises_with_hint(self, rng):
        with pytest.raises(ValueError, match="shape_policy='common'"):
            MultiViewData.from_views(self._hetero_views(rng))

    def test_common_crops_to_min_shape(self, rng):
        data = MultiViewData.from_views(
            self._hetero_views(rng), shape_policy="common"
        )
        assert data.spatial_shape == (10, 10, 10)
        assert data.views.shape == (3, 10, 10, 10)
        assert data.weights.shape == (3, 10, 10, 10)

    def test_common_matches_manual_crop_and_float64_mirror(self, rng):
        """Golden check: common-region deconvolution == deconvolving the
        manually cropped workspace, and both track the float64 mirror."""
        import jax.numpy as jnp

        from libmultiviewnative_jax.deconv.rl import deconvolve_jit
        from libmultiviewnative_jax.reference.numpy_ref import np_deconvolve
        from libmultiviewnative_jax.reference.oracle import rms

        views = self._hetero_views(rng)
        data = MultiViewData.from_views(views, shape_policy="common")
        sl = (slice(0, 10),) * 3
        cropped = [
            View(
                image=np.asarray(v.image)[sl],
                kernel1=v.kernel1,
                kernel2=v.kernel2,
                weights=np.asarray(v.weights)[sl],
            )
            for v in views
        ]
        manual = MultiViewData.from_views(cropped)
        psi0 = jnp.full((10, 10, 10), float(jnp.mean(data.views)), jnp.float32)
        a = np.asarray(deconvolve_jit(psi0.copy(), data, 3, lam=0.006))
        b = np.asarray(deconvolve_jit(psi0.copy(), manual, 3, lam=0.006))
        np.testing.assert_array_equal(a, b)
        gold = np_deconvolve(
            np.asarray(psi0, np.float64),
            [np.asarray(v.image, np.float64) for v in cropped],
            [np.asarray(data.kernel1[i]) for i in range(3)],
            [np.asarray(data.kernel2[i]) for i in range(3)],
            [np.asarray(v.weights, np.float64) for v in cropped],
            3,
            lam=0.006,
        )
        assert rms(a, gold) < 1e-4

    def test_bad_policy_rejected(self, rng):
        with pytest.raises(ValueError, match="shape_policy"):
            MultiViewData.from_views(
                self._hetero_views(rng), shape_policy="resize"
            )


class TestWeightNormalizationAudit:
    def _data(self, rng, wscale):
        from libmultiviewnative_jax.utils.synthetic import gaussian_kernel

        V, shape = 2, (8, 8, 8)
        k1 = np.stack(
            [gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(V)]
        )
        import jax.numpy as jnp

        return MultiViewData(
            views=jnp.asarray(
                rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
            ),
            kernel1=jnp.asarray(k1),
            kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
            weights=jnp.full((V,) + shape, wscale / V, jnp.float32),
        )

    def test_unnormalized_weights_warn_in_simultaneous(self, rng):
        import jax.numpy as jnp

        from libmultiviewnative_jax.deconv.rl import deconvolve
        from libmultiviewnative_jax.deconv.workspace import (
            WeightNormalizationWarning,
        )

        data = self._data(rng, wscale=3.0)  # sums to 3 across views
        psi0 = jnp.full((8, 8, 8), float(jnp.mean(data.views)), jnp.float32)
        with pytest.warns(WeightNormalizationWarning):
            deconvolve(psi0, data, 1, view_order="simultaneous")

    def test_normalized_weights_silent(self, rng):
        import warnings as _w

        import jax.numpy as jnp

        from libmultiviewnative_jax.deconv.rl import deconvolve

        data = self._data(rng, wscale=1.0)
        psi0 = jnp.full((8, 8, 8), float(jnp.mean(data.views)), jnp.float32)
        with _w.catch_warnings():
            _w.simplefilter("error")
            deconvolve(psi0, data, 1, view_order="simultaneous")

    def test_scalar_weights_checked(self):
        import jax.numpy as jnp

        from libmultiviewnative_jax.deconv.workspace import (
            WeightNormalizationWarning,
            check_simultaneous_weights,
        )

        with pytest.warns(WeightNormalizationWarning):
            check_simultaneous_weights(jnp.asarray([0.9, 0.9]))
        check_simultaneous_weights(jnp.asarray([0.5, 0.5]))  # silent
