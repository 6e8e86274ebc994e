"""Workspace / view containers — the JAX shape of the C ABI structs.

The reference exposes two flat C structs for JNA clients
(``view_data`` and ``workspace``, /root/reference/inc/multiviewnative.h:15-35):
per view, raw float pointers for image / kernel1 / kernel2 / weights plus
their dims, and global knobs (lambda, minValue, num_iterations).

Redesign: views are STACKED on a leading axis so every FFT,
convolution, and elementwise pass runs batched (and so the view axis can be
sharded over a mesh).  Kernels of heterogeneous per-view shapes are
zero-embedded into the max kernel shape *preserving each kernel's center
voxel* — zero taps are exact no-ops under the wrap convention of
/root/reference/inc/padd_utils.h:11-40, so this changes no math while
giving XLA the static shapes it needs.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.shapes import Shape, as_shape, kernel_center


class WeightNormalizationWarning(UserWarning):
    """Simultaneous-mode weights don't sum to ~1 across views."""


def check_simultaneous_weights(weights, atol: float = 1e-3) -> None:
    """Warn when view weights do not sum to ~1 over the view axis.

    The simultaneous view order blends per-view updates additively
    (psi' = psi + sum_v w_v (new_v - psi)); weights summing to 1 make that
    the natural batched counterpart of the reference's sequential
    w*(new-old)+old step.  Unnormalized weights — legal in the reference's
    per-view sequential update — amplify every sweep by sum(w) and can
    diverge in simultaneous/sharded mode.

    Accepts (V,) scalar weights or (V, Z, Y, X) stacks.  Inside a jit
    trace the values are unknowable — the check is skipped (call this on
    concrete arrays at the dispatch/model layer)."""
    try:
        w = np.asarray(weights)
    except Exception:
        return  # tracer — values not available at trace time
    total = w.sum(axis=0) if w.ndim > 1 else w.sum()
    err = float(np.max(np.abs(np.asarray(total) - 1.0)))
    if err > atol:
        warnings.warn(
            "simultaneous view order expects weights summing to ~1 across "
            f"views (max |sum-1| = {err:.3g}); each sweep is effectively "
            "scaled by sum(w) and may diverge — normalize the weights or "
            "use view_order='sequential'",
            WeightNormalizationWarning,
            stacklevel=3,
        )


@dataclasses.dataclass
class View:
    """One camera view — mirrors ``view_data`` (inc/multiviewnative.h:15-26).

    image   : observed stack phi_v,           (z, y, x) float32
    kernel1 : view PSF P_v,                   (kz, ky, kx)
    kernel2 : compound/adjoint kernel,        (kz', ky', kx')
    weights : per-pixel blending weights w_v, (z, y, x)
    """

    image: np.ndarray
    kernel1: np.ndarray
    kernel2: np.ndarray
    weights: np.ndarray

    def __post_init__(self) -> None:
        if self.image.shape != self.weights.shape:
            raise ValueError(
                f"image {self.image.shape} and weights {self.weights.shape} differ"
            )


def pad_kernel_to(kernel: np.ndarray, target: Sequence[int]) -> np.ndarray:
    """Zero-embed a kernel into ``target`` shape keeping its center voxel.

    The wrap convention places kernel index k//2 at the origin
    (/root/reference/inc/padd_utils.h:25-27).  Padding with lo = T//2 - k//2
    keeps old center at new center, so the wrapped+FFT'd spectrum is
    unchanged — the padded taps are zeros.
    """
    target = as_shape(target)
    c_old = kernel_center(kernel.shape)
    c_new = kernel_center(target)
    lo = tuple(cn - co for cn, co in zip(c_new, c_old))
    hi = tuple(t - k - l for t, k, l in zip(target, kernel.shape, lo))
    for d, (l, h) in enumerate(zip(lo, hi)):
        if l < 0 or h < 0:
            raise ValueError(
                f"kernel {kernel.shape} does not fit target {target} on axis {d}"
            )
    return np.pad(kernel, list(zip(lo, hi)))


def _max_shape(shapes: Sequence[Shape]) -> Shape:
    return tuple(int(max(s[d] for s in shapes)) for d in range(len(shapes[0])))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MultiViewData:
    """Device-resident stacked views: the arrays the RL loop actually consumes.

    views    : (V, Z, Y, X) float32
    kernel1  : (V, K1z, K1y, K1x)  — common (max) kernel1 shape
    kernel2  : (V, K2z, K2y, K2x)
    weights  : (V, Z, Y, X)
    """

    views: jnp.ndarray
    kernel1: jnp.ndarray
    kernel2: jnp.ndarray
    weights: jnp.ndarray

    @property
    def num_views(self) -> int:
        return self.views.shape[0]

    @property
    def spatial_shape(self) -> Shape:
        return tuple(self.views.shape[-3:])

    @classmethod
    def from_views(
        cls,
        views: Sequence[View],
        dtype=jnp.float32,
        shape_policy: str = "strict",
    ) -> "MultiViewData":
        """Stack per-view data; kernels are center-padded to the max shape.

        ``shape_policy`` governs heterogeneous per-view IMAGE shapes — the
        case the reference left as a FIXME ("psi shape should be min over
        views", /root/reference/src/multiviewnative.cpp:154,180):

          * ``"strict"`` (default): hard error — the reference's implicit
            assumption made explicit.
          * ``"common"``: deconvolve the common region.  Every view's
            image and weights are cropped to the elementwise MIN shape
            over views, anchored at the index origin (views share an
            origin-aligned index space in the plugin's workspace
            convention), which is exactly the "min over views" psi shape
            the reference FIXME asks for.  Pure preprocessing: the math on
            the cropped workspace is identical to same-shape inputs.
        """
        if not views:
            raise ValueError("need at least one view")
        shapes = [tuple(v.image.shape) for v in views]
        if len(set(shapes)) > 1:
            if shape_policy == "strict":
                raise ValueError(
                    "all views must share the image shape; got "
                    f"{sorted(set(shapes))}.  Pass shape_policy='common' to "
                    "deconvolve the common (min-shape) region instead."
                )
            if shape_policy != "common":
                raise ValueError(f"unknown shape_policy {shape_policy!r}")
            common = tuple(
                min(s[d] for s in shapes) for d in range(len(shapes[0]))
            )
            sl = tuple(slice(0, c) for c in common)
            views = [
                View(
                    image=np.asarray(v.image)[sl],
                    kernel1=v.kernel1,
                    kernel2=v.kernel2,
                    weights=np.asarray(v.weights)[sl],
                )
                for v in views
            ]
        k1_shape = _max_shape([as_shape(v.kernel1.shape) for v in views])
        k2_shape = _max_shape([as_shape(v.kernel2.shape) for v in views])
        return cls(
            views=jnp.asarray(np.stack([v.image for v in views]), dtype),
            kernel1=jnp.asarray(
                np.stack([pad_kernel_to(v.kernel1, k1_shape) for v in views]), dtype
            ),
            kernel2=jnp.asarray(
                np.stack([pad_kernel_to(v.kernel2, k2_shape) for v in views]), dtype
            ),
            weights=jnp.asarray(np.stack([v.weights for v in views]), dtype),
        )

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.views, self.kernel1, self.kernel2, self.weights), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@dataclasses.dataclass
class Workspace:
    """Algorithm knobs — mirrors ``workspace`` (inc/multiviewnative.h:28-35).

    lambda_  : Tikhonov regularization weight (0 disables; golden-data runs
               use 0.006, /root/reference/tests/tiff_fixtures.hpp:449)
    min_value: clamp floor for the multiplicative update (golden: 1e-4)
    num_iterations: RL sweeps over all views
    """

    data: MultiViewData
    lambda_: float = 0.0
    min_value: float = 1e-4
    num_iterations: int = 1

    @classmethod
    def from_views(
        cls,
        views: Sequence[View],
        lambda_: float = 0.0,
        min_value: float = 1e-4,
        num_iterations: int = 1,
    ) -> "Workspace":
        return cls(
            data=MultiViewData.from_views(views),
            lambda_=float(lambda_),
            min_value=float(min_value),
            num_iterations=int(num_iterations),
        )


def initial_psi(data: MultiViewData, mode: str = "average") -> jnp.ndarray:
    """Build the RL start estimate.

    ``average`` reproduces the golden-data convention: psi_0 is the flat
    per-volume average of the views (/root/reference/tests/tiff_fixtures.hpp:20,
    "psi0 ... particular first guess"); ``copy`` starts from view 0; ``ones``
    is a unit field.
    """
    if mode == "average":
        mean = jnp.mean(data.views)
        return jnp.full(data.spatial_shape, mean, data.views.dtype)
    if mode == "copy":
        return data.views[0]
    if mode == "ones":
        return jnp.ones(data.spatial_shape, data.views.dtype)
    raise ValueError(f"unknown initial psi mode {mode!r}")
