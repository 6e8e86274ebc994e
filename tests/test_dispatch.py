"""Strategy-dispatch tests (reference heuristic analog,
src/multiviewnative.cu:89-142): the three rungs must all produce the same
result, and the estimator must pick sensibly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libmultiviewnative_jax.deconv.dispatch import (
    deconvolve_auto,
    device_capacity_bytes,
    estimate_workspace_bytes,
)
from libmultiviewnative_jax.deconv.rl import deconvolve_jit
from libmultiviewnative_jax.deconv.workspace import MultiViewData
from libmultiviewnative_jax.reference.oracle import rms
from libmultiviewnative_jax.utils.synthetic import gaussian_kernel


def _data(rng, V=2, shape=(16, 8, 8)):
    views = rng.gamma(2.0, 20.0, (V,) + shape).astype(np.float32)
    k1 = np.stack([gaussian_kernel((3, 3, 3), 1.0 + 0.2 * v) for v in range(V)])
    return MultiViewData(
        views=jnp.asarray(views),
        kernel1=jnp.asarray(k1),
        kernel2=jnp.asarray(np.flip(k1, axis=(1, 2, 3)).copy()),
        weights=jnp.full((V,) + shape, 1.0 / V, jnp.float32),
    )


def test_estimator_scales_with_views_and_volume(rng):
    small = estimate_workspace_bytes(_data(rng, V=2, shape=(8, 8, 8)))
    more_views = estimate_workspace_bytes(_data(rng, V=4, shape=(8, 8, 8)))
    bigger = estimate_workspace_bytes(_data(rng, V=2, shape=(16, 8, 8)))
    assert more_views > small and bigger > small


def test_capacity_positive():
    assert device_capacity_bytes() > 0


def test_auto_incore_matches_reference_path(rng):
    data = _data(rng)
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    got = np.asarray(deconvolve_auto(psi0.copy(), data, 2, lam=0.006))
    want = np.asarray(deconvolve_jit(psi0.copy(), data, 2, lam=0.006))
    # auto picks the dft engine at this size; engines agree to transform
    # precision, not bitwise
    assert rms(got, want) < 1e-4


def test_auto_streamed_rung_matches(rng, monkeypatch):
    # force the streamed rung by shrinking the believed capacity;
    # engine pinned so the comparison is engine-matched (algorithm='auto'
    # resolves per-chunk on the streamed rung)
    import libmultiviewnative_jax.deconv.dispatch as dd

    monkeypatch.setattr(dd, "device_capacity_bytes", lambda device=None: 1)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    data = _data(rng)
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    got = np.asarray(
        deconvolve_auto(
            psi0.copy(), data, 2, lam=0.006, chunk_z=8, algorithm="fft"
        )
    )
    want = np.asarray(
        deconvolve_jit(psi0.copy(), data, 2, lam=0.006, algorithm="fft")
    )
    assert rms(got, want) < 1e-5


@pytest.mark.parametrize("algorithm,tol", [("dft", 5e-5), ("fft", 1e-5)])
def test_streamed_rung_honors_algorithm(rng, monkeypatch, algorithm, tol):
    """Option fidelity: the requested engine must actually reach the
    streamed rung's chunk programs (observed via the kernel-operand
    preparation), and the result must still match the in-core engine to
    overlap-save roundoff."""
    import libmultiviewnative_jax.deconv.dispatch as dd
    import libmultiviewnative_jax.deconv.streamed as ds

    monkeypatch.setattr(dd, "device_capacity_bytes", lambda device=None: 1)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    used_algos = set()
    real_operand = ds._kernel_operand

    def spy(kernel, ext_shape, algo, cache):
        used_algos.add(algo)
        return real_operand(kernel, ext_shape, algo, cache)

    monkeypatch.setattr(ds, "_kernel_operand", spy)
    data = _data(rng)
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    got = np.asarray(
        deconvolve_auto(
            psi0.copy(), data, 2, lam=0.006, chunk_z=8, algorithm=algorithm
        )
    )
    assert used_algos == {algorithm}
    want = np.asarray(
        deconvolve_jit(psi0.copy(), data, 2, lam=0.006, algorithm=algorithm)
    )
    # overlap-save transforms run at extended-chunk extents, so agreement
    # is to f32 roundoff, not bitwise
    assert rms(got, want) < tol


def test_auto_sequential_routes_to_zonly_mesh(rng, monkeypatch):
    """Round-5: a too-big SEQUENTIAL request must scale on a z-only mesh
    with the reference's exact view loop — NO divergence warning — and
    match the single-device sequential (parity) result."""
    import warnings

    import libmultiviewnative_jax.deconv.dispatch as dd

    data = _data(rng)
    est = estimate_workspace_bytes(data)
    # too small for in-core, big enough for one device's share of the
    # z-only working set (its replicated halo-extent spectra included)
    monkeypatch.setattr(
        dd, "device_capacity_bytes", lambda device=None: int(est / 1.5)
    )
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error", dd.DispatchDivergenceWarning)
        got = np.asarray(deconvolve_auto(psi0.copy(), data, 2, lam=0.006))
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, 2, lam=0.006, view_order="sequential"
        )
    )
    assert rms(got, want) < 1e-5


def test_auto_sharded_rung_matches(rng, monkeypatch):
    # force the view-sharded rung: capacity tiny but fleet big enough;
    # the z-only parity route is disabled to model a volume with no legal
    # z-only factorization
    import libmultiviewnative_jax.deconv.dispatch as dd

    data = _data(rng)
    est = estimate_workspace_bytes(data)
    monkeypatch.setattr(
        dd, "device_capacity_bytes", lambda device=None: int(est / 4)
    )
    monkeypatch.setattr(dd, "_pick_zonly_mesh", lambda *a, **k: None)
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    # a sequential request served by the (simultaneous) sharded rung must
    # warn LOUDLY — not just under LMVN_TRACE
    with pytest.warns(dd.DispatchDivergenceWarning):
        got = np.asarray(deconvolve_auto(psi0.copy(), data, 2, lam=0.006))
    # sharded runs the simultaneous view order — compare to that
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), data, 2, lam=0.006, view_order="simultaneous"
        )
    )
    assert rms(got, want) < 1e-4


def test_sharded_rung_honors_algorithm(rng, monkeypatch):
    """algorithm='dft' forwarded to the sharded rung (regression: it was
    silently dropped to 'fft' pre round 2).  The round-5 z-only parity
    route is disabled so the request lands on the VIEW-sharded rung."""
    import libmultiviewnative_jax.deconv.dispatch as dd

    data = _data(rng)
    est = estimate_workspace_bytes(data)
    monkeypatch.setattr(
        dd, "device_capacity_bytes", lambda device=None: int(est / 4)
    )
    monkeypatch.setattr(dd, "_pick_zonly_mesh", lambda *a, **k: None)
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    with pytest.warns(dd.DispatchDivergenceWarning):
        got = np.asarray(
            deconvolve_auto(psi0.copy(), data, 2, lam=0.006, algorithm="dft")
        )
    from libmultiviewnative_jax.parallel.sharded import (
        deconvolve_sharded_jit,
        make_mesh,
        shard_workspace,
    )

    mesh = dd._pick_mesh(data.num_views, 16, jax.device_count())
    psi_s, data_s = shard_workspace(data, psi0.copy(), mesh)
    want = np.asarray(
        deconvolve_sharded_jit(
            psi_s, data_s, num_iterations=2, mesh=mesh, lam=0.006,
            algorithm="dft",
        )
    )
    assert rms(got, want) < 1e-6


def test_strict_mode_raises_on_divergence(rng, monkeypatch):
    import libmultiviewnative_jax.deconv.dispatch as dd

    data = _data(rng)
    est = estimate_workspace_bytes(data)
    monkeypatch.setattr(
        dd, "device_capacity_bytes", lambda device=None: int(est / 4)
    )
    # no z-only factorization: the sequential request can only be served
    # by the simultaneous view-sharded mesh -> strict divergence
    monkeypatch.setattr(dd, "_pick_zonly_mesh", lambda *a, **k: None)
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    with pytest.raises(ValueError, match="SIMULTANEOUS"):
        deconvolve_auto(psi0.copy(), data, 2, strict=True)
    # simultaneous request on the streamed rung also diverges
    monkeypatch.setattr(dd, "device_capacity_bytes", lambda device=None: 1)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="SEQUENTIAL"):
        deconvolve_auto(
            psi0.copy(), data, 2, view_order="simultaneous", strict=True
        )


def test_auto_streamed_honors_adjoint_kernel2(rng, monkeypatch):
    """Regression: adjoint_kernel2 must not be dropped when dispatch falls
    to the streamed rung (a stale data.kernel2 must stay ignored)."""
    import libmultiviewnative_jax.deconv.dispatch as dd

    data = _data(rng)  # (3,3,3) kernels - odd, adjoint-eligible
    # poison kernel2 so using it would visibly change the result
    poisoned = MultiViewData(
        views=data.views,
        kernel1=data.kernel1,
        kernel2=jnp.ones_like(data.kernel2) / data.kernel2[0].size,
        weights=data.weights,
    )
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    want = np.asarray(
        deconvolve_jit(
            psi0.copy(), poisoned, 2, adjoint_kernel2=True, algorithm="fft"
        )
    )
    monkeypatch.setattr(dd, "device_capacity_bytes", lambda device=None: 1)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    got = np.asarray(
        deconvolve_auto(
            psi0.copy(), poisoned, 2, adjoint_kernel2=True, chunk_z=8,
            algorithm="fft",
        )
    )
    assert rms(got, want) < 1e-5


def test_auto_mesh_factorization_falls_back_to_stream(rng, monkeypatch):
    """Regression: V=2 views, Z=15 (odd) on an 8-device fleet has no valid
    ('view','z') factorization — dispatch must stream, not crash.  (The
    round-5 z-only parity route is disabled here: Z=15 DOES have a 1x5
    z-only factorization, which is covered by its own test above.)"""
    import libmultiviewnative_jax.deconv.dispatch as dd

    monkeypatch.setattr(dd, "_pick_zonly_mesh", lambda *a, **k: None)
    data = _data(rng, V=2, shape=(15, 8, 8))
    psi0 = jnp.full((15, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    est = dd.estimate_workspace_bytes(data)
    monkeypatch.setattr(
        dd, "device_capacity_bytes", lambda device=None: int(est / 2)
    )
    got = np.asarray(
        deconvolve_auto(psi0.copy(), data, 2, chunk_z=5, algorithm="fft")
    )
    want = np.asarray(deconvolve_jit(psi0.copy(), data, 2, algorithm="fft"))
    assert rms(got, want) < 1e-5


def test_model_view_order_honored_under_auto_dispatch(rng):
    from libmultiviewnative_jax.models import RichardsonLucy

    data = _data(rng)
    model = RichardsonLucy(
        num_iterations=2, view_order="simultaneous", algorithm="fft",
        auto_dispatch=True,
    )
    got = np.asarray(model.run(data))
    psi0 = jnp.full((16, 8, 8), float(jnp.mean(data.views)), jnp.float32)
    want = np.asarray(
        deconvolve_jit(psi0, data, 2, view_order="simultaneous")
    )
    assert rms(got, want) < 1e-6


@pytest.mark.parametrize(
    "backend,shape,want",
    [
        ("cpu", (64, 64, 64), "dft"),
        ("cpu", (256, 256, 256), "dft"),
        ("cpu", (257, 16, 16), "fft"),
        ("cpu", (512, 512, 512), "fft"),
        ("cpu", (300, 1024, 1024), "fft"),
        ("gpu", (16, 16, 16), "fft"),
        ("gpu", (256, 256, 256), "fft"),
        ("gpu", (512, 512, 512), "fft"),
        ("gpu", (300, 1024, 1024), "fft"),
        ("some-other-backend", (16, 16, 16), "fft"),
    ],
)
def test_resolve_algorithm_policy(backend, shape, want):
    """The one engine policy: on the CPU the dense DFT up to 256/axis and
    XLA's FFT above; on a GPU (cuFFT) and any other backend, fft."""
    from libmultiviewnative_jax.deconv.policy import resolve_algorithm

    assert resolve_algorithm("auto", shape, backend) == want


@pytest.mark.parametrize("algorithm", ["fft", "dft", "direct"])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_resolve_algorithm_explicit_passthrough(algorithm, backend):
    from libmultiviewnative_jax.deconv.policy import resolve_algorithm

    assert resolve_algorithm(algorithm, (512, 512, 512), backend) == algorithm


def test_resolve_algorithm_defaults_to_running_backend():
    from libmultiviewnative_jax.deconv.policy import resolve_algorithm

    assert jax.default_backend() == "cpu"
    assert resolve_algorithm("auto", (256, 256, 256)) == "dft"


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_capacity_reads_allocator_limit():
    from libmultiviewnative_jax.deconv.dispatch import device_capacity_bytes

    dev = _FakeDevice("gpu", {"bytes_limit": 60 * 1024**3, "bytes_in_use": 0})
    assert device_capacity_bytes(dev) == 60 * 1024**3


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_capacity_accelerator_without_limit_raises(stats):
    from libmultiviewnative_jax.deconv.dispatch import device_capacity_bytes

    with pytest.raises(RuntimeError, match="bytes_limit"):
        device_capacity_bytes(_FakeDevice("gpu", stats))


def test_capacity_cpu_uses_named_test_default():
    from libmultiviewnative_jax.deconv.dispatch import (
        CPU_TEST_CAPACITY_BYTES,
        device_capacity_bytes,
    )

    assert device_capacity_bytes(_FakeDevice("cpu", None)) == (
        CPU_TEST_CAPACITY_BYTES
    )
    assert device_capacity_bytes() == CPU_TEST_CAPACITY_BYTES


def test_zonly_estimate_counts_replicated_spectra(rng):
    """Every device of a z-only mesh holds BOTH spectra of EVERY view at
    its halo-extended block extent — so the per-device working set is
    larger than the in-core estimate split zp ways."""
    from libmultiviewnative_jax.deconv.dispatch import (
        estimate_zonly_bytes_per_device,
    )

    data = _data(rng, V=4, shape=(64, 16, 16))
    est = estimate_workspace_bytes(data, "fft")
    for zp in (2, 4, 8):
        per_dev = estimate_zonly_bytes_per_device(data, zp, "fft")
        assert per_dev > est // zp
    # halos grow the per-device spectra: a wider kernel costs more
    wide = MultiViewData(
        views=data.views,
        kernel1=jnp.asarray(np.stack([gaussian_kernel((9, 9, 9), 1.5)] * 4)),
        kernel2=data.kernel2,
        weights=data.weights,
    )
    assert estimate_zonly_bytes_per_device(wide, 8, "fft") > (
        estimate_zonly_bytes_per_device(data, 8, "fft")
    )


def test_zonly_mesh_refused_when_per_device_set_overflows(rng):
    """A cap that the old `est < cap * zp` test accepted but that cannot
    hold one device's share of the z-only working set must not pick the
    mesh."""
    import libmultiviewnative_jax.deconv.dispatch as dd

    data = _data(rng, V=4, shape=(64, 16, 16))
    est = estimate_workspace_bytes(data, "fft")
    per8 = dd.estimate_zonly_bytes_per_device(data, 8, "fft")
    cap = (est // 8 + per8) // 2  # est < cap * 8, yet per8 > cap
    assert est < cap * 8 and per8 > cap
    mesh = dd._pick_zonly_mesh(data, 8, "fft", cap)
    assert mesh is None or mesh.shape["z"] < 8
    roomy = dd._pick_zonly_mesh(data, 8, "fft", per8 + 1)
    assert roomy is not None and roomy.shape["z"] == 8


def test_auto_direct_request_demoted_on_mesh(rng, monkeypatch):
    """'direct' runs in-core and on the streamed rung only: when dispatch
    lands on the view-sharded mesh it must warn and fall back to the
    mesh's 'auto', not crash."""
    import libmultiviewnative_jax.deconv.dispatch as dd

    data = _data(rng)
    est = estimate_workspace_bytes(data, "direct")
    monkeypatch.setattr(
        dd, "device_capacity_bytes", lambda device=None: int(est / 4)
    )
    psi0 = jnp.full(data.spatial_shape, 100.0, jnp.float32)
    with pytest.warns(dd.DispatchDivergenceWarning, match="'direct'"):
        out = deconvolve_auto(
            psi0.copy(), data, num_iterations=2, algorithm="direct",
            view_order="simultaneous",
        )
    ref = deconvolve_jit(
        psi0.copy(), data, num_iterations=2, algorithm="fft",
        view_order="simultaneous",
    )
    assert rms(np.asarray(out), np.asarray(ref)) < 1e-4


def test_auto_interleaved_rung_matches(rng, monkeypatch):
    """Capacity between the interleaved estimate and the in-core estimate
    selects the interleaved rung (psi on device, views streamed), which
    must match the in-core sequential result."""
    from libmultiviewnative_jax.deconv.dispatch import (
        estimate_interleaved_bytes,
    )
    import libmultiviewnative_jax.deconv.interleaved as il

    data = _data(rng)
    psi0 = jnp.full(data.spatial_shape, 100.0, jnp.float32)
    est_il = estimate_interleaved_bytes(data, "fft")
    est_ic = estimate_workspace_bytes(data, "fft")
    assert est_il < est_ic
    cap = (est_il + est_ic) // 2

    called = {}
    orig = il.deconvolve_interleaved

    def spy(*a, **kw):
        called["yes"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(il, "deconvolve_interleaved", spy)
    monkeypatch.setattr(
        "libmultiviewnative_jax.deconv.dispatch.device_capacity_bytes",
        lambda device=None: int(cap / 0.9) + 1,
    )
    monkeypatch.setattr("jax.device_count", lambda: 1)
    out = deconvolve_auto(
        psi0, data, num_iterations=2, algorithm="fft", chunk_z=8
    )
    assert called.get("yes")
    ref = deconvolve_jit(psi0, data, num_iterations=2, algorithm="fft")
    assert rms(np.asarray(out), np.asarray(ref)) < 1e-4


@pytest.mark.parametrize("algorithm", ["fft", "dft"])
def test_engine_honored_on_interleaved_rung(rng, monkeypatch, algorithm):
    """The interleaved rung runs both spectral engines: an explicit
    request served there must pass through with NO divergence warning
    (and match the in-core result of the same engine)."""
    import warnings as _w

    from libmultiviewnative_jax.deconv.dispatch import (
        DispatchDivergenceWarning,
        estimate_interleaved_bytes,
    )

    data = _data(rng)
    psi0 = jnp.full(data.spatial_shape, 100.0, jnp.float32)
    est_il = estimate_interleaved_bytes(data, algorithm)
    est_ic = estimate_workspace_bytes(data, algorithm)
    cap = (est_il + est_ic) // 2
    monkeypatch.setattr(
        "libmultiviewnative_jax.deconv.dispatch.device_capacity_bytes",
        lambda device=None: int(cap / 0.9) + 1,
    )
    monkeypatch.setattr("jax.device_count", lambda: 1)
    with _w.catch_warnings():
        _w.simplefilter("error", DispatchDivergenceWarning)
        out = deconvolve_auto(
            psi0.copy(), data, num_iterations=2, algorithm=algorithm,
            chunk_z=8,
        )
    ref = deconvolve_jit(psi0, data, num_iterations=2, algorithm=algorithm)
    assert rms(np.asarray(out), np.asarray(ref)) < 1e-4


def test_sharded_rung_rejects_unsupported_engine(rng):
    """deconvolve_sharded must not silently serve 'direct'/typos with the
    fft path."""
    from libmultiviewnative_jax.parallel.sharded import (
        deconvolve_sharded,
        make_mesh,
        shard_workspace,
    )

    data = _data(rng, V=2, shape=(16, 8, 8))
    psi0 = jnp.full((16, 8, 8), 100.0, jnp.float32)
    mesh = make_mesh(view_parallel=2, z_parallel=4)
    psi_s, data_s = shard_workspace(data, psi0, mesh)
    for bad in ("direct", "dtf"):
        with pytest.raises(ValueError, match="sharded rung supports"):
            deconvolve_sharded(psi_s, data_s, 1, mesh, algorithm=bad)


def test_sequential_to_sharded_runs_weight_audit(rng, monkeypatch):
    """A sequential request diverted to the (simultaneous) sharded rung
    must run the unnormalized-weights audit EAGERLY at dispatch — the
    in-rung check is skipped under jit."""
    from libmultiviewnative_jax.deconv.dispatch import DispatchDivergenceWarning
    from libmultiviewnative_jax.deconv.workspace import (
        WeightNormalizationWarning,
    )

    V, shape = 2, (16, 8, 8)
    data = _data(rng, V=V, shape=shape)
    bad = MultiViewData(
        views=data.views,
        kernel1=data.kernel1,
        kernel2=data.kernel2,
        weights=jnp.full((V,) + shape, 1.0, jnp.float32),  # sums to 2
    )
    psi0 = jnp.full(shape, 100.0, jnp.float32)
    est_ic = estimate_workspace_bytes(bad, "auto")
    monkeypatch.setattr(
        "libmultiviewnative_jax.deconv.dispatch.device_capacity_bytes",
        lambda device=None: int(est_ic / 2),
    )
    import libmultiviewnative_jax.deconv.dispatch as dd

    # disable the z-only parity route: this test pins the DIVERGENCE path
    monkeypatch.setattr(dd, "_pick_zonly_mesh", lambda *a, **k: None)
    with pytest.warns(WeightNormalizationWarning):
        with pytest.warns(DispatchDivergenceWarning):
            deconvolve_auto(
                psi0, bad, num_iterations=1, view_order="sequential"
            )
