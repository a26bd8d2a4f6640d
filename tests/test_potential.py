"""Vector-potential application tests: the analytic potential-field
integration case (truncation-error scaling + golden-table regression) and
pipeline-piece checks (fluxes, curl, At boundary data)."""

import os

import numpy as np
import pytest

from ndsm_tpu import vector_potential, Options
from ndsm_tpu.ops.deriv import curl, deriv_axis
from ndsm_tpu.ops.reduce import trapz_2d
from ndsm_tpu.utils.testing import power_law_fit, potential_field_case, build_test_mesh

# First row of the golden table (tests/integration_test/results_test1.txt:6):
# 22^3, dx=4.76190e-02
GOLDEN_22 = dict(
    Ea_max=1.86048e-03, Ea_avg=2.67773e-04, Eb_max=7.65805e-02, Eb_avg=6.53421e-03
)


def _solve_case(n, **kw):
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    ierr, A2, b2 = vector_potential(x, y, z, b1.copy(), **kw)
    Ea = np.linalg.norm(A1 - A2, axis=0)
    Eb = np.linalg.norm(b1 - b2, axis=0)
    return ierr, Ea, Eb


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
def test_golden_22cubed(precision):
    """22^3 solve must reproduce the reference's checked-in errors to ~5
    significant figures (results_test1.txt row 1)."""
    ierr, Ea, Eb = _solve_case(22, precision=precision)
    assert ierr == 0
    np.testing.assert_allclose(Ea.max(), GOLDEN_22["Ea_max"], rtol=1e-4)
    np.testing.assert_allclose(Ea.mean(), GOLDEN_22["Ea_avg"], rtol=1e-4)
    np.testing.assert_allclose(Eb.max(), GOLDEN_22["Eb_max"], rtol=1e-4)
    np.testing.assert_allclose(Eb.mean(), GOLDEN_22["Eb_avg"], rtol=1e-4)


def test_mean_metric_matches_golden():
    """mean=True golden row (results_test2.txt:6) — identical errors."""
    ierr, Ea, Eb = _solve_case(22, mean=True, precision="fp64")
    assert ierr == 0
    np.testing.assert_allclose(Ea.max(), GOLDEN_22["Ea_max"], rtol=1e-4)
    np.testing.assert_allclose(Eb.max(), GOLDEN_22["Eb_max"], rtol=1e-4)


@pytest.mark.slow
def test_truncation_error_scaling():
    """Power-law index of the truncation error ~ 2 (second-order scheme;
    reference integration_test1.py:157-159 and BASELINE.md)."""
    sizes = [22, 33, 44]
    dx, ea, eb = [], [], []
    for n in sizes:
        ierr, Ea, Eb = _solve_case(n, precision="mixed")
        assert ierr == 0
        dx.append(1.0 / (n - 1))
        ea.append(Ea.max())
        eb.append(Eb.max())
    ga, _, _ = power_law_fit(np.array(dx), np.array(ea))
    gb, _, _ = power_law_fit(np.array(dx), np.array(eb))
    assert 1.7 < ga < 2.3, (ga, ea)
    assert 1.7 < gb < 2.3, (gb, eb)


def test_divergence_free():
    """Interior div(B) must vanish to ROUNDING (not truncation): away from
    the boundary's one-sided stencils, the discrete central-difference
    div(curl(.)) identity cancels exactly, so any interior deviation is a
    pipeline bug, not discretization error.  (Measured: ~1.4e-14 at 22^3,
    ~3.2e-14 at 44^3.)"""
    n = 22
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    ierr, A2, b2 = vector_potential(x, y, z, b1.copy(), precision="fp64")
    assert ierr == 0
    dq = np.array([x[1] - x[0]] * 3)
    div = (
        np.asarray(deriv_axis(b2[0], dq[0], -1))
        + np.asarray(deriv_axis(b2[1], dq[1], -2))
        + np.asarray(deriv_axis(b2[2], dq[2], -3))
    )
    assert np.abs(div[1:-1, 1:-1, 1:-1]).max() < 1e-11


def test_curl_of_analytic_potential():
    """curl() reproduces B from the analytic A at truncation level."""
    n = 40
    x = np.linspace(0, 1, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    A, b = potential_field_case(X, Y, Z)
    dq = np.array([x[1] - x[0]] * 3)
    B = np.asarray(curl(A, dq))
    assert np.abs(B - b).max() < 0.05


def test_host_curl_ulp_identical():
    """ops/deriv.curl_np matches the XLA curl at the ulp level (same
    expression order; XLA fuses FMAs) — the invariant behind
    Options.host_curl.  Bound: 1e-13 relative of the field scale,
    eight orders below the h^2 truncation error."""
    from ndsm_tpu.ops.deriv import curl_np

    rng = np.random.default_rng(11)
    A = rng.standard_normal((3, 13, 17, 21))
    dq = (0.013, 0.017, 0.021)
    B_dev = np.asarray(curl(A, np.asarray(dq)))
    B_host = curl_np(A, dq)
    scale = np.abs(B_dev).max()
    assert np.abs(B_host - B_dev).max() < 1e-13 * scale


def test_curl_np_into_chunked_bitwise():
    """ops/deriv.curl_np_into over any z-chunking is BITWISE equal to
    the one-shot curl_np (same per-row expressions; slicing changes no
    values) — the invariant behind the pipelined download+curl."""
    from ndsm_tpu.ops.deriv import curl_np, curl_np_into

    rng = np.random.default_rng(7)
    dq = (0.013, 0.017, 0.021)
    for nz, cuts in [(13, [0, 3, 4, 9, 13]), (13, [0, 13]), (3, [0, 3]),
                     (16, [0, 5, 10, 16])]:
        A = rng.standard_normal((3, nz, 7, 9))
        want = curl_np(A, dq)
        out = np.empty_like(want)
        for z0, z1 in zip(cuts[:-1], cuts[1:]):
            curl_np_into(A, dq, out, z0, z1)
        assert np.array_equal(out, want)

    # float32 storage: differencing upcasts to f64 per chunk, exactly
    # like the serial path's full-array upcast, then rounds once into
    # the f32 output.
    A32 = rng.standard_normal((3, 12, 6, 8)).astype(np.float32)
    want32 = curl_np(A32.astype(np.float64), dq).astype(np.float32)
    out32 = np.empty_like(A32)
    for z0, z1 in [(0, 4), (4, 11), (11, 12)]:
        curl_np_into(A32, dq, out32, z0, z1)
    assert np.array_equal(out32, want32)


def test_fetch_and_curl_pipelined_matches_serial():
    """The pipelined fetch+curl helper returns (A, B) identical to the
    serial fetch-then-curl under several stream counts (readiness
    bookkeeping, chunk boundaries, both output dtypes)."""
    import jax.numpy as jnp

    from ndsm_tpu.ops.deriv import curl_np
    from ndsm_tpu.potential.vector_potential import _fetch_and_curl_pipelined

    rng = np.random.default_rng(3)
    dq = (0.05, 0.04, 0.03)
    A = rng.standard_normal((3, 22, 10, 12))
    for out_dtype, streams in [("float64", "1"), ("float64", "6"),
                               ("float32", "16")]:
        A_dev = jnp.asarray(A).astype(out_dtype)
        want_A = np.asarray(A_dev)
        want_B = curl_np(want_A.astype(np.float64), dq).astype(out_dtype)
        os.environ["NDSM_TPU_FETCH_STREAMS"] = streams
        try:
            got_A, got_B = _fetch_and_curl_pipelined(
                A_dev, dq, out_dtype, lambda *_a, **_k: None
            )
        finally:
            del os.environ["NDSM_TPU_FETCH_STREAMS"]
        assert np.array_equal(got_A, want_A)
        assert np.array_equal(got_B, want_B)


def test_fetch_split16_encoding_accuracy():
    """Options.fetch_encoding='split16' (f32 + int16 fixed-point
    correction, 6 B/point on the wire) reconstructs A within
    max|A - f32(A)| / 32767 — for O(1) fields ~2e-13, five orders below
    truncation error — and B = curl within that bound / h."""
    import jax.numpy as jnp

    from ndsm_tpu.ops.deriv import curl_np
    from ndsm_tpu.potential.vector_potential import _fetch_and_curl_pipelined

    rng = np.random.default_rng(5)
    dq = (0.05, 0.04, 0.03)
    A = rng.standard_normal((3, 24, 10, 12))
    A_dev = jnp.asarray(A)
    want_A = np.asarray(A_dev)
    want_B = curl_np(want_A, dq)
    os.environ["NDSM_TPU_SPLIT16_MIN_MB"] = "0"  # size gate off: tiny arrays
    got_A, got_B = _fetch_and_curl_pipelined(
        A_dev, dq, "float64", lambda *a, **k: None, encoding="split16"
    )
    corr_max = np.abs(want_A - want_A.astype(np.float32).astype(np.float64)).max()
    bound = corr_max / 32767 * 1.0001 + 1e-300
    assert np.abs(got_A - want_A).max() <= bound
    assert np.abs(got_B - want_B).max() <= 3 * bound / min(dq)
    # exact-f32 input: correction is all-zero, reconstruction is exact
    A32 = jnp.asarray(A.astype(np.float32).astype(np.float64))
    got_A, got_B = _fetch_and_curl_pipelined(
        A32, dq, "float64", lambda *a, **k: None, encoding="split16"
    )
    assert np.array_equal(got_A, np.asarray(A32))
    # float32 outputs ignore the encoding (already 4 B/point)
    got_A, _ = _fetch_and_curl_pipelined(
        A_dev.astype(jnp.float32), dq, "float32", lambda *a, **k: None,
        encoding="split16",
    )
    assert got_A.dtype == np.float32
    del os.environ["NDSM_TPU_SPLIT16_MIN_MB"]
    # default size gate: tiny arrays silently take the raw f64 path
    got_A, _ = _fetch_and_curl_pipelined(
        A_dev, dq, "float64", lambda *a, **k: None, encoding="split16"
    )
    assert np.array_equal(got_A, want_A)  # bit-exact => raw path


def test_host_curl_pipeline_identical():
    """vector_potential with Options.host_curl=True returns the default
    path's (A, B): A bitwise (identical device computation), B at the
    ulp level, under the default flux-correction order."""
    import dataclasses as _dc

    from ndsm_tpu import Options, vector_potential

    n = 22
    x = np.linspace(0, 1, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    _, b = potential_field_case(X, Y, Z)
    opts = Options(precision="mixed")
    ierr0, A0, B0 = vector_potential(x, x, x, b, options=opts)
    ierr1, A1, B1 = vector_potential(
        x, x, x, b, options=_dc.replace(opts, host_curl=True)
    )
    assert ierr0 == ierr1 == 0
    np.testing.assert_array_equal(A1, A0)
    scale = np.abs(B0).max()
    assert np.abs(B1 - B0).max() < 1e-13 * scale
    assert isinstance(B1, np.ndarray)
    # order 1 ignores the flag (falls back to the device path)
    ierr2, A2, B2 = vector_potential(
        x, x, x, b,
        options=_dc.replace(opts, host_curl=True, flux_correction_order=1),
    )
    assert ierr2 == 0
    # golden digits are insensitive to the ulp-level B difference
    Eb0 = np.linalg.norm(b - B0, axis=0).max()
    Eb1 = np.linalg.norm(b - B1, axis=0).max()
    assert f"{Eb0:.5e}" == f"{Eb1:.5e}"


def test_host_curl_float32_output():
    """host_curl composes with output_dtype=float32 (the half-download
    bench mode): A is the f64 result rounded to f32; B is the f64-
    computed curl OF that rounded A, so it deviates from the f64-path
    curl by at most ~eps_f32*|A|/dq of differencing amplification."""
    import dataclasses as _dc

    from ndsm_tpu import Options, vector_potential

    n = 22
    x = np.linspace(0, 1, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    _, b = potential_field_case(X, Y, Z)
    opts = Options(precision="mixed")
    ierr0, A0, B0 = vector_potential(x, x, x, b, options=opts)
    ierr1, A1, B1 = vector_potential(
        x, x, x, b,
        options=_dc.replace(opts, host_curl=True, output_dtype="float32"),
    )
    assert ierr0 == ierr1 == 0
    assert A1.dtype == np.float32 and B1.dtype == np.float32
    eps = np.finfo(np.float32).eps
    # A is downcast on device right after the component solves (before
    # the flux correction) to free the f64 buffers, so it agrees with
    # the f64-path result at f32 rounding, not bitwise.
    assert np.abs(A1 - A0).max() < 4.0 * eps * np.abs(A0).max()
    bound = 2.0 * eps * np.abs(A0).max() * (n - 1) + eps * np.abs(B0).max()
    assert np.abs(B1 - B0).max() < 4.0 * bound


def test_trapz_2d():
    nx, ny = 31, 41
    x = np.linspace(0, 2, nx)
    y = np.linspace(0, 1, ny)
    X, Y = np.meshgrid(x, y, indexing="xy")
    f = X**2 * Y + 3.0
    got = float(trapz_2d(f, y[1] - y[0], x[1] - x[0]))
    want = 2**3 / 3 * 1**2 / 2 + 3.0 * 2 * 1
    assert abs(got - want) < 2e-3


def test_per_face_superposition():
    """The per-face path (quirk Q1, made functional here) must equal the
    combined solve by linear superposition, to solver tolerance."""
    n = 12
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    o1 = Options(precision="fp64", vc_tol=1e-11)
    o2 = Options(precision="fp64", vc_tol=1e-11, per_face=True)
    _, A_all, B_all = vector_potential(x, y, z, b1.copy(), options=o1)
    _, A_pf, B_pf = vector_potential(x, y, z, b1.copy(), options=o2)
    assert np.abs(A_all - A_pf).max() < 1e-6
    assert np.abs(B_all - B_pf).max() < 1e-4


def test_flux_correction_orders_agree():
    """Both flux-correction orders (IOPT_FLXCRL) give the same B up to the
    curl of the analytic correction being nearly exact."""
    n = 16
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    _, A0, B0 = vector_potential(
        x, y, z, b1.copy(), options=Options(precision="fp64")
    )
    _, A1, B1 = vector_potential(
        x, y, z, b1.copy(), options=Options(precision="fp64", flux_correction_order=1)
    )
    np.testing.assert_allclose(A0, A1, atol=1e-9)
    assert np.abs(B0 - B1).max() < 2e-2


def test_fetch_unknown_encoding_is_raw():
    """Any fetch_encoding other than 'split16' takes the raw bit-exact
    download path (forward-compatible: unknown names never corrupt
    results)."""
    import jax.numpy as jnp

    from ndsm_tpu.potential.vector_potential import _fetch_and_curl_pipelined

    rng = np.random.default_rng(21)
    A = rng.standard_normal((3, 12, 8, 10))
    A_dev = jnp.asarray(A)
    for enc in ("f64", "auto", "zstd", ""):
        got_A, _ = _fetch_and_curl_pipelined(
            A_dev, (0.1, 0.1, 0.1), "float64", lambda *a, **k: None,
            encoding=enc,
        )
        assert np.array_equal(got_A, np.asarray(A_dev))
