"""API-surface tests: reference-compatible signature, shapes, and options."""

import numpy as np
import pytest

import ndsm_tpu
from ndsm_tpu import vector_potential, Options
from ndsm_tpu.utils.testing import potential_field_case, build_test_mesh


def test_signature_defaults_match_reference():
    """Defaults must match ndsm.py:66."""
    import inspect

    sig = inspect.signature(vector_potential)
    d = {k: v.default for k, v in sig.parameters.items()}
    assert d["niterex_max"] == 10000
    assert d["ncycles_max"] == 1024
    assert d["ex_tol"] == 1e-13
    assert d["vc_tol"] == 1e-10
    assert d["ms"] == 5
    assert d["mean"] is False
    assert d["debug"] is False


def test_shapes_and_types():
    n = 12
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    ierr, A, B = vector_potential(x, y, z, b1, precision="fp64")
    assert isinstance(ierr, int)
    assert A.shape == (3, n, n, n) and A.dtype == np.float64
    assert B.shape == (3, n, n, n) and B.dtype == np.float64


def test_full_output_info():
    n = 12
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    ierr, A, B, info = vector_potential(
        x, y, z, b1, precision="fp64", full_output=True
    )
    assert len(info.chi) == 6
    assert len(info.components) == 3
    assert all(s.ierr == 0 for s in info.chi + info.components)
    assert info.wall_time > 0


def test_interior_of_b_ignored():
    """Only boundary-face normal components are read (quirk Q12)."""
    n = 12
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    b_noise = b1.copy()
    b_noise[:, 1:-1, 1:-1, 1:-1] += np.random.default_rng(0).standard_normal(
        (3, n - 2, n - 2, n - 2)
    )
    # also scramble tangential components on faces (only normals are used)
    _, A1, B1 = vector_potential(x, y, z, b1.copy(), precision="fp64")
    _, A2, B2 = vector_potential(x, y, z, b_noise, precision="fp64")
    np.testing.assert_allclose(A1, A2, atol=1e-12)
    np.testing.assert_allclose(B1, B2, atol=1e-12)


def test_bad_mesh_returns_ierr_badmesh():
    """A < 2-point mesh RETURNS a flag, as the reference does
    (ndsm_vector_potential.f90:212-215 — no exception, nonzero ierr),
    with A = 0 and B = the input b (the reference leaves its output
    buffers untouched on this path).  IERR_BADMESH=2 keeps it
    distinguishable from IERR_COVFAIL (the reference reuses 1)."""
    from ndsm_tpu.options import IERR_BADMESH

    b = np.arange(3 * 8 * 8 * 1, dtype=float).reshape(3, 8, 8, 1)
    ierr, A, B = vector_potential(
        np.array([0.0]), np.linspace(0, 1, 8), np.linspace(0, 1, 8),
        b.copy(),
    )
    assert ierr == IERR_BADMESH == 2
    assert np.array_equal(A, np.zeros_like(b))
    assert np.array_equal(B, b)


def test_nonuniform_mesh_returns_ierr_badmesh():
    """A non-uniform mesh is the one input error that would corrupt
    results instead of crashing (every dq is taken as m[1]-m[0], and the
    transfer matrices assume uniform spacing — as does the reference,
    ndsm_interp.f90:373): the API flags it instead of silently returning
    wrong fields.  Outputs follow the error-path contract in the
    caller's resolved dtype."""
    from ndsm_tpu.options import IERR_BADMESH

    n = 8
    x = np.linspace(0, 1, n)
    x_bad = x.copy()
    x_bad[3] += 0.04  # graded: ~30% spacing deviation
    b = np.arange(3 * n**3, dtype=float).reshape(3, n, n, n)
    ierr, A, B = vector_potential(x_bad, x, x, b.copy())
    assert ierr == IERR_BADMESH
    assert np.array_equal(A, np.zeros_like(b))
    assert np.array_equal(B, b)
    # f32 output mode: error-path outputs must match the normal-path
    # output dtype, not widen to f64
    ierr32, A32, B32 = vector_potential(
        x_bad, x, x, b.copy(), options=Options(precision="fp32")
    )
    assert ierr32 == IERR_BADMESH
    assert A32.dtype == np.float32 and B32.dtype == np.float32
    # ulp-level linspace jitter must NOT trip the gate
    ierr_ok, _, _ = vector_potential(
        x + np.random.default_rng(0).uniform(-1e-12, 1e-12, n), x, x,
        b.copy(), options=Options(ncycles_max=1),
    )
    assert ierr_ok != IERR_BADMESH


def test_from_mesh_rejects_nonuniform():
    """GridHierarchy.from_mesh (the library-level boundary) raises for a
    non-uniform mesh vector."""
    from ndsm_tpu import GridHierarchy

    x = np.linspace(0, 1, 16)
    bad = x.copy()
    bad[5] += 0.02
    with pytest.raises(ValueError, match="not uniformly spaced"):
        GridHierarchy.from_mesh((bad, x, x))
    GridHierarchy.from_mesh((x, x, x))  # uniform: fine


def test_bad_mesh_shape_still_raises():
    """Malformed arrays (a 2-D 'mesh vector') are programming errors and
    still raise — only the reference-representable too-small-mesh case
    takes the flag path."""
    with pytest.raises(ValueError):
        vector_potential(
            np.zeros((2, 2)), np.linspace(0, 1, 8), np.linspace(0, 1, 8),
            np.zeros((3, 8, 8, 2)),
        )


def test_rectangular_box():
    """Non-cubic shapes go through the full pipeline."""
    nx, ny, nz = 14, 12, 10
    x = np.linspace(0, 1, nx)
    dx = x[1] - x[0]
    y = np.arange(ny) * dx
    z = np.arange(nz) * dx
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    ierr, A2, B2 = vector_potential(x, y, z, b1.copy(), precision="fp64")
    assert ierr == 0
    assert np.abs(B2 - b1).max() < 0.5  # coarse mesh, loose truncation bound


def test_module_exports():
    for name in (
        "vector_potential",
        "solve_poisson_bvp",
        "PoissonBVP",
        "GridHierarchy",
        "Options",
    ):
        assert hasattr(ndsm_tpu, name)


def test_reference_flux_quirk_paths():
    """Both flux/gradient spacing conventions run; on a cubic mesh they
    are identical, on an anisotropic mesh they differ (the quirk
    reproduces the reference's dx,dy-everywhere integration —
    ndsm_vector_potential.f90:300-306,394-397)."""
    n = 12
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    o_fix = Options(precision="fp64")
    o_quirk = Options(precision="fp64", reference_flux_quirk=True)
    _, A_f, B_f = vector_potential(x, y, z, b1.copy(), options=o_fix)
    _, A_q, B_q = vector_potential(x, y, z, b1.copy(), options=o_quirk)
    np.testing.assert_allclose(A_f, A_q, atol=1e-12)  # cubic: identical

    # anisotropic mesh: quirk changes the answer
    nx, ny, nz = 14, 12, 10
    x2 = np.linspace(0, 1.0, nx)
    y2 = np.linspace(0, 1.3, ny)
    z2 = np.linspace(0, 0.8, nz)
    Z2, Y2, X2 = np.meshgrid(z2, y2, x2, indexing="ij")
    _, b2 = potential_field_case(X2, Y2, Z2)
    i1, A1q, _ = vector_potential(x2, y2, z2, b2.copy(), options=o_fix)
    i2, A2q, _ = vector_potential(x2, y2, z2, b2.copy(), options=o_quirk)
    assert i1 == 0 and i2 == 0
    assert np.abs(A1q - A2q).max() > 1e-6


def test_output_dtype_float32():
    n = 12
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    o = Options(precision="fp64", output_dtype="float32")
    ierr, A, B = vector_potential(x, y, z, b1.copy(), options=o)
    assert ierr == 0
    assert A.dtype == np.float32 and B.dtype == np.float32
    _, A64, B64 = vector_potential(x, y, z, b1.copy(), precision="fp64")
    np.testing.assert_allclose(A, A64, rtol=0, atol=1e-5)


def test_input_b_never_mutated():
    """vector_potential reads only b's boundary faces and never writes
    its input (the contract behind bench.py passing b without a
    defensive copy)."""
    n = 10
    x = np.linspace(0, 1, n)
    rng = np.random.default_rng(4)
    b = rng.standard_normal((3, n, n, n))
    b_before = b.copy()
    vector_potential(x, x, x, b, precision="fp32", vc_tol=1e-4)
    assert np.array_equal(b, b_before)


def test_float32_mesh_accepted():
    """Review r5: a perfectly uniform float32 mesh carries ~eps32*|m|
    spacing jitter — far above any dq-relative tolerance — and must NOT
    be rejected by the uniformity gate (the tolerance floor follows the
    input dtype's representable jitter)."""
    from ndsm_tpu import GridHierarchy

    n = 20
    x32 = np.linspace(0, 1, n, dtype=np.float32)
    GridHierarchy.from_mesh((x32, x32, x32))  # must not raise
    # offset-dominated f64 mesh: jitter ~ eps64*offset >> rtol*dq
    xoff = np.linspace(1e6, 1e6 + 1.0, n)
    GridHierarchy.from_mesh((xoff, xoff, xoff))  # must not raise
    b = np.arange(3 * n**3, dtype=float).reshape(3, n, n, n)
    ierr, _, _ = vector_potential(
        x32, x32, x32, b, options=Options(ncycles_max=1)
    )
    assert ierr != 2  # not IERR_BADMESH
    # while a genuinely graded f32 mesh is still caught
    bad = x32.copy()
    bad[7] += np.float32(0.04)
    ierr2, _, _ = vector_potential(bad, x32, x32, b)
    assert ierr2 == 2
