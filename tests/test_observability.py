"""Observability: coarse-solve non-convergence flag + warning, per-phase
debug trace, batched-solve timing honesty.  All diagnostics are emitted
host-side AFTER results are fetched (the reference prints via bare
PRINT * / debug_msg — ndsm_multigrid_core.f90:796-798,
ndsm_vector_potential.f90:257-487)."""

import numpy as np
import pytest

from ndsm_tpu import GridHierarchy, Options, vector_potential
from ndsm_tpu.mg.poisson import PoissonBVP

from test_mg import _poly_neumann_2d


def _tiny_bvp(**opt_kw):
    meshes, rhs, _ = _poly_neumann_2d(27, 36, 1.0, 1.3)
    opts = Options(precision="fp64", **opt_kw)
    bvp = PoissonBVP(GridHierarchy.from_mesh(meshes), (("N", "N"), ("N", "N")), opts)
    return bvp, rhs


def test_coarse_noconv_flag_and_warning(capfd):
    """niterex_max=1 starves the relax coarse solve: the flag must be set
    in SolveInfo and the reference warning printed."""
    bvp, rhs = _tiny_bvp(coarse_solver="relax", niterex_max=1, ncycles_max=3)
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    assert info.coarse_noconv is True
    err = capfd.readouterr().err
    assert "IOPT_NMAXEX exceeded" in err


def test_coarse_converged_flag_clear(capfd):
    """A healthy solve leaves the flag unset and prints nothing."""
    bvp, rhs = _tiny_bvp(coarse_solver="relax")
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 0
    assert info.coarse_noconv is False
    assert "IOPT_NMAXEX" not in capfd.readouterr().err


def test_covfail_warning_printed(capfd):
    """IERR_COVFAIL prints the reference's NCYCLES warning host-side
    (reference: ndsm_poisson.f90:147-150)."""
    bvp, rhs = _tiny_bvp(ncycles_max=1, vc_tol=1e-14)
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 1
    assert "IOPT_NCYCLES exceeded" in capfd.readouterr().err


def test_debug_phase_trace(capfd):
    """debug=True emits the reference's per-phase DEBUG trace lines
    (ndsm_vector_potential.f90:257,337,385,405,451) from the host."""
    from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case

    n = 12
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    ierr, A, B = vector_potential(
        x, y, z, b1.copy(), options=Options(precision="fp64", debug=True)
    )
    assert ierr == 0
    err = capfd.readouterr().err
    for phrase in (
        "Extract boundary conditions",
        "Solve BVP on each boundary",
        "vector potential boundary conditions",
        "Solve BVP 3D",
        "curl(A) and flux correction",
    ):
        assert phrase in err, phrase
    assert "DEBUG(compute_vector_potential):" in err


def test_solve_batch_wall_honesty():
    """Batched SolveInfos report the shared program wall (identical across
    lanes) and the batch size — not a fabricated per-lane split."""
    meshes, rhs1, _ = _poly_neumann_2d(27, 36, 1.0, 1.3)
    _, rhs2, _ = _poly_neumann_2d(27, 36, 1.0, 1.3, a1=-0.4, b1=0.9)
    opts = Options(precision="mixed")  # direct coarse -> batched path
    bvp = PoissonBVP(GridHierarchy.from_mesh(meshes), (("N", "N"), ("N", "N")), opts)
    us, infos = bvp.solve_batch(
        [np.zeros_like(rhs1), np.zeros_like(rhs2)], [rhs1, rhs2]
    )
    assert len(infos) == 2
    assert infos[0].batch_size == infos[1].batch_size == 2
    assert infos[0].wall_time == infos[1].wall_time > 0.0


def test_vector_potential_phase_timings():
    """info.phases decomposes the pipeline wall (the reference has one
    whole-solve timer, ROPT_TIM; this is its per-phase refinement).
    Keys cover both the device-curl and host-curl paths; the phase sum
    accounts for (almost) the whole wall."""
    n = 12
    x = np.linspace(0, 1, n)
    b = np.zeros((3, n, n, n))
    b[2, 0] = 1.0
    b[2, -1] = 1.0
    for opts, extra in [
        (Options(precision="fp64"), set()),
        (
            Options(precision="fp64", host_curl=True),
            {"slab_split", "fetch", "curl"},
        ),
    ]:
        ierr, A, B, info = vector_potential(
            x, x, x, b, options=opts, full_output=True
        )
        assert set(info.phases) >= {"faces", "chi", "solve3d", "post"} | extra
        acc = sum(info.phases.values())
        assert 0.0 < acc <= info.wall_time * 1.001
        assert acc >= 0.5 * info.wall_time  # phases dominate the wall
