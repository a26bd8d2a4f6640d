"""MultiBCSolver: one lane-masked program for problems with different
BCs per lane must reproduce the sequential solves' iterates exactly
(reference runs Ax/Ay/Az sequentially, ndsm_vector_potential.f90:598-691)."""

import numpy as np
import pytest

from ndsm_tpu import GridHierarchy, Options
from ndsm_tpu.mg.batched import MultiBCSolver
from ndsm_tpu.mg.poisson import PoissonBVP

COMPONENT_BCS = [
    tuple(("N", "N") if (2 - ax) == c else ("D", "D") for ax in range(3))
    for c in range(3)
]


def _component_u0s(n, rng):
    u0s = []
    for c in range(3):
        u0 = np.zeros((n, n, n))
        if c != 2:
            u0[0, :, :] = rng.standard_normal((n, n))
            u0[-1, :, :] = rng.standard_normal((n, n))
        if c != 1:
            u0[:, 0, :] = rng.standard_normal((n, n))
        if c != 0:
            u0[:, :, 0] = rng.standard_normal((n, n))
        u0s.append(u0)
    return u0s


@pytest.mark.parametrize("precision", ["mixed", "fp64"])
def test_batched_matches_sequential(precision):
    n = 24
    x = np.linspace(0, 1, n)
    h = GridHierarchy.from_mesh((x, x, x))
    u0s = _component_u0s(n, np.random.default_rng(0))
    opts = Options(precision=precision)
    mbs = MultiBCSolver(h, COMPONENT_BCS, opts)
    u_b, infos_b = mbs.solve(np.stack(u0s), names=["Ax", "Ay", "Az"])
    tol = 0.0 if precision == "fp64" else 5e-9
    for c in range(3):
        bvp = PoissonBVP(h, COMPONENT_BCS[c], opts)
        u_s, info_s = bvp.solve(u0s[c], None, zero_rhs=True)
        assert infos_b[c].ierr == 0
        assert infos_b[c].cycles == info_s.cycles
        assert infos_b[c].batch_size == 3
        d = np.abs(np.asarray(u_b[c]) - np.asarray(u_s)).max()
        assert d <= tol, (c, d)


def test_all_neumann_lane_rejected():
    x = np.linspace(0, 1, 12)
    h = GridHierarchy.from_mesh((x, x, x))
    with pytest.raises(ValueError):
        MultiBCSolver(h, [(("N", "N"),) * 3], Options())


def test_pipeline_batch_toggle_equivalence():
    """batch_components on/off gives the same vector potential."""
    from ndsm_tpu import vector_potential
    from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case

    n = 14
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    _, A_on, B_on = vector_potential(
        x, y, z, b1.copy(), options=Options(precision="fp64", batch_components="on")
    )
    _, A_off, B_off = vector_potential(
        x, y, z, b1.copy(), options=Options(precision="fp64", batch_components="off")
    )
    np.testing.assert_allclose(A_on, A_off, rtol=0, atol=1e-11)
    np.testing.assert_allclose(B_on, B_off, rtol=0, atol=1e-9)
