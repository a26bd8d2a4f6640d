"""Mixed precision (f32 V-cycles inside an f64 defect-correction loop)
against fp64 solves of the same problem.

Both stop when the last V-cycle changed u by less than vc_tol under the
selected metric, and both converge to the same discrete solution, so
they must agree at the level of vc_tol: with a V-cycle contraction
factor <= 1/2 each iterate lies within vc_tol of the discrete solution
(max metric).  Under the mean metric the stopping test bounds the mean
change, so the mean difference is held to the same bound and the max
difference to 100 x vc_tol.
"""

import numpy as np
import pytest

from ndsm_tpu import GridHierarchy, Options
from ndsm_tpu.mg.poisson import PoissonBVP

BCS = {
    "DDD": (("D", "D"), ("D", "D"), ("D", "D")),
    "component_z": (("D", "D"), ("D", "D"), ("N", "N")),
    "mixed": (("D", "N"), ("N", "D"), ("D", "D")),
}
SHAPES = {
    "aligned": (16, 16, 32),
    "unaligned": (22, 20, 18),
    "odd": (15, 13, 17),
}
VC_TOL = 1e-10


def _problem(shape, bcs):
    meshes = [np.linspace(0.0, 1.0 + 0.2 * i, n) for i, n in enumerate(shape)]
    h = GridHierarchy.from_mesh(meshes)
    Z, Y, X = np.meshgrid(*meshes, indexing="ij")
    rhs = np.sin(np.pi * X) * np.cos(1.5 * np.pi * Y) * (1.0 + Z)
    u0 = np.zeros(shape)
    # nonzero Dirichlet data on the first face of each D axis
    for ax, (lo, _) in enumerate(bcs):
        if lo == "D":
            sl = [slice(None)] * 3
            sl[ax] = 0
            u0[tuple(sl)] = 0.3 * np.cos(np.pi * (X + Y + Z))[tuple(sl)]
    return h, u0, rhs


@pytest.mark.parametrize("mean", [False, True], ids=["max", "mean"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("bcs", list(BCS), ids=list(BCS))
def test_mixed_matches_fp64(bcs, shape, mean):
    shape, bcs = SHAPES[shape], BCS[bcs]
    h, u0, rhs = _problem(shape, bcs)
    out = {}
    for prec in ("mixed", "fp64"):
        opts = Options(precision=prec, mean=mean, vc_tol=VC_TOL)
        u, info = PoissonBVP(h, bcs, opts).solve(u0, rhs)
        assert info.ierr == 0, (prec, info)
        assert info.du_last < VC_TOL
        out[prec] = (np.asarray(u), info)
    d = np.abs(out["mixed"][0] - out["fp64"][0])
    if mean:
        assert d.mean() <= VC_TOL
        assert d.max() <= 100 * VC_TOL
    else:
        assert d.max() <= VC_TOL
    # the defect groups count every inner V-cycle: the two iterations
    # contract at the same rate, so their cycle counts stay close
    assert abs(out["mixed"][1].cycles - out["fp64"][1].cycles) <= 2
