#!/usr/bin/env python3
"""Operator injection demo 2: variable-coefficient diffusion.

Solves   div(a(x) grad u) = rhs,   a(x) = 1 + x*y*z > 0

through the multigrid engine via the shipped
:class:`~ndsm_tpu.DiffusionOperator` — the client that exercises what a
constant-coefficient shift cannot: per-level operator re-discretization
from spatially varying data (the reference's per-level wrapper re-reads
of ``this%meshes``, fortran/ndsm_poisson.f90:163-276).  The direct
coarse solve is assembled generically from the operator's own residual
(mg/coarse.build_coarse_matrix_from_operator), so ANY user-defined
operator gets the one-matvec coarse solve for free.

Run (CPU):  env JAX_PLATFORMS=cpu \
                python3 examples/diffusion_operator.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ndsm_tpu import DiffusionOperator, Options, solve_poisson_bvp


def coef(q0, q1, q2):
    """Strictly positive coefficient on NORMALIZED [0,1]^3 coordinates."""
    return 1.0 + q0 * q1 * q2


def main() -> None:
    print("variable-coefficient diffusion div(a grad u) = rhs, a = 1+xyz")
    errs = []
    for n in (17, 33, 65):
        x = np.linspace(0.0, 1.0, n)
        Zc = x[:, None, None]
        Yc = x[None, :, None]
        Xc = x[None, None, :]
        U = np.sin(np.pi * Xc) * np.sin(np.pi * Yc) * np.sin(np.pi * Zc)
        a = 1.0 + Zc * Yc * Xc
        # rhs = a lap(U) + grad(a).grad(U), analytic
        rhs = a * (-3.0 * np.pi**2) * U + np.pi * (
            Yc * Xc * np.cos(np.pi * Zc) * np.sin(np.pi * Yc) * np.sin(np.pi * Xc)
            + Zc * Xc * np.sin(np.pi * Zc) * np.cos(np.pi * Yc) * np.sin(np.pi * Xc)
            + Zc * Yc * np.sin(np.pi * Zc) * np.sin(np.pi * Yc) * np.cos(np.pi * Xc)
        )
        u, info = solve_poisson_bvp(
            np.zeros_like(U),
            rhs,
            (x, x, x),
            (("D", "D"),) * 3,
            options=Options(precision="mixed", vc_tol=1e-10),
            operator=DiffusionOperator(coef),
        )
        err = np.abs(np.asarray(u, dtype=np.float64) - U).max()
        errs.append(err)
        print(f"  n={n:3d}  ierr={info.ierr}  cycles={info.cycles:2d}  "
              f"max|u-u*|={err:.3e}")
    rate = np.log(errs[0] / errs[-1]) / np.log(4.0)
    print(f"observed truncation order: {rate:.3f} (expect ~2)")


if __name__ == "__main__":
    main()
