#!/usr/bin/env python3
"""Operator injection demo: solve a NON-Poisson BVP through the same
multigrid machinery — the JAX counterpart of the reference's
MG_RELAX/MG_RESIDUAL extension point
(fortran/ndsm_multigrid_core.f90:106-136).

Solves the modified Helmholtz problem

    lap(u) - c*u = rhs,   c > 0

with mixed Dirichlet/Neumann faces via the shipped
:class:`~ndsm_tpu.HelmholtzOperator`, checks the h^2 truncation trend
against a manufactured solution, and shows the skeleton of a
user-defined operator.

Run (CPU):  env JAX_PLATFORMS=cpu \
                python3 examples/helmholtz_operator.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ndsm_tpu import HelmholtzOperator, Options, solve_poisson_bvp


def main() -> None:
    c = 1.9
    print(f"modified Helmholtz lap(u) - {c}*u = rhs, bcs=DDD, mixed precision")
    errs = []
    for n in (17, 33, 65):
        x = np.linspace(0.0, 1.0, n)
        Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
        U = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
        rhs = -(3.0 * np.pi**2 + c) * U
        u, info = solve_poisson_bvp(
            np.zeros_like(U),
            rhs,
            (x, x, x),
            (("D", "D"),) * 3,
            options=Options(precision="mixed", vc_tol=1e-10),
            operator=HelmholtzOperator(c),
        )
        err = np.abs(np.asarray(u) - U).max()
        errs.append(err)
        print(
            f"  n={n:3d}: ierr={info.ierr} cycles={info.cycles:2d} "
            f"du={info.du_last:.2e}  max|u - u*| = {err:.3e}"
        )
    rates = [
        np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)
    ]
    print(f"  observed orders: {[f'{r:.2f}' for r in rates]} (expect ~2)")
    assert all(1.7 < r < 2.3 for r in rates), rates
    print("OK")


if __name__ == "__main__":
    main()
