#!/usr/bin/env python3
"""BASELINE.json configs 1-2 on the accelerator: the small-problem Poisson-backend
configurations that the headline/512^3 benches don't cover.

  1. 3D 64^3 Dirichlet Poisson, analytic sinusoidal RHS, max metric,
     solve to vc_tol.
  2. N-D backend: 2D 256^2 (all-Neumann, the chi-face class) and
     4D 32^4, mean vs max metric.

Each runs warm (one untimed call) and reports wall / cycles / du; the
3D case also checks the discrete solution against the analytic field
at truncation level.

Usage: python3 scripts/perf_configs.py    Env: NDSM_PERF_REPS (3).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPS = int(os.environ.get("NDSM_PERF_REPS", "3"))


def _timed(fn):
    out = fn()
    jax.block_until_ready(out)
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return out, min(ts)


def config1_64_dirichlet():
    """64^3, u = sin(pi x) sin(pi y) sin(pi z), homogeneous Dirichlet;
    rhs = -3 pi^2 u.  Discrete truncation error ~ (pi h)^2 / 12."""
    from ndsm_tpu import GridHierarchy, Options
    from ndsm_tpu.mg.poisson import PoissonBVP

    n = 64
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    u_exact = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
    rhs = -3.0 * np.pi**2 * u_exact
    bcs = (("D", "D"),) * 3
    for pname in ("mixed", "fp64"):
        bvp = PoissonBVP(h, bcs, Options(precision=pname))
        rhs_dev = jax.block_until_ready(jnp.asarray(rhs))
        u0 = jnp.zeros((n, n, n))
        (res, info), dt = _timed(lambda: bvp.solve(u0, rhs_dev))
        err = float(np.abs(np.asarray(res) - u_exact).max())
        bound = (np.pi * (x[1] - x[0])) ** 2 / 12 * 1.2
        print(
            f"config1 64^3 Dirichlet [{pname:5s}]: {dt*1e3:8.2f} ms  "
            f"cycles={info.cycles} du={info.du_last:.2e} "
            f"err={err:.3e} (h^2 bound {bound:.3e}) "
            f"{'OK' if err < bound else 'FAIL'}",
            flush=True,
        )


def config2_nd():
    """2D 256^2 all-Neumann (chi class) and 4D 32^4, mean vs max."""
    from ndsm_tpu import GridHierarchy, Options
    from ndsm_tpu.mg.poisson import PoissonBVP

    rng = np.random.default_rng(0)
    cases = [
        ("2D 256^2 allN", (256, 256), (("N", "N"), ("N", "N"))),
        ("4D 32^4 mixed-BC", (32, 32, 32, 32),
         ((("D", "D"),) * 3 + (("N", "N"),))),
    ]
    for name, shape, bcs in cases:
        meshes = tuple(np.linspace(0, 1, m) for m in shape)
        h = GridHierarchy.from_mesh(meshes)
        rhs = rng.standard_normal(shape)
        if all(b == ("N", "N") for b in bcs):
            rhs -= rhs.mean()  # compatibility for the pure-Neumann case
        rhs_dev = jax.block_until_ready(jnp.asarray(rhs))
        for prec in ("fp64", "mixed"):
            for mean in (False, True):
                bvp = PoissonBVP(h, bcs, Options(precision=prec, mean=mean))
                u0 = jnp.zeros(shape)
                (res, info), dt = _timed(lambda: bvp.solve(u0, rhs_dev))
                print(
                    f"config2 {name:18s} "
                    f"[{prec:5s} {'mean' if mean else 'max '}]: "
                    f"{dt*1e3:8.2f} ms  cycles={info.cycles} "
                    f"du={info.du_last:.2e} ierr={info.ierr}",
                    flush=True,
                )


if __name__ == "__main__":
    config1_64_dirichlet()
    config2_nd()
