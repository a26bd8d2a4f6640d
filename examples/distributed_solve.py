#!/usr/bin/env python3
"""Distributed solves via the explicit shard_map engine.

Run with faked devices (correctness / topology dry-run):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/distributed_solve.py
On several GPUs the same code block-partitions the grid over the real
devices.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from ndsm_tpu import GridHierarchy, Options, vector_potential
from ndsm_tpu.parallel.shard import DistConfig, make_mesh, make_mesh_nd
from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP
from ndsm_tpu.utils.testing import potential_field_case


def main():
    ndev = len(jax.devices())
    print(f"{ndev} devices on {jax.default_backend()}")

    # --- standalone Poisson solve, 2-axis decomposition when possible ---
    n = 32
    x = np.linspace(0, 1, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    U = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
    rhs = -3 * np.pi**2 * U
    bcs = (("D", "D"), ("D", "D"), ("D", "D"))
    h = GridHierarchy.from_mesh((x, x, x))
    if ndev >= 4 and ndev % 2 == 0:
        mesh = make_mesh_nd((ndev // 2, 2), ("z", "y"))
        names = ("z", "y")
    else:
        mesh = make_mesh(ndev)
        names = ("z",)
    bvp = ShardedPoissonBVP(
        h, bcs, Options(precision="mixed"), mesh=mesh, axis_names=names,
        min_rows_per_shard=2,
    )
    u, info = bvp.solve(np.zeros_like(U), rhs)
    err = np.abs(np.asarray(u) - U).max()
    print(
        f"sharded Poisson ({'x'.join(map(str, mesh.devices.shape))} mesh): "
        f"cycles={info.cycles} ierr={info.ierr} err={err:.2e} "
        f"(seam level {bvp.seam}/{h.ngrids})"
    )

    # --- full vector-potential pipeline on the distributed engine ---
    n = 16
    x = np.linspace(0, 1, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    dist = DistConfig(
        mesh=make_mesh(min(4, ndev)), axis_names=("z",), min_rows_per_shard=2
    )
    ierr, A2, B2 = vector_potential(
        x, x, x, b1.copy(), precision="fp64", dist=dist
    )
    Ea = np.linalg.norm(A1 - A2, axis=0).max()
    print(f"distributed vector_potential: ierr={ierr} Ea_max={Ea:.3e}")


if __name__ == "__main__":
    main()
