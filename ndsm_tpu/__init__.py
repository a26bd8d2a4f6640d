"""ndsm_tpu: an N-dimensional geometric-multigrid Poisson solver and 3D
Coulomb-gauge vector-potential solver in JAX.

A re-design of the capabilities of the NDSM library (reference:
sag2021/ndsm, Fortran 2003 + OpenMP):

  * General N-dimensional geometric-multigrid Poisson solver: second-order
    finite differences, red-black Gauss-Seidel smoothing, V-cycles, mixed
    homogeneous-Neumann / Dirichlet box boundary conditions
    (reference: fortran/ndsm_poisson.f90, ndsm_multigrid_core.f90).
  * 3D Coulomb-gauge vector-potential solver: given the normal component of
    B on the six faces of a Cartesian box, computes the current-free field
    B and vector potential A with B = curl(A), div(A) = 0
    (reference: fortran/ndsm_vector_potential.f90, ndsm.py).

Design notes
------------
  * Smoother/residual/transfer are plain jax.numpy/lax code over
    static-shape arrays that XLA fuses; the in-place Fortran red-black
    sweep becomes two functional half-updates with identical semantics
    (color-compact storage by default, ops/stencils_compact.py).
  * Coordinate-based N-linear prolongation and its full-weighting adjoint
    (reference: fortran/ndsm_interp.f90) are separable per-axis linear maps
    on uniform meshes; they are applied as small per-axis matrix products
    at ``Precision.HIGHEST``.
  * Convergence-critical state is kept in float64; the hot V-cycle can run
    in float32 via outer defect correction ("mixed" precision, the default
    off the CPU), which is algebraically identical for this linear problem
    and preserves the vc_tol/ex_tol convergence contract.
  * Scale-out is spatial domain decomposition with `shard_map` over a
    `jax.sharding.Mesh`: 1-deep face-halo exchange per half-sweep,
    cross-shard psum/pmax for metrics, and replication of coarse levels.
"""

import os as _os

import jax as _jax

# Double precision is part of NDSM's numerical contract (vc_tol=1e-10,
# ex_tol=1e-13; reference ndsm.py:66). Enable x64 at import unless the
# user opts out.
if not _os.environ.get("NDSM_TPU_NO_X64"):
    _jax.config.update("jax_enable_x64", True)

from .options import (  # noqa: E402
    Options,
    SolveInfo,
    IERR_SUCCESS,
    IERR_COVFAIL,
    IERR_BADMESH,
)
from .grids import GridHierarchy, num_grids, coarsen_shape  # noqa: E402
from .mg.poisson import PoissonBVP, solve_poisson_bvp  # noqa: E402
from .mg.operator import (  # noqa: E402
    MGOperator,
    PoissonOperator,
    HelmholtzOperator,
    DiffusionOperator,
)
from .potential.vector_potential import compute_vector_potential  # noqa: E402
from .api import vector_potential  # noqa: E402

__all__ = [
    "vector_potential",
    "compute_vector_potential",
    "solve_poisson_bvp",
    "PoissonBVP",
    "MGOperator",
    "PoissonOperator",
    "HelmholtzOperator",
    "DiffusionOperator",
    "GridHierarchy",
    "Options",
    "SolveInfo",
    "num_grids",
    "coarsen_shape",
    "IERR_SUCCESS",
    "IERR_COVFAIL",
    "IERR_BADMESH",
]

__version__ = "0.5.1"
