"""Direct coarse-grid solver.

The reference's ``solve_exact`` relaxes the coarsest grid until the
inter-iterate change is <= ex_tol — potentially thousands of sweeps on a
tiny array (ndsm_multigrid_core.f90:728-800).  On an accelerator each
tiny sweep inside a ``lax.while_loop`` costs launch-bound microseconds,
making the coarse solve a latency wall (SURVEY.md "hard parts").

Because the coarsest operator is a fixed small matrix, we can instead
precompute (at trace time, in numpy float64) the exact solve:

  * interior/Neumann points assemble the reflected 7-point operator;
  * Dirichlet-face points are excluded (their correction is identically
    zero in the reference, since relaxation skips them);
  * for the all-Neumann (singular) case the Moore-Penrose pseudo-inverse
    yields the minimal-norm = zero-mean solution — exactly the limit the
    reference's mean-subtracted relaxation converges to.

The coarse solve then becomes ONE matvec.  The result agrees with the
relax-to-ex_tol limit to ex_tol (or to the float32 floor in mixed
precision), so converged solutions are unchanged; only the per-cycle cost
drops.  Enabled via ``Options.coarse_solver`` ("auto" -> direct for
mixed/fp32, relax for fp64 to stay step-for-step with the reference).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..ops.stencils import BCS

__all__ = ["build_coarse_solver_matrix", "build_coarse_matrix_from_operator"]


def build_coarse_solver_matrix(
    shape: Tuple[int, ...],
    dq: Sequence[float],
    bcs: BCS,
    diag_shift: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (solve_matrix, interior_mask_flat).

    ``solve_matrix`` is (m, m) over the m non-Dirichlet points such that
    ``e_int = solve_matrix @ rhs_int`` solves the coarse problem
    ``L e = rhs`` (with e = 0 on Dirichlet faces); for an all-Neumann
    problem it is the pseudo-inverse restricted to zero-mean solutions.

    ``diag_shift`` adds a constant to every interior diagonal entry —
    the assembly hook for shifted operators (mg/operator.py's
    ``HelmholtzOperator`` passes ``-c`` for ``L - c``).  A nonzero
    shift removes the all-Neumann nullspace, so the true inverse is
    used there instead of the zero-mean pseudo-inverse.
    """
    ndim = len(shape)
    w = [1.0 / float(d) ** 2 for d in dq]
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)

    interior = np.ones(shape, dtype=bool)
    for ax in range(ndim):
        sl = [slice(None)] * ndim
        if bcs[ax][0] == "D":
            sl[ax] = 0
            interior[tuple(sl)] = False
        if bcs[ax][1] == "D":
            sl[ax] = shape[ax] - 1
            interior[tuple(sl)] = False
    int_flat = interior.ravel()
    m = int(int_flat.sum())
    # map full linear index -> interior row
    row_of = -np.ones(n, dtype=np.int64)
    row_of[int_flat] = np.arange(m)

    A = np.zeros((m, m), dtype=np.float64)
    it = np.ndindex(*shape)
    for pt in it:
        if not interior[pt]:
            continue
        r = row_of[idx[pt]]
        diag = float(diag_shift)
        for ax in range(ndim):
            diag -= 2.0 * w[ax]
            for delta in (-1, +1):
                q = list(pt)
                q[ax] += delta
                # Neumann index reflection (-1 -> 1, n -> n-2)
                if q[ax] < 0:
                    q[ax] = 1
                elif q[ax] > shape[ax] - 1:
                    q[ax] = shape[ax] - 2
                qt = tuple(q)
                if interior[qt]:
                    A[r, row_of[idx[qt]]] += w[ax]
                # else: Dirichlet neighbor, e = 0 contributes nothing
        A[r, r] += diag

    all_n = all(tuple(b) == ("N", "N") for b in bcs) and diag_shift == 0.0
    if all_n:
        S = np.linalg.pinv(A, rcond=1e-12)
    else:
        S = np.linalg.inv(A)
    return S, int_flat


def build_coarse_matrix_from_operator(
    operator, shape: Tuple[int, ...], dq: Sequence[float], bcs: BCS
) -> Tuple[np.ndarray, np.ndarray]:
    """Generic (solve_matrix, interior_mask_flat) assembly for ANY
    injected :class:`~ndsm_tpu.mg.operator.MGOperator` — probe the
    operator's own ``residual`` with basis vectors.

    ``residual(e_j, 0) = -L e_j`` (zeroed on Dirichlet faces), so the
    columns of L come straight from the operator's traceable definition
    — no per-operator stencil re-derivation, and assembly/solve
    consistency is guaranteed by construction.  The reference has no
    counterpart (its only coarse solve is relax-to-ex_tol,
    ndsm_multigrid_core.f90:728-800); this is the engine's
    one-matvec coarse solve made available to every custom operator,
    not just the built-ins with hand-assembled matrices.

    Singular operators (``operator.is_singular(bcs)``) get the
    pseudo-inverse, matching the zero-mean relax limit as in
    :func:`build_coarse_solver_matrix`.

    Probing is chunked (``vmap`` over <=512 basis vectors at a time) so
    peak memory stays ~512 * prod(shape) doubles even when a test
    assembles a fine-grid oracle matrix.
    """
    import jax
    import jax.numpy as jnp

    ndim = len(shape)
    n = int(np.prod(shape))
    interior = np.ones(shape, dtype=bool)
    for ax in range(ndim):
        sl = [slice(None)] * ndim
        if bcs[ax][0] == "D":
            sl[ax] = 0
            interior[tuple(sl)] = False
        if bcs[ax][1] == "D":
            sl[ax] = shape[ax] - 1
            interior[tuple(sl)] = False
    int_flat = interior.ravel()

    dq_j = jnp.asarray(np.asarray(dq, dtype=np.float64))
    zero = jnp.zeros(shape, dtype=jnp.float64)

    def _col(e_flat):
        e = e_flat.reshape(shape)
        return -operator.residual(e, zero, dq_j, bcs).ravel()

    probe = jax.jit(jax.vmap(_col))
    chunk = min(n, 512)
    rows = []
    for j0 in range(0, n, chunk):
        m = min(chunk, n - j0)
        E = np.zeros((chunk, n), dtype=np.float64)
        E[np.arange(m), j0 + np.arange(m)] = 1.0
        rows.append(np.asarray(probe(jnp.asarray(E)))[:m])
    # rows[j] = L e_j  ->  stacking gives L^T
    L = np.concatenate(rows, axis=0).T
    A = L[int_flat][:, int_flat]
    if operator.is_singular(bcs):
        S = np.linalg.pinv(A, rcond=1e-12)
    else:
        S = np.linalg.inv(A)
    return S, int_flat
