"""The multigrid engine: V-cycle, reduced cycles, and the coarse "exact"
solve, compiled as a single XLA program per problem configuration.

Re-design of the reference engine (fortran/ndsm_multigrid_core.f90):

  * ``v_cycle`` (:341-377) — descend with pre-smooth/residual/restrict,
    relax-to-convergence on the coarsest grid, ascend with
    smooth/interpolate/correct/post-smooth.  Levels have static shapes, so
    the level loop is unrolled at trace time into one fused program; there
    is no per-cycle allocation (the reference mallocs/frees coarse buffers
    every cycle — quirk Q9).
  * ``solve_exact`` (:728-800) — a ``lax.while_loop`` of relaxation sweeps
    carrying (u, u_prev, du, iter); the inter-iterate (max|Δu| or mean|Δu|)
    metric and the ``du <= ex_tol`` stopping rule match the reference
    (including the initial comparison against a zeroed saved state,
    :756-761).
  * ``two_grid`` / ``one_grid`` (:385-441) — reduced drivers for testing.

Smoothing order per cycle matches the reference exactly: ms pre-smooth
sweeps on each level going down (fine_to_coarse :523-525), the coarse
solve, then for each level going up: ms sweeps on the coarse level
(coarse_to_fine :642-644), interpolate + add the correction (:659-672),
and ms post-smooth sweeps on the fine level (:680-682) — note the coarsest
level is smoothed ms more times *after* solve_exact.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..grids import GridHierarchy
from ..ops import stencils
from ..ops import stencils_compact
from ..ops.reduce import du_metrics
from ..ops.transfer import interp_matrix_1d, restrict_matrix_1d, apply_axis_matrices
from .coarse import build_coarse_solver_matrix

# Direct coarse solves are precomputed dense (pseudo)inverses; cap the
# coarsest-level size for which that is sensible.
_COARSE_DIRECT_MAX = 4096


__all__ = ["MGEngine"]


def _scoped(name: str):
    """Run a level primitive under ``jax.named_scope(name)``: the scope
    lands in the compiled ops' metadata, so a profiler trace can charge
    device time to smoothing, residual, transfers and the coarse solve
    (scripts/trace_smoother_share.py).  No effect on the computation."""

    def wrap(fn):
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)

        return scoped

    return wrap


class MGEngine:
    """Trace-time builder for the multigrid cycle functions of one problem
    configuration (hierarchy + boundary conditions + metric + dtype).

    All methods named ``t_*`` are traceable: they accept and return JAX
    arrays and may be called inside jit.
    """

    def __init__(
        self,
        hierarchy: GridHierarchy,
        bcs: Sequence[Sequence[str]],
        *,
        ms: int,
        du_max: bool,
        dtype,
        shard_spec=None,
        coarse_direct: bool = False,
        compact_smoother: bool = True,
        operator=None,
    ):
        self.h = hierarchy
        self.bcs = stencils.validate_bcs(bcs, hierarchy.ndim)
        self.ms = int(ms)
        self.du_max = bool(du_max)
        self.dtype = jnp.dtype(dtype)
        self.shard_spec = shard_spec
        # Injected operator (mg/operator.py — the MG_RELAX/MG_RESIDUAL
        # extension point, reference ndsm_multigrid_core.f90:106-136).
        # None = the built-in Poisson stencil stack with its compact fast
        # path; an MGOperator routes every sweep/residual through its
        # traceable methods instead (fast path off — it encodes the
        # Poisson stencil).
        self.operator = operator
        if operator is not None:
            compact_smoother = False
        # Color-compact smoothing halves the sweep's memory traffic; it is
        # bit-equivalent to the masked formulation up to rounding (see
        # ops/stencils_compact.py). Disabled under GSPMD sharding for now
        # (the parity-split layout interacts poorly with the partitioner).
        self.compact_smoother = bool(compact_smoother) and shard_spec is None
        coarse_shape = hierarchy.shapes[-1]
        self.coarse_direct = bool(coarse_direct) and int(
            np.prod(coarse_shape)
        ) <= _COARSE_DIRECT_MAX
        if self.coarse_direct:
            if operator is None:
                cm = build_coarse_solver_matrix(
                    coarse_shape, hierarchy.dq[-1], self.bcs
                )
            else:
                # Operator-provided dense coarse assembly, or fall back
                # to relax-to-ex_tol when the operator doesn't offer one
                # (the reference's only coarse solve).
                cm = operator.coarse_matrix(
                    coarse_shape, hierarchy.dq[-1], self.bcs
                )
            if cm is None:
                self.coarse_direct = False
            else:
                S, int_mask = cm
                self._coarse_S = S
                self._coarse_rows = np.flatnonzero(int_mask)

        # Per-level spacings (static python floats -> device constants).
        self._dq = [np.asarray(d, dtype=np.float64) for d in hierarchy.dq]

        # Per-level-pair separable transfer matrices
        # (reference: mg_interp/mg_restrict drivers delegating to the
        # coordinate-based ninterp/nrestrict, ndsm_multigrid_core.f90:865,1010).
        self._interp_mats: List[List[np.ndarray]] = []
        self._restrict_mats: List[List[np.ndarray]] = []
        for l in range(hierarchy.ngrids - 1):
            fine = hierarchy.meshes[l]
            coarse = hierarchy.meshes[l + 1]
            self._interp_mats.append(
                [interp_matrix_1d(f, c) for f, c in zip(fine, coarse)]
            )
            self._restrict_mats.append(
                [restrict_matrix_1d(c, f) for f, c in zip(fine, coarse)]
            )

    # ------------------------------------------------------------------
    # Level primitives
    # ------------------------------------------------------------------

    def _constrain(self, x, level: int):
        """Pin the array to its level's sharding (sharded above the size
        threshold, replicated below) when running distributed."""
        if self.shard_spec is None:
            return x
        return self.shard_spec.constrain(x)

    def t_sweep(self, u, rhs, level: int):
        dq = self._dq[level]
        if self.operator is not None:
            return self._constrain(
                self.operator.relax(u, rhs, dq, self.bcs), level
            )
        return self._constrain(stencils.rb_sweep(u, rhs, dq, self.bcs), level)

    @_scoped("mg_smooth")
    def t_smooth(self, u, rhs, level: int, nsweeps: int | None = None):
        n = self.ms if nsweeps is None else nsweeps
        if n == 0:
            return u
        if self.compact_smoother and stencils_compact.compact_supported(
            u.shape, self.bcs
        ):
            return self._t_smooth_compact(u, rhs, level, n)
        if n == 1:
            return self.t_sweep(u, rhs, level)
        # fori_loop keeps the program one sweep long regardless of ms —
        # identical results, much smaller HLO (faster XLA compiles).
        return lax.fori_loop(
            0, n, lambda _, v: self.t_sweep(v, rhs, level), u
        )

    def _t_smooth_compact(self, u, rhs, level: int, n: int):
        """n sweeps in color-compact form: split once, sweep on the
        half-width color arrays (~2x less memory traffic per sweep), merge
        once.  Results match the masked path to rounding."""
        nx = u.shape[-1]
        dq = self._dq[level]
        R, B = stencils_compact.split_colors(u)
        rhs_R, rhs_B = stencils_compact.split_colors(rhs)

        def body(_, carry):
            R, B = carry
            return stencils_compact.rb_sweep_compact(
                R, B, rhs_R, rhs_B, dq, self.bcs, nx
            )

        if n == 1:
            R, B = body(0, (R, B))
        else:
            R, B = lax.fori_loop(0, n, body, (R, B))
        return stencils_compact.merge_colors(R, B, nx)

    @_scoped("mg_residual")
    def t_residual(self, u, rhs, level: int):
        if self.operator is not None:
            return self._constrain(
                self.operator.residual(u, rhs, self._dq[level], self.bcs),
                level,
            )
        return self._constrain(
            stencils.poisson_residual(u, rhs, self._dq[level], self.bcs), level
        )

    @_scoped("mg_restrict")
    def t_restrict(self, r, level: int):
        """Restrict fine-level ``r`` at ``level`` to level+1."""
        return self._constrain(
            apply_axis_matrices(r, self._restrict_mats[level]), level + 1
        )

    @_scoped("mg_prolong")
    def t_prolong(self, u_c, level: int):
        """Prolong coarse ``u_c`` at ``level+1`` to ``level``."""
        return self._constrain(
            apply_axis_matrices(u_c, self._interp_mats[level]), level
        )

    def t_metric(self, u_new, u_old):
        dmax, dmean = du_metrics(u_new, u_old)
        return dmax if self.du_max else dmean

    # ------------------------------------------------------------------
    # Coarse "exact" solve
    # ------------------------------------------------------------------

    @_scoped("mg_coarse")
    def t_solve_exact(self, u, rhs, level: int, ex_tol, nmax_exact):
        """Relax until the inter-iterate change is <= ex_tol or nmax_exact
        sweeps (reference: solve_exact, ndsm_multigrid_core.f90:728-800).
        The saved state starts zeroed exactly as in the reference (:757).

        Returns ``(u, noconv)``; ``noconv`` is True when nmax_exact was
        exhausted with du still above ex_tol — the condition the reference
        only PRINTs about (:796-798).  The flag is threaded up to
        ``SolveInfo.coarse_noconv`` and the warning printed host-side."""
        ex_tol = jnp.asarray(ex_tol).astype(self.dtype)
        big = jnp.asarray(jnp.finfo(self.dtype).max, dtype=self.dtype)

        def cond(c):
            _, _, du, it = c
            return jnp.logical_and(du > ex_tol, it < nmax_exact)

        def body(c):
            u, u_sav, _, it = c
            u = self.t_sweep(u, rhs, level)
            du = self.t_metric(u, u_sav)
            return (u, u, du, it + 1)

        init = (u, jnp.zeros_like(u), big, jnp.asarray(0, dtype=jnp.int32))
        u, _, du, _ = lax.while_loop(cond, body, init)
        return u, du > ex_tol

    # ------------------------------------------------------------------
    # Cycles
    # ------------------------------------------------------------------

    @_scoped("mg_coarse")
    def t_coarse_solve_direct(self, rhs):
        """One-matvec coarse solve via the precomputed (pseudo)inverse
        (see mg/coarse.py); replaces the relax-until-ex_tol loop when
        ``coarse_direct`` is enabled."""
        rows = jnp.asarray(self._coarse_rows)
        S = jnp.asarray(self._coarse_S, dtype=self.dtype)
        rhs_int = jnp.take(rhs.ravel(), rows)
        e_int = jnp.matmul(S, rhs_int, precision=jax.lax.Precision.HIGHEST)
        e = jnp.zeros(rhs.size, dtype=self.dtype).at[rows].set(e_int)
        return e.reshape(rhs.shape)

    def t_vcycle(self, u, rhs, ex_tol, nmax_exact):
        """One V-cycle on the finest level (reference: v_cycle,
        ndsm_multigrid_core.f90:341-377).  Returns ``(u, coarse_noconv)``."""
        L = self.h.ngrids
        us = [None] * L
        rhss = [None] * L
        us[0], rhss[0] = u, rhs

        # Descend (fine_to_coarse, :482-560).
        for l in range(L - 1):
            us[l] = self.t_smooth(us[l], rhss[l], l)
            r = self.t_residual(us[l], rhss[l], l)
            rhss[l + 1] = self.t_restrict(r, l)
            us[l + 1] = jnp.zeros(self.h.shapes[l + 1], dtype=self.dtype)

        # Coarsest-grid solve (:370)
        if self.coarse_direct and L > 1:
            us[L - 1] = self.t_coarse_solve_direct(rhss[L - 1])
            noconv = jnp.asarray(False)
        else:
            us[L - 1], noconv = self.t_solve_exact(
                us[L - 1], rhss[L - 1], L - 1, ex_tol, nmax_exact
            )

        # Ascend (coarse_to_fine, :593-684): correct, then post-smooth.
        for l in range(L - 2, -1, -1):
            uc = self.t_smooth(us[l + 1], rhss[l + 1], l + 1)
            cor = self.t_prolong(uc, l)
            us[l] = self.t_smooth(us[l] + cor, rhss[l], l)

        return us[0], noconv

    def t_vcycle_du(self, u, rhs, ex_tol, nmax_exact, u_ref):
        """t_vcycle PLUS the inter-iterate convergence metric against
        ``u_ref`` (the caller's saved pre-cycle iterate — reference
        du_metrics/update_u pairing, ndsm_multigrid_core.f90:808-853,
        1077-1122).  Returns ``(u_new, coarse_noconv, du)``."""
        u_new, noconv = self.t_vcycle(u, rhs, ex_tol, nmax_exact)
        du = self.t_metric(u_new, u_ref)
        return u_new, noconv, du

    def t_two_grid(self, u, rhs, ex_tol, nmax_exact):
        """Two-grid correction scheme for testing (reference: two_grid,
        ndsm_multigrid_core.f90:385-410).  Returns ``(u, coarse_noconv)``."""
        ul = self.t_smooth(u, rhs, 0)
        rhs_c = self.t_restrict(self.t_residual(ul, rhs, 0), 0)
        u_c = jnp.zeros(self.h.shapes[1], dtype=self.dtype)
        u_c, noconv = self.t_solve_exact(u_c, rhs_c, 1, ex_tol, nmax_exact)
        u_c = self.t_smooth(u_c, rhs_c, 1)
        cor = self.t_prolong(u_c, 0)
        return self.t_smooth(ul + cor, rhs, 0), noconv

    def t_one_grid(self, u, rhs, ex_tol, nmax_exact):
        """Single-grid relax-to-convergence (reference: one_grid,
        ndsm_multigrid_core.f90:424-441).  Returns ``(u, noconv)``."""
        return self.t_solve_exact(u, rhs, 0, ex_tol, nmax_exact)
