"""Lane-masked multigrid solves over problems with DIFFERENT boundary
conditions — one compiled program for the three 3D vector-potential
component solves (reference: solve(), ndsm_vector_potential.f90:598-691,
which runs Ax/Ay/Az strictly sequentially).

``PoissonBVP.solve_batch`` vmaps one engine over same-BC problems; here
the BCs differ per lane (Neumann on the faces normal to the component,
Dirichlet elsewhere — :655,:671,:687), so every mask — checkerboard
parity with the per-lane first color, Dirichlet freezing, residual
zeroing — is carried as a per-lane ARRAY and the stencil/transfer/coarse
operators act on a stacked (B, nz, ny, nx) state.  A converged lane is
frozen by the driver, so each lane's iterate sequence is identical to a
standalone solve (tests/test_batched.py asserts bit-level agreement).

Grid transfers are BC-independent and contract axes 1..3 with the same
per-axis matrices; the coarse direct solve uses per-lane full-size
(pseudo)inverse embeddings (the interior row sets differ per lane, so
the reduced-row form would be ragged).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..grids import GridHierarchy
from ..options import IERR_COVFAIL, IERR_SUCCESS, Options, SolveInfo
from ..ops import stencils
from ..ops.transfer import interp_matrix_1d, restrict_matrix_1d
from .coarse import build_coarse_solver_matrix

__all__ = ["MultiBCSolver"]


def _neighbors_b(u: jax.Array, ax: int) -> Tuple[jax.Array, jax.Array]:
    """stencils._neighbors along a GRID axis (ax >= 1) of a stacked
    (B, *grid) array — identical reflection arithmetic."""
    return stencils._neighbors(u, ax)


def _apply_axis_matrices_b(x: jax.Array, mats: Sequence[np.ndarray]) -> jax.Array:
    """ops.transfer.apply_axis_matrices on axes 1.. of a stacked array."""
    for ax, m in enumerate(mats):
        mj = jnp.asarray(m, dtype=x.dtype)
        x = jnp.moveaxis(x, ax + 1, 0)
        x = jnp.tensordot(
            mj, x, axes=([1], [0]), precision=jax.lax.Precision.HIGHEST
        )
        x = jnp.moveaxis(x, 0, ax + 1)
    return x


class MultiBCSolver:
    """Mixed/fp32/fp64 multigrid solver for B same-shape problems with
    per-lane BCs, compiled as ONE lane-masked program.

    Restrictions: no lane may be all-Neumann (the per-sweep global mean
    subtraction would interleave with lane freezing), and the coarse
    solve is the direct (pseudo)inverse for mixed/fp32 — exactly the
    configurations of the vector-potential component solves.
    """

    def __init__(
        self,
        hierarchy: GridHierarchy,
        bcs_list: Sequence[Sequence[Sequence[str]]],
        options: Options = Options(),
    ):
        self.h = hierarchy
        self.bcs_list = tuple(
            stencils.validate_bcs(b, hierarchy.ndim) for b in bcs_list
        )
        if any(stencils.is_all_neumann(b) for b in self.bcs_list):
            raise ValueError("all-Neumann lanes are not batchable")
        self.B = len(self.bcs_list)
        self.options = options
        self.mode = options.resolve_precision()
        self.outer_dtype = jnp.float32 if self.mode == "fp32" else jnp.float64
        self.inner_dtype = jnp.float64 if self.mode == "fp64" else jnp.float32
        cs = getattr(options, "coarse_solver", "auto")
        self.coarse_direct = cs == "direct" or (cs == "auto" and self.mode != "fp64")
        self._inner_max = (
            max(1, int(getattr(options, "mixed_inner_max", 6)))
            if self.mode != "fp64"
            else 1
        )

        # Per-level-pair transfer matrices (shared across lanes).
        self._interp: List[List[np.ndarray]] = []
        self._restrict: List[List[np.ndarray]] = []
        for l in range(hierarchy.ngrids - 1):
            fine, coarse = hierarchy.meshes[l], hierarchy.meshes[l + 1]
            self._interp.append([interp_matrix_1d(f, c) for f, c in zip(fine, coarse)])
            self._restrict.append(
                [restrict_matrix_1d(c, f) for f, c in zip(fine, coarse)]
            )
        self._dq = [np.asarray(d, dtype=np.float64) for d in hierarchy.dq]

        # Per-level per-lane masks: first-updated / second-updated color
        # (parity with the lane's first color, Dirichlet-interior only)
        # and the residual interior mask.
        self._m1: List[np.ndarray] = []
        self._m2: List[np.ndarray] = []
        self._mint: List[np.ndarray] = []
        for shape in hierarchy.shapes:
            m1 = np.zeros((self.B,) + shape, dtype=bool)
            m2 = np.zeros((self.B,) + shape, dtype=bool)
            mi = np.zeros((self.B,) + shape, dtype=bool)
            idx = np.indices(shape).sum(axis=0)
            for b, bcs in enumerate(self.bcs_list):
                interior = np.ones(shape, dtype=bool)
                for ax, (blo, bhi) in enumerate(bcs):
                    sl = [slice(None)] * len(shape)
                    if blo == "D":
                        sl[ax] = 0
                        interior[tuple(sl)] = False
                    if bhi == "D":
                        sl2 = list(sl)
                        sl2[ax] = shape[ax] - 1
                        interior[tuple(sl2)] = False
                first = stencils.first_color_parity(bcs)
                m1[b] = ((idx % 2) == first) & interior
                m2[b] = ((idx % 2) == 1 - first) & interior
                mi[b] = interior
            self._m1.append(m1)
            self._m2.append(m2)
            self._mint.append(mi)

        # Per-lane full-size coarse solvers (identity-free embedding:
        # rows outside the lane's interior produce e = 0).
        if self.coarse_direct:
            cshape = hierarchy.shapes[-1]
            N = int(np.prod(cshape))
            S_stack = np.zeros((self.B, N, N))
            for b, bcs in enumerate(self.bcs_list):
                S, int_mask = build_coarse_solver_matrix(
                    cshape, hierarchy.dq[-1], bcs
                )
                rows = np.flatnonzero(int_mask)
                S_stack[b][np.ix_(rows, rows)] = S
            self._coarse_S = S_stack

        self._solve_jit = jax.jit(self._solve_impl, donate_argnums=(0,))

    # -- batched level ops ---------------------------------------------

    def _sweep(self, u, rhs, level):
        w, w0 = stencils.stencil_weights(self._dq[level], u.dtype)

        def half(u, mask):
            total = None
            for ax in range(1, u.ndim):
                lo, hi = _neighbors_b(u, ax)
                term = (lo + hi) * w[ax - 1]
                total = term if total is None else total + term
            unew = (total - rhs) * w0
            return jnp.where(mask, unew, u)

        u = half(u, jnp.asarray(self._m1[level]))
        u = half(u, jnp.asarray(self._m2[level]))
        return u

    def _smooth(self, u, rhs, level, n):
        return lax.fori_loop(0, n, lambda _, v: self._sweep(v, rhs, level), u)

    def _residual(self, u, rhs, level):
        w, _ = stencils.stencil_weights(self._dq[level], u.dtype)
        lap = None
        for ax in range(1, u.ndim):
            lo, hi = _neighbors_b(u, ax)
            term = (lo - 2.0 * u + hi) * w[ax - 1]
            lap = term if lap is None else lap + term
        r = rhs - lap
        return jnp.where(
            jnp.asarray(self._mint[level]), r, jnp.zeros((), dtype=u.dtype)
        )

    def _coarse_solve(self, rhs):
        S = jnp.asarray(self._coarse_S, dtype=rhs.dtype)
        r = rhs.reshape(self.B, -1)
        e = jnp.einsum(
            "bij,bj->bi", S, r, precision=jax.lax.Precision.HIGHEST
        )
        return e.reshape(rhs.shape)

    def _vcycle(self, u, rhs, ex_tol, nmax_exact):
        L = self.h.ngrids
        ms = self.options.ms
        us = [None] * L
        rhss = [None] * L
        us[0], rhss[0] = u, rhs
        for l in range(L - 1):
            us[l] = self._smooth(us[l], rhss[l], l, ms)
            r = self._residual(us[l], rhss[l], l)
            rhss[l + 1] = _apply_axis_matrices_b(r, self._restrict[l])
            us[l + 1] = jnp.zeros(
                (self.B,) + self.h.shapes[l + 1], dtype=u.dtype
            )
        if self.coarse_direct:
            us[L - 1] = self._coarse_solve(rhss[L - 1])
            noconv = jnp.zeros((self.B,), dtype=bool)
        else:
            us[L - 1], noconv = self._coarse_relax(
                us[L - 1], rhss[L - 1], L - 1, ex_tol, nmax_exact
            )
        for l in range(L - 2, -1, -1):
            uc = self._smooth(us[l + 1], rhss[l + 1], l + 1, ms)
            cor = _apply_axis_matrices_b(uc, self._interp[l])
            us[l] = self._smooth(us[l] + cor, rhss[l], l, ms)
        return us[0], noconv

    def _vcycle_du(self, u, rhs, ex_tol, nmax_exact, u_ref):
        """_vcycle + per-lane inter-iterate metric vs ``u_ref``."""
        u_new, noconv = self._vcycle(u, rhs, ex_tol, nmax_exact)
        return u_new, noconv, self._metric(u_new, u_ref)

    def _metric(self, a, b):
        """Per-lane max/mean |a - b| over the grid axes."""
        d = jnp.abs(a - b).reshape(self.B, -1)
        if self.options.du_max:
            return jnp.max(d, axis=1)
        return jnp.mean(d, axis=1)

    def _coarse_relax(self, u, rhs, level, ex_tol, nmax_exact):
        """Per-lane relax-to-ex_tol with lane freezing (reference
        solve_exact semantics per lane, ndsm_multigrid_core.f90:728)."""
        ex_tol = jnp.asarray(ex_tol).astype(u.dtype)
        big = jnp.asarray(jnp.finfo(u.dtype).max, u.dtype)

        def cond(c):
            _, _, du, it = c
            return jnp.any(jnp.logical_and(du > ex_tol, it < nmax_exact))

        def body(c):
            u, usav, du, it = c
            active = jnp.logical_and(du > ex_tol, it < nmax_exact)
            sel = active.reshape((self.B,) + (1,) * (u.ndim - 1))
            u_new = self._sweep(u, rhs, level)
            u_new = jnp.where(sel, u_new, u)
            du_new = jnp.where(active, self._metric(u_new, usav), du)
            return (u_new, u_new, du_new, it + active.astype(jnp.int32))

        init = (u, jnp.zeros_like(u), jnp.full((self.B,), big), jnp.zeros((self.B,), jnp.int32))
        u, _, du, _ = lax.while_loop(cond, body, init)
        return u, du > ex_tol

    def _mixed_group(self, u, rhs, ex_tol, nmax_exact, vc_tol, it_vec, nmax, inner_max):
        """Per-lane f64 defect correction supported by up to
        ``inner_max`` f32 V-cycles (PoissonBVP._mixed_group with explicit
        lane masks: a lane whose f32 iteration stalls or converges
        freezes while the others keep cycling, so per-lane iterate
        sequences match standalone solves).  Returns
        (u_new, noconv, du_last, ncyc) with per-lane du/ncyc."""
        B = self.B
        shape1 = (B,) + (1,) * (u.ndim - 1)
        r0 = self._residual(u, rhs, 0)
        s = jnp.max(jnp.abs(r0).reshape(B, -1), axis=1)
        s_safe = jnp.where(s > 0, s, jnp.ones_like(s))
        sb = s_safe.reshape(shape1)
        r32 = (r0 / sb).astype(self.inner_dtype)
        eps32 = 32.0 * float(np.finfo(np.float32).eps)
        ex_tol_eff = jnp.maximum(ex_tol, eps32)
        e0 = jnp.zeros(r32.shape, dtype=self.inner_dtype)
        big32 = jnp.asarray(jnp.finfo(np.float32).max, dtype=jnp.float32)

        def du_of(du_e):
            d = s_safe * du_e.astype(self.outer_dtype)
            return jnp.where(s > 0, d, jnp.zeros_like(d))

        def act_of(c):
            _, du_e, du_prev, k, _ = c
            first = k == 0
            # Deterministic quantum (no rate-stall knife edge) — keeps
            # per-lane schedules identical to standalone solves.
            more = (
                (du_of(du_e) >= vc_tol)
                & (it_vec + k < nmax)
                & (k < inner_max)
            )
            return first | more

        def cond(c):
            return jnp.any(act_of(c))

        def body(c):
            e, du_e, du_prev, k, nc = c
            a = act_of(c)
            e_new, noconv, du_new = self._vcycle_du(
                e, r32, ex_tol_eff, nmax_exact, e
            )
            sel = a.reshape(shape1)
            du_prev = jnp.where(a, du_e, du_prev)
            return (
                jnp.where(sel, e_new, e),
                jnp.where(a, du_new, du_e),
                du_prev,
                k + a.astype(jnp.int32),
                nc | (noconv & a),
            )

        init = (
            e0,
            jnp.full((B,), big32),
            jnp.full((B,), big32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), bool),
        )
        if inner_max == 1:
            e32, du_e, _, k, noconv = body(init)
        else:
            e32, du_e, _, k, noconv = lax.while_loop(cond, body, init)
        e = e32.astype(self.outer_dtype) * sb
        e = jnp.where((s > 0).reshape(shape1), e, jnp.zeros_like(e))
        return u + e, noconv, du_of(du_e), k

    # -- driver ---------------------------------------------------------

    def _solve_impl(self, u0, vc_tol, ex_tol, nmax, nmax_exact):
        """Lane-masked outer loop — the semantics of
        PoissonBVP._solve_batch_impl with per-lane BCs.  The zero RHS of
        the component solves is materialized in-program (XLA folds
        ``0 - lap`` to ``-lap``: no dead 3x134 MB upload/stream); mixed
        V-cycles run in per-lane defect groups (``_mixed_group``)."""
        rhs = jnp.zeros_like(u0)
        mixed = self.mode != "fp64"
        inner_max = self._inner_max
        big = jnp.asarray(jnp.finfo(self.outer_dtype).max, self.outer_dtype)
        vc_tol = jnp.asarray(vc_tol).astype(self.outer_dtype)

        def active_of(du, it):
            return jnp.logical_and(it < nmax, du >= vc_tol)

        def cond(c):
            _, du, it, _ = c
            return jnp.any(active_of(du, it))

        def body(c):
            u, du, it, flag = c
            active = active_of(du, it)
            if mixed:
                u_new, noconv, du_new, ncyc = self._mixed_group(
                    u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max
                )
            else:
                u_new, noconv, du_new = self._vcycle_du(
                    u, rhs, ex_tol, nmax_exact, u
                )
                ncyc = jnp.ones((self.B,), jnp.int32)
            sel = active.reshape((self.B,) + (1,) * (u.ndim - 1))
            u = jnp.where(sel, u_new, u)
            du = jnp.where(active, du_new, du)
            it = it + jnp.where(active, ncyc, 0)
            return (u, du, it, flag | (noconv & active))

        init = (
            u0,
            jnp.full((self.B,), big),
            jnp.zeros((self.B,), jnp.int32),
            jnp.zeros((self.B,), bool),
        )
        u, du, it, flag = lax.while_loop(cond, body, init)
        ierr = jnp.where(du < vc_tol, IERR_SUCCESS, IERR_COVFAIL).astype(jnp.int32)
        return u, du, it, ierr, flag

    def solve(self, u0_stack, *, names=None) -> Tuple[jax.Array, List[SolveInfo]]:
        """Solve the B problems from stacked initial data (B, *grid) with
        zero right-hand sides (the component-solve configuration).
        Returns (u_stack, [SolveInfo] * B)."""
        import time as _time

        o = self.options
        names = names or [""] * self.B
        u0 = jnp.asarray(u0_stack, self.outer_dtype)
        t0 = _time.perf_counter()
        u, du, it, ierr, flag = self._solve_jit(
            u0,
            jnp.float64(o.vc_tol),
            jnp.float64(o.ex_tol),
            jnp.int32(o.ncycles_max),
            jnp.int32(o.niterex_max),
        )
        du, it, ierr, flag = jax.device_get((du, it, ierr, flag))
        wall = _time.perf_counter() - t0
        infos = [
            SolveInfo(
                ierr=int(ierr[b]),
                du_last=float(du[b]),
                cycles=int(it[b]),
                name=names[b],
                wall_time=wall,
                coarse_noconv=bool(flag[b]),
                batch_size=self.B,
            )
            for b in range(self.B)
        ]
        from .poisson import PoissonBVP

        PoissonBVP._post_warnings(infos)
        return u, infos
