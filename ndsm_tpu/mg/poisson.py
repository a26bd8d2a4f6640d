"""Poisson boundary-value-problem driver: V-cycle iteration with the
inter-cycle convergence metric, tolerance logic and error flags of the
reference (``solve_poisson_bvp``, fortran/ndsm_poisson.f90:63-155), plus a
mixed-precision mode.

Precision modes
---------------
  * ``fp64``: the whole algorithm runs in float64 — step-for-step the
    reference algorithm.
  * ``mixed`` (the default off the CPU): each outer iteration computes the defect
    ``r = rhs - L[u]`` in float64, solves ``L e = r`` with one float32
    V-cycle (scaled to unit magnitude so float32 resolution is always
    sufficient), and applies ``u += e`` in float64.  For a linear problem a
    V-cycle is a linear fixed-point iteration, so the correction-equation
    cycle from a zero initial guess is algebraically identical to cycling
    on ``u`` directly; the convergence metric du = |Δu| between cycles and
    the vc_tol contract are evaluated in float64 exactly as in fp64 mode.
    The only deviation: the coarse-grid ex_tol is floored at ~32·eps_f32
    of the (unit-scaled) correction, which can slightly change the
    V-cycle count but not the converged solution (guarded by the float64
    outer loop).
  * ``fp32``: everything float32 (use with loose tolerances).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..grids import GridHierarchy
from ..options import IERR_COVFAIL, IERR_SUCCESS, Options, SolveInfo
from ..ops import stencils
from ..utils.caching import BoundedCache
from ..utils.msgs import warn
from .engine import MGEngine

__all__ = ["PoissonBVP", "solve_poisson_bvp"]

# Engines hold transfer matrices and (for direct coarse solves) a dense
# pseudo-inverse; BVPs additionally pin compiled executables.  Bounded
# LRU caches keep a many-shape long-lived process from accumulating them
# without limit while still giving the common reuse patterns (repeated
# solves at one size; the nine sub-solves of a vector-potential call)
# full hit rates.
_ENGINE_CACHE: BoundedCache = BoundedCache(maxsize=64)

_COARSE_NOCONV_WARNING = (
    "Warning: IOPT_NMAXEX exceeded. Coarse-mesh solution may not have converged"
)
_COVFAIL_WARNING = (
    "Warning: IOPT_NCYCLES exceeded. V-cycle iteration may not have converged"
)


def _cached_engine(
    hierarchy, bcs, ms, du_max, dtype, shard_spec=None, coarse_direct=False,
    compact_smoother=True, operator=None,
):
    key = (
        hierarchy, bcs, ms, du_max, jnp.dtype(dtype).name, shard_spec,
        coarse_direct, compact_smoother, operator,
    )
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        eng = MGEngine(
            hierarchy,
            bcs,
            ms=ms,
            du_max=du_max,
            dtype=dtype,
            shard_spec=shard_spec,
            coarse_direct=coarse_direct,
            compact_smoother=compact_smoother,
            operator=operator,
        )
        _ENGINE_CACHE.put(key, eng)
    return eng


class PoissonBVP:
    """A reusable handle for one Poisson BVP configuration — the analogue of
    ``MG_HANDLE`` + ``solve_poisson_bvp`` (reference usage pattern:
    tests/unit_tests/unit_test_2D_solve.f90:202-211).

    Parameters:
      hierarchy: static level metadata (shapes, meshes, spacings).
      bcs: per-axis ("N"/"D", "N"/"D") homogeneous boundary conditions,
        ordered like the array axes (C order).
      options: solver options; ``options.precision`` picks the mode.
    """

    def __init__(
        self,
        hierarchy: GridHierarchy,
        bcs: Sequence[Sequence[str]],
        options: Options = Options(),
        shard_spec=None,
        operator=None,
    ):
        self.h = hierarchy
        self.bcs = stencils.validate_bcs(bcs, hierarchy.ndim)
        self.options = options
        self.shard_spec = shard_spec
        # Injected operator (mg/operator.py): every path below —
        # fp64/fp32 cycles, the mixed defect residual, the coarse solve
        # — routes through MGEngine and therefore through the operator.
        self.operator = operator
        self.mode = options.resolve_precision()
        if self.mode not in ("fp64", "mixed", "fp32"):
            raise ValueError(f"unknown precision mode {self.mode!r}")
        self.outer_dtype = jnp.float32 if self.mode == "fp32" else jnp.float64
        self.inner_dtype = jnp.float64 if self.mode == "fp64" else jnp.float32
        du_max = options.du_max
        cs = getattr(options, "coarse_solver", "auto")
        coarse_direct = cs == "direct" or (cs == "auto" and self.mode != "fp64")
        compact = getattr(options, "smoother", "auto") != "masked"
        self._inner = _cached_engine(
            hierarchy,
            self.bcs,
            options.ms,
            du_max,
            self.inner_dtype,
            shard_spec,
            coarse_direct,
            compact,
            operator,
        )
        self._outer = (
            self._inner
            if self.inner_dtype == self.outer_dtype
            else _cached_engine(
                hierarchy, self.bcs, options.ms, du_max, self.outer_dtype,
                shard_spec, operator=operator,
            )
        )
        self._all_neumann = (
            operator.is_singular(self.bcs)
            if operator is not None
            else stencils.is_all_neumann(self.bcs)
        )
        # Mixed mode runs V-cycles in defect groups of up to this many
        # inner f32 cycles per f64 defect (Options.mixed_inner_max);
        # direct modes always 1.  Checkpointed solves pass 1 explicitly.
        self._inner_max = (
            max(1, int(getattr(options, "mixed_inner_max", 6)))
            if self.mode == "mixed"
            else 1
        )
        self._solve_jit = jax.jit(self._solve_impl, static_argnums=(6,))
        # Donating variant for internally-owned buffers (the caller's u0
        # is invalidated) and a zero-rhs variant that materializes the
        # right-hand side inside the program (saves a full-grid buffer +
        # upload for the common rhs == 0 solves).
        self._solve_jit_donate = jax.jit(
            self._solve_impl, donate_argnums=(0,), static_argnums=(6,)
        )
        self._solve_zero_rhs_jit = jax.jit(
            self._solve_impl_zero_rhs, static_argnums=(5,)
        )
        self._solve_zero_rhs_jit_donate = jax.jit(
            self._solve_impl_zero_rhs, donate_argnums=(0,), static_argnums=(5,)
        )
        self._solve_hist_jit = jax.jit(self._solve_hist_impl, static_argnums=(6,))
        self._solve_batch_jit = None
        self._vcycle_jit = jax.jit(self._inner.t_vcycle)
        self._two_grid_jit = jax.jit(self._inner.t_two_grid)
        self._one_grid_jit = jax.jit(self._inner.t_one_grid)

    # ------------------------------------------------------------------

    def _mixed_group(
        self, u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max, hist
    ):
        """One f64 defect correction supported by UP TO ``inner_max``
        f32 V-cycles (the mixed-precision core: one f64 defect pass is
        amortized over every inner cycle it can support).

        The inner loop keeps cycling on the SAME scaled defect while the
        f32 iteration still converges well (du_e < 0.5 * previous — the
        f32 resolution stall test), the per-cycle du (= s * du_e, the
        same inter-iterate metric the reference stops on) is >= vc_tol,
        and the global V-cycle budget ``nmax`` has room.  Each inner
        V-cycle is an implied outer iterate u + s*e_k, so the per-cycle
        du sequence, cycle counting, and du-history entries all keep
        their reference semantics (ndsm_poisson.f90:116-141); only the
        frequency of f64 re-measurement changes, which perturbs iterates
        at f64 rounding level.  With inner_max=1 this IS the strict
        defect-correction iteration.

        Returns (u_new, noconv, du_last, ncycles, hist).
        """
        eng64, eng32 = self._outer, self._inner
        with jax.named_scope("mg_defect"):
            r0 = eng64.t_residual(u, rhs, 0)
        s = jnp.max(jnp.abs(r0))
        s_safe = jnp.where(s > 0, s, jnp.ones_like(s))
        r32 = (r0 / s_safe).astype(self.inner_dtype)
        eps32 = 32.0 * float(np.finfo(np.float32).eps)
        ex_tol_eff = jnp.maximum(ex_tol, eps32)
        e0 = jnp.zeros(self.h.fine_shape, dtype=self.inner_dtype)
        big32 = jnp.asarray(jnp.finfo(np.float32).max, dtype=jnp.float32)

        def du_of(du_e):
            d = s_safe * du_e.astype(self.outer_dtype)
            return jnp.where(s > 0, d, jnp.zeros_like(d))

        def cond(c):
            _, du_e, du_prev, k, _, _ = c
            first = k == 0
            # No rate-based stall test: a du-ratio threshold is a
            # rounding knife-edge that lets batched/standalone schedules
            # diverge.  inner_max bounds the group deterministically
            # (sized to f32's ~7-decade headroom per defect), so per-lane
            # sequences stay identical across drivers.
            more = jnp.logical_and(
                du_of(du_e) >= vc_tol,
                jnp.logical_and(it + k < nmax, k < inner_max),
            )
            return jnp.logical_or(first, more)

        def body(c):
            e, du_e, _, k, nc, h = c
            e_new, noconv, du_new = eng32.t_vcycle_du(
                e, r32, ex_tol_eff, nmax_exact, e
            )
            if h is not None:
                h = h.at[it + k].set(du_of(du_new))
            return (e_new, du_new, du_e, k + 1, nc | noconv, h)

        if inner_max == 1:
            e32, du_e, _, k, noconv, hist = body(
                (e0, big32, big32, jnp.int32(0), jnp.asarray(False), hist)
            )
        else:
            init = (e0, big32, big32, jnp.int32(0), jnp.asarray(False), hist)
            e32, du_e, _, k, noconv, hist = lax.while_loop(cond, body, init)
        e = e32.astype(self.outer_dtype) * s_safe
        e = jnp.where(s > 0, e, jnp.zeros_like(e))
        u_new = u + e
        if self._all_neumann:
            u_new = u_new - jnp.mean(u_new)
        return u_new, noconv, du_of(du_e), k, hist

    def _solve_impl_zero_rhs(self, u0, vc_tol, ex_tol, nmax, nmax_exact, inner_max):
        rhs = jnp.zeros(self.h.fine_shape, dtype=self.outer_dtype)
        return self._solve_impl(u0, rhs, vc_tol, ex_tol, nmax, nmax_exact, inner_max)

    def _solve_impl(self, u0, rhs, vc_tol, ex_tol, nmax, nmax_exact, inner_max):
        """Outer V-cycle loop (reference: VCYCLE_LOOP,
        ndsm_poisson.f90:116-141): iterate until the selected inter-cycle
        metric du is < vc_tol, or nmax cycles have run (-> IERR_COVFAIL).
        Also accumulates the coarse-solve non-convergence flag across
        cycles (reference warning: ndsm_multigrid_core.f90:796-798).

        In mixed mode, cycles run in defect GROUPS (``_mixed_group``):
        ``it`` still counts individual V-cycles and ``du`` is still the
        latest per-V-cycle inter-iterate metric."""
        mixed = self.mode == "mixed"
        inner_max = max(1, int(inner_max))
        big = jnp.asarray(jnp.finfo(self.outer_dtype).max, dtype=self.outer_dtype)
        vc_tol = jnp.asarray(vc_tol).astype(self.outer_dtype)

        def cond(c):
            _, du, it, _ = c
            return jnp.logical_and(it < nmax, du >= vc_tol)

        def body(c):
            u, _, it, flag = c
            if mixed:
                u_new, noconv, du, ncyc, _ = self._mixed_group(
                    u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max, None
                )
            else:
                u_new, noconv, du = self._inner.t_vcycle_du(
                    u, rhs, ex_tol, nmax_exact, u
                )
                ncyc = jnp.int32(1)
            if self.options.debug:
                jax.debug.print(
                    "DEBUG(solve_poisson_bvp): Solution delta: {du}", du=du
                )
            return (u_new, du, it + ncyc, flag | noconv)

        init = (u0, big, jnp.asarray(0, dtype=jnp.int32), jnp.asarray(False))
        u, du, it, flag = lax.while_loop(cond, body, init)
        ierr = jnp.where(du < vc_tol, IERR_SUCCESS, IERR_COVFAIL).astype(jnp.int32)
        return u, du, it, ierr, flag

    def _solve_hist_impl(self, u0, rhs, vc_tol, ex_tol, nmax, nmax_exact, hist_len):
        """``_solve_impl`` plus a per-cycle du trace in a fixed-size buffer
        (the reference's debug-mode per-cycle "Solution delta" output,
        ndsm_poisson.f90:129-135, as a first-class return).  ``hist_len``
        is static; cycles
        are capped at min(nmax, hist_len).  The iterate sequence is
        identical to ``_solve_impl`` (mixed defect groups write one
        history entry per inner V-cycle)."""
        mixed = self.mode == "mixed"
        inner_max = self._inner_max
        big = jnp.asarray(jnp.finfo(self.outer_dtype).max, dtype=self.outer_dtype)
        vc_tol = jnp.asarray(vc_tol).astype(self.outer_dtype)
        nmax = jnp.minimum(nmax, jnp.int32(hist_len))

        def cond(c):
            _, du, it, _, _ = c
            return jnp.logical_and(it < nmax, du >= vc_tol)

        def body(c):
            u, _, it, hist, flag = c
            if mixed:
                u_new, noconv, du, ncyc, hist = self._mixed_group(
                    u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max, hist
                )
            else:
                u_new, noconv, du = self._inner.t_vcycle_du(
                    u, rhs, ex_tol, nmax_exact, u
                )
                hist = hist.at[it].set(du)
                ncyc = jnp.int32(1)
            return (u_new, du, it + ncyc, hist, flag | noconv)

        hist0 = jnp.full((hist_len,), jnp.nan, dtype=self.outer_dtype)
        init = (u0, big, jnp.asarray(0, dtype=jnp.int32), hist0, jnp.asarray(False))
        u, du, it, hist, flag = lax.while_loop(cond, body, init)
        converged = du < vc_tol
        ierr = jnp.where(converged, IERR_SUCCESS, IERR_COVFAIL).astype(jnp.int32)
        return u, du, it, ierr, hist, flag

    def _solve_batch_impl(self, u0, rhs, vc_tol, ex_tol, nmax, nmax_exact):
        """Lane-masked batched variant of ``_solve_impl``: solves B
        independent problems of identical configuration (u0, rhs shaped
        (B, *grid)) in ONE program.  A converged lane is frozen, so each
        lane's iterate/metric sequence is identical to a standalone solve;
        the loop runs until every lane converges or hits nmax.  Requires a
        while_loop-free coarse solve (coarse_direct) so the cycle can be
        vmapped without cross-lane iteration coupling.  Mixed defect
        groups vmap too (the lane-wise inner while_loops run lock-step
        under the batching rule with per-lane freezing)."""
        mixed = self.mode == "mixed"
        inner_max = self._inner_max
        big = jnp.asarray(jnp.finfo(self.outer_dtype).max, dtype=self.outer_dtype)
        vc_tol = jnp.asarray(vc_tol).astype(self.outer_dtype)
        B = u0.shape[0]

        if mixed:
            groupB = jax.vmap(
                lambda u, r, it: self._mixed_group(
                    u, r, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max, None
                )
            )
        else:
            cycleB = jax.vmap(
                lambda u, r: self._inner.t_vcycle_du(u, r, ex_tol, nmax_exact, u)
            )

        def active_of(du, it):
            return jnp.logical_and(it < nmax, du >= vc_tol)

        def cond(c):
            _, du, it, _ = c
            return jnp.any(active_of(du, it))

        def body(c):
            u, du, it, flag = c
            active = active_of(du, it)
            if mixed:
                u_new, noconv, du_new, ncyc, _ = groupB(u, rhs, it)
            else:
                u_new, noconv, du_new = cycleB(u, rhs)
                ncyc = jnp.ones((B,), jnp.int32)
            sel = active.reshape((B,) + (1,) * (u.ndim - 1))
            u = jnp.where(sel, u_new, u)
            du = jnp.where(active, du_new, du)
            it = it + jnp.where(active, ncyc, 0)
            return (u, du, it, flag | (noconv & active))

        init = (
            u0,
            jnp.full((B,), big),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), bool),
        )
        u, du, it, flag = lax.while_loop(cond, body, init)
        converged = du < vc_tol
        ierr = jnp.where(converged, IERR_SUCCESS, IERR_COVFAIL).astype(jnp.int32)
        return u, du, it, ierr, flag

    def solve_batch(
        self,
        u0s,
        rhss,
        *,
        vc_tol: Optional[float] = None,
        ex_tol: Optional[float] = None,
        ncycles_max: Optional[int] = None,
        niterex_max: Optional[int] = None,
        names: Optional[Sequence[str]] = None,
    ):
        """Solve B same-configuration problems in one compiled program.
        Falls back to sequential ``solve`` when the coarse solver is the
        reference relax loop (its while_loop cannot be lane-masked)."""
        o = self.options
        vc_tol = o.vc_tol if vc_tol is None else vc_tol
        ex_tol = o.ex_tol if ex_tol is None else ex_tol
        nmax = o.ncycles_max if ncycles_max is None else ncycles_max
        nmax_exact = o.niterex_max if niterex_max is None else niterex_max
        names = names or [""] * len(u0s)

        if not self._inner.coarse_direct:
            out = [
                self.solve(
                    u0,
                    rhs,
                    vc_tol=vc_tol,
                    ex_tol=ex_tol,
                    ncycles_max=nmax,
                    niterex_max=nmax_exact,
                    name=nm,
                )
                for u0, rhs, nm in zip(u0s, rhss, names)
            ]
            return [u for u, _ in out], [i for _, i in out]

        import time as _time

        u0 = jnp.stack([jnp.asarray(u, self.outer_dtype) for u in u0s])
        rhs = jnp.stack([jnp.asarray(r, self.outer_dtype) for r in rhss])
        if self._solve_batch_jit is None:
            self._solve_batch_jit = jax.jit(self._solve_batch_impl)
        t0 = _time.perf_counter()
        scalars = (
            jnp.float64(vc_tol),
            jnp.float64(ex_tol),
            jnp.int32(nmax),
            jnp.int32(nmax_exact),
        )
        u, du, it, ierr, flag = self._solve_batch_jit(u0, rhs, *scalars)
        du, it, ierr, flag = jax.device_get((du, it, ierr, flag))  # one host sync
        wall = _time.perf_counter() - t0
        # wall_time is the whole batched program's wall (lanes run
        # simultaneously — there is no honest per-lane wall); batch_size
        # flags the sharing for downstream accounting.
        infos = [
            SolveInfo(
                ierr=int(ierr[k]),
                du_last=float(du[k]),
                cycles=int(it[k]),
                name=names[k],
                wall_time=wall,
                coarse_noconv=bool(flag[k]),
                batch_size=len(u0s),
            )
            for k in range(len(u0s))
        ]
        self._post_warnings(infos)
        return list(u), infos

    # ------------------------------------------------------------------

    def solve(
        self,
        u0,
        rhs,
        *,
        vc_tol: Optional[float] = None,
        ex_tol: Optional[float] = None,
        ncycles_max: Optional[int] = None,
        niterex_max: Optional[int] = None,
        name: str = "",
        donate: bool = False,
        zero_rhs: bool = False,
        history: bool = False,
    ) -> Tuple[jax.Array, SolveInfo]:
        """Solve ``laplace(u) = rhs`` starting from ``u0`` (which also
        carries inhomogeneous Dirichlet data on "D" faces — those values
        are held fixed, reference: ndsm_poisson.f90:591-594).

        Returns (u, SolveInfo).  Tolerances default to the handle options.
        ``donate=True`` invalidates the caller's u0 buffer (memory-tight
        large solves); ``zero_rhs=True`` ignores ``rhs`` and materializes
        a zero right-hand side inside the program; ``history=True``
        additionally records the per-cycle du trace in
        ``SolveInfo.du_history`` (the reference's debug-mode per-cycle
        "Solution delta" lines, ndsm_poisson.f90:129-135).
        """
        o = self.options
        vc_tol = o.vc_tol if vc_tol is None else vc_tol
        ex_tol = o.ex_tol if ex_tol is None else ex_tol
        nmax = o.ncycles_max if ncycles_max is None else ncycles_max
        nmax_exact = o.niterex_max if niterex_max is None else niterex_max

        u0 = jnp.asarray(u0, dtype=self.outer_dtype)
        if self.shard_spec is not None:
            u0 = self.shard_spec.put(u0)
        if u0.shape != self.h.fine_shape:
            raise ValueError(
                f"u0 shape {u0.shape} != fine grid {self.h.fine_shape}"
            )
        import time as _time

        t0 = _time.perf_counter()
        scalars = (
            jnp.float64(vc_tol),
            jnp.float64(ex_tol),
            jnp.int32(nmax),
            jnp.int32(nmax_exact),
        )
        hist = None
        if history:
            rhs_arr = (
                jnp.zeros(self.h.fine_shape, dtype=self.outer_dtype)
                if zero_rhs
                else jnp.asarray(rhs, dtype=self.outer_dtype)
            )
            if rhs_arr.shape != self.h.fine_shape:
                raise ValueError(
                    f"rhs shape {rhs_arr.shape} != fine grid {self.h.fine_shape}"
                )
            u, du, it, ierr, hist, flag = self._solve_hist_jit(
                u0, rhs_arr, *scalars, int(nmax)
            )
            du, it, ierr, hist, flag = jax.device_get((du, it, ierr, hist, flag))
        elif zero_rhs:
            fn = (
                self._solve_zero_rhs_jit_donate
                if donate
                else self._solve_zero_rhs_jit
            )
            u, du, it, ierr, flag = fn(u0, *scalars, self._inner_max)
            du, it, ierr, flag = jax.device_get((du, it, ierr, flag))  # one host sync
        else:
            rhs = jnp.asarray(rhs, dtype=self.outer_dtype)
            if self.shard_spec is not None:
                rhs = self.shard_spec.put(rhs)
            if rhs.shape != self.h.fine_shape:
                raise ValueError(
                    f"rhs shape {rhs.shape} != fine grid {self.h.fine_shape}"
                )
            fn = self._solve_jit_donate if donate else self._solve_jit
            u, du, it, ierr, flag = fn(u0, rhs, *scalars, self._inner_max)
            du, it, ierr, flag = jax.device_get((du, it, ierr, flag))  # one host sync
        info = SolveInfo(
            ierr=int(ierr),
            du_last=float(du),
            cycles=int(it),
            name=name,
            wall_time=_time.perf_counter() - t0,
            coarse_noconv=bool(flag),
            du_history=(
                None if hist is None else tuple(float(v) for v in hist[: int(it)])
            ),
        )
        self._post_warnings([info])
        return u, info

    @staticmethod
    def _post_warnings(infos) -> None:
        """Print the reference's convergence warnings from the host once
        results are fetched — identical behavior on every platform
        (reference: ndsm_multigrid_core.f90:796-798; ndsm_poisson.f90:
        147-150, which print per-occurrence; here once per solve)."""
        if any(i.coarse_noconv for i in infos):
            warn(_COARSE_NOCONV_WARNING)
        if any(i.ierr != IERR_SUCCESS for i in infos):
            warn(_COVFAIL_WARNING)

    def solve_checkpointed(
        self,
        u0,
        rhs,
        *,
        checkpoint_path: str,
        checkpoint_every: int = 32,
        vc_tol: Optional[float] = None,
        ex_tol: Optional[float] = None,
        ncycles_max: Optional[int] = None,
        niterex_max: Optional[int] = None,
        name: str = "",
    ) -> Tuple[jax.Array, SolveInfo]:
        """Resumable solve: V-cycles run in chunks of ``checkpoint_every``
        with the current iterate written atomically to ``checkpoint_path``
        (.npz) between chunks; an interrupted solve restarts from the last
        checkpoint.  The iterate sequence is independent of
        ``checkpoint_every`` — mixed mode pins the strict
        one-V-cycle-per-defect iteration (inner_max=1) here so a chunk
        boundary can never split a defect group (for fp64/fp32 the
        sequence is identical to ``solve``; the reference has no
        checkpointing — solves are minutes-scale; for large multi-chip
        problems this closes that gap, SURVEY.md §5)."""
        import os

        o = self.options
        vc_tol = o.vc_tol if vc_tol is None else vc_tol
        ex_tol = o.ex_tol if ex_tol is None else ex_tol
        nmax = o.ncycles_max if ncycles_max is None else ncycles_max
        nmax_exact = o.niterex_max if niterex_max is None else niterex_max

        u = jnp.asarray(u0, dtype=self.outer_dtype)
        cycles_done = 0
        du = float("inf")
        if os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            if tuple(ck["shape"]) == tuple(self.h.fine_shape):
                u = jnp.asarray(ck["u"], dtype=self.outer_dtype)
                cycles_done = int(ck["cycles"])
                du = float(ck["du"])

        ierr = IERR_COVFAIL
        coarse_noconv = False
        while cycles_done < nmax:
            if du < vc_tol:
                ierr = IERR_SUCCESS
                break
            chunk = min(checkpoint_every, nmax - cycles_done)
            # inner_max=1: strict one-V-cycle-per-defect groups, so a
            # chunk boundary can never split an inner loop and the
            # iterate sequence is independent of checkpoint_every.
            u, du_j, it_j, _, flag = self._solve_jit(
                u,
                jnp.asarray(rhs, dtype=self.outer_dtype),
                jnp.float64(vc_tol),
                jnp.float64(ex_tol),
                jnp.int32(chunk),
                jnp.int32(nmax_exact),
                1,
            )
            du = float(du_j)
            cycles_done += int(it_j)
            coarse_noconv = coarse_noconv or bool(flag)
            # np.savez appends ".npz" when missing — name the temp file
            # with the suffix up front so the atomic os.replace is exact.
            tmp = checkpoint_path + ".tmp.npz"
            np.savez(
                tmp,
                u=np.asarray(u),
                cycles=cycles_done,
                du=du,
                shape=np.asarray(self.h.fine_shape),
            )
            os.replace(tmp, checkpoint_path)
        if du < vc_tol:
            ierr = IERR_SUCCESS
        info = SolveInfo(
            ierr=ierr,
            du_last=du,
            cycles=cycles_done,
            name=name,
            coarse_noconv=coarse_noconv,
        )
        self._post_warnings([info])
        return u, info

    # Reduced-cycle drivers, handy for operator-isolation tests
    # (reference: one_grid/two_grid, ndsm_multigrid_core.f90:385-441).

    def vcycle(self, u, rhs, *, ex_tol=None, niterex_max=None):
        o = self.options
        u, _ = self._vcycle_jit(
            jnp.asarray(u, self.inner_dtype),
            jnp.asarray(rhs, self.inner_dtype),
            jnp.float64(o.ex_tol if ex_tol is None else ex_tol),
            jnp.int32(o.niterex_max if niterex_max is None else niterex_max),
        )
        return u

    def two_grid(self, u, rhs, *, ex_tol=None, niterex_max=None):
        o = self.options
        u, _ = self._two_grid_jit(
            jnp.asarray(u, self.inner_dtype),
            jnp.asarray(rhs, self.inner_dtype),
            jnp.float64(o.ex_tol if ex_tol is None else ex_tol),
            jnp.int32(o.niterex_max if niterex_max is None else niterex_max),
        )
        return u

    def one_grid(self, u, rhs, *, ex_tol=None, niterex_max=None):
        o = self.options
        u, _ = self._one_grid_jit(
            jnp.asarray(u, self.inner_dtype),
            jnp.asarray(rhs, self.inner_dtype),
            jnp.float64(o.ex_tol if ex_tol is None else ex_tol),
            jnp.int32(o.niterex_max if niterex_max is None else niterex_max),
        )
        return u


_BVP_CACHE: BoundedCache = BoundedCache(maxsize=32)


def get_poisson_bvp(
    hierarchy: GridHierarchy,
    bcs: Sequence[Sequence[str]],
    options: Options = Options(),
    shard_spec=None,
    operator=None,
) -> PoissonBVP:
    """Memoized PoissonBVP construction: repeated solves with the same
    configuration reuse the compiled program."""
    bcs_t = tuple(tuple(b) for b in bcs)
    opt_key = dataclasses.astuple(
        dataclasses.replace(options, vc_tol=0.0, ex_tol=0.0, ncycles_max=0, niterex_max=0)
    )
    key = (hierarchy, bcs_t, opt_key, shard_spec, operator)
    bvp = _BVP_CACHE.get(key)
    if bvp is None:
        bvp = PoissonBVP(
            hierarchy, bcs_t, options, shard_spec=shard_spec, operator=operator
        )
        _BVP_CACHE.put(key, bvp)
    return bvp


def solve_poisson_bvp(
    u0,
    rhs,
    meshes: Sequence[np.ndarray],
    bcs: Sequence[Sequence[str]],
    *,
    ngrids: Optional[int] = None,
    options: Options = Options(),
    operator=None,
) -> Tuple[jax.Array, SolveInfo]:
    """Functional one-shot Poisson solve.

    Solves ``laplace(u) = rhs`` on the uniform per-axis mesh given by
    ``meshes`` (one coordinate vector per array axis) with homogeneous
    "N"/"D" conditions per face; Dirichlet faces take their (possibly
    nonzero) values from ``u0``.  The multigrid hierarchy depth defaults to
    the reference rule ``floor(log2(min(shape)/2))``.

    ``operator`` injects a non-Poisson operator (an
    :class:`~ndsm_tpu.mg.operator.MGOperator`): the same V-cycle
    machinery, stopping rules, precision modes, and error contract then
    solve ``operator[u] = rhs`` — the reference's MG_RELAX/MG_RESIDUAL
    extension point (ndsm_multigrid_core.f90:106-136).
    """
    hierarchy = GridHierarchy.from_mesh(meshes, ngrids=ngrids)
    bvp = get_poisson_bvp(hierarchy, bcs, options, operator=operator)
    # Tolerances/limits are passed per-call: the cached handle may have
    # been built with different (traced, non-recompiling) values.
    return bvp.solve(
        u0,
        rhs,
        vc_tol=options.vc_tol,
        ex_tol=options.ex_tol,
        ncycles_max=options.ncycles_max,
        niterex_max=options.niterex_max,
    )
