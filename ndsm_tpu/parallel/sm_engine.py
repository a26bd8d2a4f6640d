"""Fully explicit shard_map multigrid solver.

The GSPMD path (ShardSpec + sharding constraints) lets XLA choose the
communication for every op.  This engine instead expresses the ENTIRE
Poisson solve — outer V-cycle loop, smoothing, residual, transfers,
coarse solve, metrics — as one ``shard_map`` program over a 1-D or N-D
device mesh with hand-placed collectives:

  * the leading array axes are block-partitioned over the mesh axes
    (``axis_names``); a level is sharded while every partitioned extent
    divides its mesh axis and exceeds a row threshold.  Smoothing and
    residual exchange one boundary plane per partitioned axis per
    half-sweep with ``lax.ppermute`` (neighbor devices), with
    global-boundary reflection handled by global-index selects on the
    boundary planes only;
  * sharded->sharded restriction/prolongation contract each partitioned
    axis with PER-SHARD matrix blocks (precomputed from the
    coordinate-based operators' actual support, including the
    non-power-of-two drift of the reference's floor(n/2) level sizes)
    over an H-plane halo exchange; the remaining axes use the full
    per-axis matrices locally;
  * at the replication seam (first level too small to shard) the fine
    residual is all-gathered once and everything below runs replicated —
    the latency-bound coarse solve never touches the network
    (BASELINE.json north star);
  * convergence metrics and the all-Neumann mean are psum/pmax
    collectives over all partitioned mesh axes;
  * smoothing on sharded levels runs in color-compact form by default
    (half the memory traffic and halo volume; Options.smoother="masked"
    selects the dense masked formulation).

Results match the single-device engine to rounding with identical cycle
counts (tests/test_dist.py), in fp64 and in mixed precision (sharded f32
V-cycles inside the f64 defect-correction loop).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..grids import GridHierarchy
from ..options import IERR_COVFAIL, IERR_SUCCESS, Options, SolveInfo
from ..ops import stencils
from ..ops import stencils_compact as sc
from ..ops.transfer import (
    apply_axis_matrices,
    interp_matrix_1d,
    restrict_matrix_1d,
)
from ..mg.coarse import build_coarse_solver_matrix

__all__ = ["ShardedPoissonBVP", "make_sharded_sweep", "make_sharded_residual"]


def _axis_blocks(M: np.ndarray, ndev: int) -> Tuple[np.ndarray, int]:
    """Split an (n_out, n_in) transfer matrix into per-shard blocks.

    Returns (blocks, H): blocks has shape (ndev, n_out/ndev, bi + 2H)
    where bi = n_in/ndev and H is the halo depth covering every shard's
    actual column support; blocks[i] acts on the shard's local input
    extended by H planes per side (zero-padded beyond the global ends).
    """
    n_out, n_in = M.shape
    bo, bi = n_out // ndev, n_in // ndev
    H = 0
    for i in range(ndev):
        rows = M[i * bo : (i + 1) * bo]
        cols = np.flatnonzero(np.any(rows != 0.0, axis=0))
        if cols.size:
            H = max(H, i * bi - int(cols[0]), int(cols[-1]) + 1 - (i + 1) * bi)
    W = bi + 2 * H
    blocks = np.zeros((ndev, bo, W), dtype=np.float64)
    for i in range(ndev):
        lo = i * bi - H
        for w in range(W):
            c = lo + w
            if 0 <= c < n_in:
                blocks[i, :, w] = M[i * bo : (i + 1) * bo, c]
    return blocks, H


def _plane(v: jax.Array, ax: int, lo: int, hi: int) -> jax.Array:
    n = v.shape[ax]
    lo = lo if lo >= 0 else n + lo
    hi = hi if hi > 0 else n + hi
    return lax.slice_in_dim(v, lo, hi, axis=ax)


class ShardStencilKernels:
    """Per-shard stencil + halo-exchange primitives, shared by the full
    multigrid engine (ShardedPoissonBVP) and the standalone single-level
    builders (make_sharded_sweep / make_sharded_residual) so there is
    exactly ONE halo implementation in the tree.

    Subclasses provide the geometry: attributes ``names`` (mesh axis name
    per partitioned array axis), ``ndev`` (devices per mesh axis),
    ``parts`` ([(array_axis, mesh_name)]), ``bcs``; and methods
    ``_gshape(level)`` (global shape) and ``_dq_of(level)`` (spacings).
    Arrays passed in are local shard blocks; all boundary logic runs in
    GLOBAL index coordinates.
    """

    names: Tuple[str, ...]
    ndev: Dict[str, int]
    parts: List[Tuple[int, str]]
    bcs: stencils.BCS

    def _gshape(self, level: int) -> Tuple[int, ...]:
        raise NotImplementedError

    def _dq_of(self, level: int):
        raise NotImplementedError

    # -- type-system helpers -------------------------------------------

    def _vary(self, x):
        """Mark a locally-created array as varying over the mesh axes
        (shard_map's varying-manual-axes type system)."""
        try:
            return lax.pcast(x, self.names, to="varying")
        except (AttributeError, TypeError):
            return x

    def _pall_any(self, b):
        """Cross-shard OR of a bool scalar, yielding a mesh-invariant value
        suitable for a replicated (P()) shard_map output (psum of 0/1
        ints > 0 is exactly OR)."""
        try:
            return lax.psum(b.astype(jnp.int32), self.names) > 0
        except Exception:  # already invariant (or no vma typing): keep as-is
            return b

    # -- geometry helpers ----------------------------------------------

    def _is_part(self, ax: int) -> bool:
        return ax < len(self.names)

    def _g(self, shape, level, ax):
        """Global index array along partitioned axis ``ax`` for a local
        block at a sharded level."""
        nm = self.names[ax]
        blk = self._gshape(level)[ax] // self.ndev[nm]
        i = lax.axis_index(nm)
        return (i * blk + lax.broadcasted_iota(jnp.int32, shape, ax)).astype(
            jnp.int32
        )

    def _exchange_planes(self, v, ax: int, depth: int = 1):
        """(from_prev, from_next) neighbor planes of depth ``depth`` along
        partitioned axis ``ax`` (zeros beyond the chain ends)."""
        nm = self.names[ax]
        nd = self.ndev[nm]
        from_prev = lax.ppermute(
            _plane(v, ax, -depth, v.shape[ax]),
            nm,
            [(j, j + 1) for j in range(nd - 1)],
        )
        from_next = lax.ppermute(
            _plane(v, ax, 0, depth), nm, [(j + 1, j) for j in range(nd - 1)]
        )
        return from_prev, from_next

    def _lead_pair(self, v, ax: int, level: int):
        """(lower, upper) neighbor arrays along leading axis ``ax`` with
        Neumann index reflection at the GLOBAL ends; partitioned axes pull
        the boundary planes from neighbor shards."""
        if not self._is_part(ax):
            return stencils._neighbors(v, ax)
        n_glob = self._gshape(level)[ax]
        from_prev, from_next = self._exchange_planes(v, ax)
        g_first = self._g(_plane(v, ax, 0, 1).shape, level, ax)
        g_last = self._g(v.shape, level, ax)
        g_last = _plane(g_last, ax, -1, g_last.shape[ax])
        first = jnp.where(g_first == 0, _plane(v, ax, 1, 2), from_prev)
        last = jnp.where(g_last == n_glob - 1, _plane(v, ax, -2, -1), from_next)
        lo = jnp.concatenate([first, _plane(v, ax, 0, -1)], axis=ax)
        hi = jnp.concatenate([_plane(v, ax, 1, v.shape[ax]), last], axis=ax)
        return lo, hi

    def _sharded_masks(self, shape, level):
        """Non-Dirichlet mask with global index tests on partitioned axes."""
        mask = None

        def add(m):
            nonlocal mask
            mask = m if mask is None else mask & m

        for ax in range(len(shape)):
            n_glob = self._gshape(level)[ax]
            if self._is_part(ax):
                g = self._g(shape, level, ax)
                if self.bcs[ax][0] == "D":
                    add(g > 0)
                if self.bcs[ax][1] == "D":
                    add(g < n_glob - 1)
            else:
                idx = lax.broadcasted_iota(jnp.int32, shape, ax)
                if self.bcs[ax][0] == "D":
                    add(idx > 0)
                if self.bcs[ax][1] == "D":
                    add(idx < shape[ax] - 1)
        return mask

    def _global_parity_sum(self, shape, level, upto_axis: int):
        """Sum of global indices over leading axes [0, upto_axis)."""
        s = None
        for ax in range(upto_axis):
            it = (
                self._g(shape, level, ax)
                if self._is_part(ax)
                else lax.broadcasted_iota(jnp.int32, shape, ax)
            )
            s = it if s is None else s + it
        return s

    # -- masked sweep / residual ---------------------------------------

    def _sharded_half(self, u, rhs, level, parity, w, w0, interior):
        total = None
        for ax in range(u.ndim):
            lo, hi = self._lead_pair(u, ax, level)
            term = (lo + hi) * w[ax]
            total = term if total is None else total + term
        unew = (total - rhs) * w0
        psum_axes = self._global_parity_sum(u.shape, level, u.ndim)
        mask = lax.rem(psum_axes, jnp.int32(2)) == parity
        if interior is not None:
            mask = mask & interior
        return jnp.where(mask, unew, u)

    def _sharded_sweep(self, u, rhs, level):
        w, w0 = stencils.stencil_weights(self._dq_of(level), u.dtype)
        interior = self._sharded_masks(u.shape, level)
        red = stencils.first_color_parity(self.bcs)
        u = self._sharded_half(u, rhs, level, red, w, w0, interior)
        u = self._sharded_half(u, rhs, level, 1 - red, w, w0, interior)
        if stencils.is_all_neumann(self.bcs):
            total = float(np.prod(self._gshape(level)))
            mean = lax.psum(jnp.sum(u), self.names) / jnp.asarray(
                total, u.dtype
            )
            u = u - mean
        return u

    def _sharded_residual(self, u, rhs, level):
        w, _ = stencils.stencil_weights(self._dq_of(level), u.dtype)
        interior = self._sharded_masks(u.shape, level)
        lap = None
        for ax in range(u.ndim):
            lo, hi = self._lead_pair(u, ax, level)
            term = (lo - 2.0 * u + hi) * w[ax]
            lap = term if lap is None else lap + term
        r = rhs - lap
        if interior is not None:
            r = jnp.where(interior, r, jnp.zeros((), u.dtype))
        return r

    # -- color-compact sharded smoothing -------------------------------

    def _rowpar(self, shape_half_lead, level):
        """Global row parity (sum of GLOBAL leading indices) shaped
        (…lead, 1)."""
        full = tuple(shape_half_lead) + (1,)
        s = self._global_parity_sum(full, level, len(shape_half_lead))
        return lax.rem(s, jnp.int32(2))

    def _compact_half_sharded(self, own, opp, rhs_own, own_par, level, w, w0):
        """One color's update on sharded compact state: leading-axis
        neighbors (same half-index k, opposite color) come from neighbor
        shards; the split axis uses clamp-shifts with row-parity select."""
        nx = self._gshape(level)[-1]
        total = None
        for ax in range(own.ndim - 1):
            lo, hi = self._lead_pair(opp, ax, level)
            term = (lo + hi) * w[ax]
            total = term if total is None else total + term
        km1 = sc._shift_clamp(opp, own.ndim - 1, -1)
        kp1 = sc._shift_clamp(opp, own.ndim - 1, +1)
        nbx = jnp.where(own_par == 0, km1 + opp, opp + kp1)
        total = total + nbx * w[own.ndim - 1]
        unew = (total - rhs_own) * w0
        # update mask: ghost + Dirichlet faces
        kk = lax.broadcasted_iota(jnp.int32, own.shape, own.ndim - 1)
        gx = 2 * kk + own_par
        mask = gx < nx
        for ax in range(own.ndim - 1):
            n_glob = self._gshape(level)[ax]
            if self._is_part(ax):
                g = self._g(own.shape, level, ax)
                if self.bcs[ax][0] == "D":
                    mask = mask & (g > 0)
                if self.bcs[ax][1] == "D":
                    mask = mask & (g < n_glob - 1)
            else:
                idx = lax.broadcasted_iota(jnp.int32, own.shape, ax)
                if self.bcs[ax][0] == "D":
                    mask = mask & (idx > 0)
                if self.bcs[ax][1] == "D":
                    mask = mask & (idx < own.shape[ax] - 1)
        if self.bcs[-1][0] == "D":
            mask = mask & (gx > 0)
        if self.bcs[-1][1] == "D":
            mask = mask & (gx < nx - 1)
        own = jnp.where(mask, unew, own)
        return sc._ghost_fix(own, own_par, nx)

    def _sharded_smooth_compact(self, u, rhs, level, n):
        nx = self._gshape(level)[-1]
        w, w0 = stencils.stencil_weights(self._dq_of(level), u.dtype)
        rowpar = self._rowpar(u.shape[:-1], level)
        R, B = sc.split_colors_p(u, rowpar)
        rhs_R, rhs_B = sc.split_colors_p(rhs, rowpar)
        par_R, par_B = rowpar, 1 - rowpar
        red = stencils.first_color_parity(self.bcs)
        all_n = stencils.is_all_neumann(self.bcs)
        total_pts = float(np.prod(self._gshape(level)))

        def body(_, carry):
            R, B = carry
            if red == 0:
                R = self._compact_half_sharded(R, B, rhs_R, par_R, level, w, w0)
                B = self._compact_half_sharded(B, R, rhs_B, par_B, level, w, w0)
            else:
                B = self._compact_half_sharded(B, R, rhs_B, par_B, level, w, w0)
                R = self._compact_half_sharded(R, B, rhs_R, par_R, level, w, w0)
            if all_n:
                if nx % 2 == 0:
                    s = jnp.sum(R) + jnp.sum(B)
                else:
                    kk = lax.broadcasted_iota(jnp.int32, R.shape, R.ndim - 1)
                    s = jnp.sum(jnp.where(2 * kk + par_R < nx, R, 0)) + jnp.sum(
                        jnp.where(2 * kk + par_B < nx, B, 0)
                    )
                mean = lax.psum(s, self.names) / jnp.asarray(
                    total_pts, R.dtype
                )
                R, B = R - mean, B - mean
            return (R, B)

        R, B = lax.fori_loop(0, n, body, (R, B))
        return sc.merge_colors_p(R, B, nx, rowpar)


class ShardedPoissonBVP(ShardStencilKernels):
    """Poisson solve with the whole multigrid algorithm inside one
    ``shard_map`` (see module docstring).

    Parameters:
      hierarchy, bcs, options: as for PoissonBVP.
      mesh: device mesh containing every name in ``axis_names``.
      axis_names: mesh axis name per partitioned array axis, in array-axis
        order starting at axis 0 (e.g. ("z",) or ("z", "y")).  The last
        array axis must stay unpartitioned (it is the color-split axis).
      min_rows_per_shard: replicate levels with fewer local rows.
    """

    def __init__(
        self,
        hierarchy: GridHierarchy,
        bcs: Sequence[Sequence[str]],
        options: Options = Options(),
        *,
        mesh: Mesh,
        axis_names: Sequence[str] = ("z",),
        axis_name: Optional[str] = None,  # backwards-compat alias
        min_rows_per_shard: int = 4,
    ):
        if axis_name is not None:
            axis_names = (axis_name,)
        self.h = hierarchy
        self.bcs = stencils.validate_bcs(bcs, hierarchy.ndim)
        self.options = options
        self.mesh = mesh
        self.names: Tuple[str, ...] = tuple(axis_names)
        if len(self.names) >= hierarchy.ndim:
            raise ValueError("the last array axis cannot be partitioned")
        self.parts: List[Tuple[int, str]] = list(enumerate(self.names))
        self.ndev: Dict[str, int] = {n: mesh.shape[n] for n in self.names}
        self.min_rows_per_shard = int(min_rows_per_shard)
        self.mode = options.resolve_precision()
        self.compact_smoother = getattr(options, "smoother", "auto") != "masked"
        self.dtype = jnp.float32 if self.mode == "fp32" else jnp.float64
        self.ndev0 = self.ndev[self.names[0]]
        # Legacy single-axis attributes used by tests/introspection
        self.axis_name = self.names[0]

        # Level plan: prefix of shardable levels, then replicated.  The
        # coarsest level is always replicated.
        self.seam = 0
        for l, shape in enumerate(hierarchy.shapes[: hierarchy.ngrids - 1]):
            ok = all(
                shape[ax] % self.ndev[nm] == 0
                and shape[ax] >= self.ndev[nm] * min_rows_per_shard
                for ax, nm in self.parts
            )
            if ok:
                self.seam = l + 1
            else:
                break
        if self.seam == 0:
            raise ValueError(
                f"finest level {hierarchy.shapes[0]} cannot be partitioned "
                f"over mesh axes {dict(self.ndev)} (each partitioned extent "
                f"must divide its mesh axis with >= {min_rows_per_shard} "
                "rows/shard)"
            )

        # Transfer operators: per-shard blocks for partitioned axes on
        # sharded->sharded pairs; full per-axis matrices otherwise.
        self._blocks_R: List[Optional[Dict[int, Tuple[np.ndarray, int]]]] = []
        self._blocks_P: List[Optional[Dict[int, Tuple[np.ndarray, int]]]] = []
        self._restrict_full: List[List[np.ndarray]] = []
        self._interp_full: List[List[np.ndarray]] = []
        for l in range(hierarchy.ngrids - 1):
            fine = hierarchy.meshes[l]
            coarse = hierarchy.meshes[l + 1]
            R_axes = [restrict_matrix_1d(c, f) for f, c in zip(fine, coarse)]
            P_axes = [interp_matrix_1d(f, c) for f, c in zip(fine, coarse)]
            self._restrict_full.append(R_axes)
            self._interp_full.append(P_axes)
            if l + 1 < self.seam:
                self._blocks_R.append(
                    {
                        ax: _axis_blocks(R_axes[ax], self.ndev[nm])
                        for ax, nm in self.parts
                    }
                )
                self._blocks_P.append(
                    {
                        ax: _axis_blocks(P_axes[ax], self.ndev[nm])
                        for ax, nm in self.parts
                    }
                )
            else:
                self._blocks_R.append(None)
                self._blocks_P.append(None)

        # Replicated coarse direct solver
        cs = getattr(options, "coarse_solver", "auto")
        self.coarse_direct = cs != "relax" and int(
            np.prod(hierarchy.shapes[-1])
        ) <= 4096
        if self.coarse_direct:
            S, int_mask = build_coarse_solver_matrix(
                hierarchy.shapes[-1], hierarchy.dq[-1], self.bcs
            )
            self._coarse_S = S
            self._coarse_rows = np.flatnonzero(int_mask)

        self._dq = [np.asarray(d, dtype=np.float64) for d in hierarchy.dq]
        partsvec: List[Optional[str]] = [None] * hierarchy.ndim
        for ax, nm in self.parts:
            partsvec[ax] = nm
        self._partsvec = tuple(partsvec)
        spec = P(*partsvec)
        self.sharding = NamedSharding(mesh, spec)
        # Lane-batched variant: lane axis in front, replicated; built
        # lazily by solve_batch.
        self.sharding_batch = NamedSharding(mesh, P(None, *partsvec))
        self._solve_batch_jit = None
        self._solve_batch_jit_donate = None
        solve_sm = shard_map(
            self._local_solve,
            mesh=mesh,
            in_specs=(spec, spec, P(), P(), P(), P()),
            out_specs=(spec, P(), P(), P(), P()),
        )
        self._solve_jit = jax.jit(solve_sm)
        self._solve_jit_donate = jax.jit(solve_sm, donate_argnums=(0, 1))
        # Zero-rhs variant: the right-hand side is materialized per shard
        # inside the program, so the common rhs == 0 solves (the three 3D
        # component solves) never allocate/upload a full-grid buffer —
        # ~1 GB of dead traffic per component at 512^3 f64.
        zero_sm = shard_map(
            self._local_solve_zero_rhs,
            mesh=mesh,
            in_specs=(spec, P(), P(), P(), P()),
            out_specs=(spec, P(), P(), P(), P()),
        )
        self._solve_zero_jit = jax.jit(zero_sm)
        self._solve_zero_jit_donate = jax.jit(zero_sm, donate_argnums=(0,))

    # ------------------------------------------------------------------
    # Geometry hooks for the shared ShardStencilKernels primitives.
    # Arrays are local blocks on sharded levels, full on replicated ones.
    # ------------------------------------------------------------------

    def _gshape(self, level: int) -> Tuple[int, ...]:
        return self.h.shapes[level]

    def _dq_of(self, level: int):
        return self._dq[level]

    def _smooth_residual_sh(self, u, rhs, level, n):
        """n pre-smooth sweeps + the residual of the swept state.
        Returns (u, r)."""
        ul = self._smooth(u, rhs, level, n)
        r = (
            self._sharded_residual(ul, rhs, level)
            if level < self.seam
            else stencils.poisson_residual(ul, rhs, self._dq[level], self.bcs)
        )
        return ul, r

    def _smooth(self, u, rhs, level, n):
        if level < self.seam:
            if self.compact_smoother and u.shape[-1] >= 4:
                return self._sharded_smooth_compact(u, rhs, level, n)
            body = lambda _, v: self._sharded_sweep(v, rhs, level)  # noqa: E731
        else:
            body = lambda _, v: stencils.rb_sweep(  # noqa: E731
                v, rhs, self._dq[level], self.bcs
            )
        return lax.fori_loop(0, n, body, u)

    # -- transfers ------------------------------------------------------

    def _exchange_halo(self, v, ax: int, H: int):
        if H == 0:
            return v
        from_prev, from_next = self._exchange_planes(v, ax, depth=H)
        return jnp.concatenate([from_prev, v, from_next], axis=ax)

    def _apply_blocks(self, x, blocks: Dict[int, Tuple[np.ndarray, int]]):
        """Contract every partitioned axis with its per-shard block (over
        an H-plane halo), then every remaining axis with its full matrix."""
        for ax, nm in self.parts:
            Mb, H = blocks[ax]
            blk = jnp.asarray(Mb, dtype=x.dtype)[lax.axis_index(nm)]
            ext = self._exchange_halo(x, ax, H)
            ext = jnp.moveaxis(ext, ax, 0)
            out = jnp.tensordot(
                blk, ext, axes=([1], [0]), precision=lax.Precision.HIGHEST
            )
            x = jnp.moveaxis(out, 0, ax)
        return x

    def _apply_full_rest(self, x, mats: Sequence[np.ndarray]):
        """Apply full per-axis matrices to the non-partitioned axes."""
        for ax in range(len(self.names), x.ndim):
            mj = jnp.asarray(mats[ax], dtype=x.dtype)
            x = jnp.moveaxis(x, ax, 0)
            x = jnp.tensordot(
                mj, x, axes=([1], [0]), precision=lax.Precision.HIGHEST
            )
            x = jnp.moveaxis(x, 0, ax)
        return x

    def _gather_all(self, v):
        for ax, nm in self.parts:
            v = lax.all_gather(v, nm, axis=ax, tiled=True)
        return v

    def _restrict(self, r, level):
        """Level -> level+1.  Sharded->sharded uses per-shard blocks; the
        seam all-gathers the fine residual first."""
        if level + 1 < self.seam:
            r = self._apply_blocks(r, self._blocks_R[level])
            return self._apply_full_rest(r, self._restrict_full[level])
        if level < self.seam:  # sharded fine -> replicated coarse
            r = self._gather_all(r)
        return apply_axis_matrices(r, self._restrict_full[level])

    def _prolong(self, u_c, level):
        """Level+1 -> level."""
        if level + 1 < self.seam:
            u = self._apply_blocks(u_c, self._blocks_P[level])
            return self._apply_full_rest(u, self._interp_full[level])
        full = apply_axis_matrices(u_c, self._interp_full[level])
        if level < self.seam:  # replicated coarse -> sharded fine
            for ax, nm in self.parts:
                blk = self.h.shapes[level][ax] // self.ndev[nm]
                full = lax.dynamic_slice_in_dim(
                    full, lax.axis_index(nm) * blk, blk, axis=ax
                )
        return full

    # -- metrics / coarse solve ----------------------------------------

    def _metric(self, a, b, level):
        du = jnp.abs(a - b)
        n = float(np.prod(self.h.shapes[level]))
        # metric choice is STATIC (Options.du_max): build only the live
        # branch
        if self.options.du_max:
            m = jnp.max(du)
            return lax.pmax(m, self.names) if level < self.seam else m
        s = jnp.sum(du)
        if level < self.seam:
            s = lax.psum(s, self.names)
        return s / jnp.asarray(n, a.dtype)

    def _coarse_solve(self, rhs, ex_tol, nmax_exact):
        """Returns ``(u, noconv)`` — see MGEngine.t_solve_exact."""
        L = self.h.ngrids - 1
        if self.coarse_direct:
            rows = jnp.asarray(self._coarse_rows)
            S = jnp.asarray(self._coarse_S, dtype=rhs.dtype)
            rhs_int = jnp.take(rhs.ravel(), rows)
            e_int = jnp.matmul(S, rhs_int, precision=lax.Precision.HIGHEST)
            e = jnp.zeros(rhs.size, dtype=rhs.dtype).at[rows].set(e_int)
            return e.reshape(rhs.shape), jnp.asarray(False)

        def cond(c):
            _, _, du, it = c
            return jnp.logical_and(du > ex_tol, it < nmax_exact)

        def body(c):
            u, usav, _, it = c
            u = stencils.rb_sweep(u, rhs, self._dq[L], self.bcs)
            du = self._metric(u, usav, L)
            return (u, u, du, it + 1)

        big = jnp.asarray(jnp.finfo(rhs.dtype).max, rhs.dtype)
        u0 = jnp.zeros_like(rhs)
        u, _, du, _ = lax.while_loop(cond, body, (u0, u0, big, jnp.int32(0)))
        return u, du > ex_tol

    # ------------------------------------------------------------------

    def _local_shape(self, level):
        shape = list(self.h.shapes[level])
        if level < self.seam:
            for ax, nm in self.parts:
                shape[ax] //= self.ndev[nm]
        return tuple(shape)

    def _vcycle_du(self, u, rhs, ex_tol, nmax_exact, u_ref):
        """_vcycle + the du metric vs ``u_ref``."""
        u_new, noconv = self._vcycle(u, rhs, ex_tol, nmax_exact)
        return u_new, noconv, self._metric(u_new, u_ref, 0)

    def _vcycle(self, u, rhs, ex_tol, nmax_exact):
        L = self.h.ngrids
        ms = self.options.ms
        dtype = u.dtype
        us = [None] * L
        rhss = [None] * L
        us[0], rhss[0] = u, rhs
        for l in range(L - 1):
            ul, r = self._smooth_residual_sh(us[l], rhss[l], l, ms)
            rhss[l + 1] = self._restrict(r, l)
            us[l] = ul
            us[l + 1] = self._vary(
                jnp.zeros(self._local_shape(l + 1), dtype=dtype)
            )
        us[L - 1], noconv = self._coarse_solve(rhss[L - 1], ex_tol, nmax_exact)
        for l in range(L - 2, -1, -1):
            uc = self._smooth(us[l + 1], rhss[l + 1], l + 1, ms)
            cor = self._prolong(uc, l)
            us[l] = self._smooth(us[l] + cor, rhss[l], l, ms)
        return us[0], noconv

    def _mixed_group(self, u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max):
        """f64 defect correction supported by up to ``inner_max`` f32
        V-cycles (the sharded analogue of PoissonBVP._mixed_group: one
        f64 defect pass is amortized over the f32 cycles it supports;
        per-V-cycle du/cycle-count semantics are unchanged).  Returns
        (u_new, noconv, du_last, ncycles)."""
        r0 = self._sharded_residual(u, rhs, 0)
        s = lax.pmax(jnp.max(jnp.abs(r0)), self.names)
        s_safe = jnp.where(s > 0, s, jnp.ones_like(s))
        r32 = (r0 / s_safe).astype(jnp.float32)
        eps32 = 32.0 * float(np.finfo(np.float32).eps)
        ex_tol_eff = jnp.maximum(ex_tol, eps32)
        e0 = self._vary(jnp.zeros(r32.shape, dtype=jnp.float32))
        big32 = jnp.asarray(jnp.finfo(np.float32).max, dtype=jnp.float32)

        def du_of(du_e):
            d = s_safe * du_e.astype(self.dtype)
            return jnp.where(s > 0, d, jnp.zeros_like(d))

        def cond(c):
            _, du_e, k, _ = c
            first = k == 0
            more = jnp.logical_and(
                du_of(du_e) >= vc_tol,
                jnp.logical_and(it + k < nmax, k < inner_max),
            )
            return jnp.logical_or(first, more)

        def body(c):
            e, du_e, k, nc = c
            e_new, noconv, du_new = self._vcycle_du(
                e, r32, ex_tol_eff, nmax_exact, e
            )
            return (e_new, du_new, k + 1, nc | noconv)

        init = (e0, big32, jnp.int32(0), self._vary(jnp.asarray(False)))
        if inner_max == 1:
            e32, du_e, k, noconv = body(init)
        else:
            e32, du_e, k, noconv = lax.while_loop(cond, body, init)
        e = e32.astype(self.dtype) * s_safe
        e = jnp.where(s > 0, e, jnp.zeros_like(e))
        u_new = u + e
        if stencils.is_all_neumann(self.bcs):
            total = float(np.prod(self.h.shapes[0]))
            mean = lax.psum(jnp.sum(u_new), self.names) / jnp.asarray(
                total, u_new.dtype
            )
            u_new = u_new - mean
        return u_new, noconv, du_of(du_e), k

    def _local_solve_zero_rhs(self, u0, vc_tol, ex_tol, nmax, nmax_exact):
        rhs = self._vary(jnp.zeros(u0.shape, dtype=u0.dtype))
        return self._local_solve(u0, rhs, vc_tol, ex_tol, nmax, nmax_exact)

    def _local_solve(self, u0, rhs, vc_tol, ex_tol, nmax, nmax_exact):
        vc_tol = vc_tol.astype(self.dtype)
        big = jnp.asarray(jnp.finfo(self.dtype).max, self.dtype)
        mixed = self.mode == "mixed"
        inner_max = max(1, int(getattr(self.options, "mixed_inner_max", 6))) if mixed else 1

        def cond(c):
            _, du, it, _ = c
            return jnp.logical_and(it < nmax, du >= vc_tol)

        def body(c):
            u, _, it, flag = c
            if mixed:
                u_new, noconv, du, ncyc = self._mixed_group(
                    u, rhs, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max
                )
            else:
                u_new, noconv, du = self._vcycle_du(
                    u, rhs, ex_tol, nmax_exact, u
                )
                ncyc = jnp.int32(1)
            return (u_new, du, it + ncyc, flag | noconv)

        u, du, it, flag = lax.while_loop(
            cond, body, (u0, big, jnp.int32(0), self._vary(jnp.asarray(False)))
        )
        ierr = jnp.where(du < vc_tol, IERR_SUCCESS, IERR_COVFAIL).astype(
            jnp.int32
        )
        return u, du, it, ierr, self._pall_any(flag)

    def _local_solve_batch(self, u0, rhs, vc_tol, ex_tol, nmax, nmax_exact):
        """Lane-masked batched variant of ``_local_solve`` — the sharded
        analogue of PoissonBVP._solve_batch_impl: B same-configuration
        problems with the lane axis in front of the shard axes, each
        lane's iterate/metric sequence identical to a standalone sharded
        solve (converged lanes freeze).  Mixed groups vmap the f64
        defect path."""
        mixed = self.mode == "mixed"
        inner_max = (
            max(1, int(getattr(self.options, "mixed_inner_max", 6)))
            if mixed
            else 1
        )
        vc_tol = vc_tol.astype(self.dtype)
        B = u0.shape[0]
        big = jnp.asarray(jnp.finfo(self.dtype).max, self.dtype)
        if mixed:
            groupB = jax.vmap(
                lambda u, r, it: self._mixed_group(
                    u, r, ex_tol, nmax_exact, vc_tol, it, nmax, inner_max
                )
            )
        else:
            cycleB = jax.vmap(
                lambda u, r: self._vcycle_du(u, r, ex_tol, nmax_exact, u)
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
                u_new, noconv, du_new, ncyc = groupB(u, rhs, it)
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
            self._vary(jnp.zeros((B,), bool)),
        )
        u, du, it, flag = lax.while_loop(cond, body, init)
        ierr = jnp.where(du < vc_tol, IERR_SUCCESS, IERR_COVFAIL).astype(
            jnp.int32
        )
        return u, du, it, ierr, self._pall_any(flag)

    def solve_batch(
        self,
        u0s,
        rhss,
        *,
        names: Optional[Sequence[str]] = None,
        donate: bool = False,
    ):
        """Solve B same-configuration problems in ONE sharded program
        (lane axis replicated, shard axes partitioned) — amortizes
        dispatch and halo-collective latency over the lanes (the
        distributed chi-face solves of the vector-potential pipeline).
        Falls back to sequential ``solve`` when the coarse solver is the
        reference relax loop (its while_loop cannot be lane-masked)."""
        import time as _time

        names = list(names) if names is not None else [""] * len(u0s)
        if not self.coarse_direct:
            out = [
                self.solve(u0, r, name=nm, donate=donate)
                for u0, r, nm in zip(u0s, rhss, names)
            ]
            return [u for u, _ in out], [i for _, i in out]

        from .multihost import put_global

        o = self.options
        conv = (
            (lambda a: jnp.asarray(a, self.dtype))
            if jax.process_count() == 1
            else (lambda a: np.asarray(a, self.dtype))
        )
        stack = jnp if jax.process_count() == 1 else np
        u0 = put_global(stack.stack([conv(a) for a in u0s]), self.sharding_batch)
        rhs = put_global(stack.stack([conv(a) for a in rhss]), self.sharding_batch)
        if self._solve_batch_jit is None:
            spec_b = P(None, *self._partsvec)
            sm = shard_map(
                self._local_solve_batch,
                mesh=self.mesh,
                in_specs=(spec_b, spec_b, P(), P(), P(), P()),
                out_specs=(spec_b, P(), P(), P(), P()),
            )
            self._solve_batch_jit = jax.jit(sm)
            self._solve_batch_jit_donate = jax.jit(sm, donate_argnums=(0, 1))
        scalars = (
            jnp.asarray(o.vc_tol, jnp.float64),
            jnp.asarray(o.ex_tol, jnp.float64),
            jnp.int32(o.ncycles_max),
            jnp.int32(o.niterex_max),
        )
        fn = self._solve_batch_jit_donate if donate else self._solve_batch_jit
        t0 = _time.perf_counter()
        u, du, it, ierr, flag = fn(u0, rhs, *scalars)
        du, it, ierr, flag = jax.device_get((du, it, ierr, flag))
        wall = _time.perf_counter() - t0
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
        from ..mg.poisson import PoissonBVP

        PoissonBVP._post_warnings(infos)
        return list(u), infos

    def solve(
        self,
        u0,
        rhs,
        *,
        name: str = "",
        zero_rhs: bool = False,
        donate: bool = False,
        output_dtype=None,
    ) -> Tuple[jax.Array, SolveInfo]:
        """Sharded solve.  ``zero_rhs`` materializes rhs per shard inside
        the program (no full-grid buffer/upload); ``donate`` invalidates
        the caller's input buffers; ``output_dtype`` casts the solution
        on device before returning (e.g. float32 results from an f64
        solve — halves the result's memory and download)."""
        from .multihost import put_global

        o = self.options
        # Multi-host: keep inputs host-side (numpy) so only this
        # process's shards are materialized on device.
        conv = (
            (lambda a: jnp.asarray(a, self.dtype))
            if jax.process_count() == 1
            else (lambda a: np.asarray(a, self.dtype))
        )
        u0 = put_global(conv(u0), self.sharding)
        scalars = (
            jnp.asarray(o.vc_tol, jnp.float64),
            jnp.asarray(o.ex_tol, jnp.float64),
            jnp.int32(o.ncycles_max),
            jnp.int32(o.niterex_max),
        )
        if zero_rhs:
            fn = self._solve_zero_jit_donate if donate else self._solve_zero_jit
            u, du, it, ierr, flag = fn(u0, *scalars)
        else:
            rhs = put_global(conv(rhs), self.sharding)
            fn = self._solve_jit_donate if donate else self._solve_jit
            u, du, it, ierr, flag = fn(u0, rhs, *scalars)
        if output_dtype is not None and jnp.dtype(output_dtype) != u.dtype:
            u = u.astype(output_dtype)
        du, it, ierr, flag = jax.device_get((du, it, ierr, flag))
        info = SolveInfo(
            ierr=int(ierr),
            du_last=float(du),
            cycles=int(it),
            name=name,
            coarse_noconv=bool(flag),
        )
        from ..mg.poisson import PoissonBVP

        PoissonBVP._post_warnings([info])
        return u, info

    def _strict_sibling(self) -> "ShardedPoissonBVP":
        """Same configuration with mixed_inner_max=1 (strict
        one-V-cycle-per-defect groups) — the iterate sequence is then
        independent of where a checkpoint chunk boundary falls, exactly
        like PoissonBVP.solve_checkpointed's inner_max=1 pin."""
        import dataclasses

        if self.mode != "mixed" or int(
            getattr(self.options, "mixed_inner_max", 6)
        ) == 1:
            return self
        sb = getattr(self, "_strict_bvp", None)
        if sb is None:
            sb = ShardedPoissonBVP(
                self.h,
                self.bcs,
                dataclasses.replace(self.options, mixed_inner_max=1),
                mesh=self.mesh,
                axis_names=self.names,
                min_rows_per_shard=self.min_rows_per_shard,
            )
            self._strict_bvp = sb
        return sb

    def solve_checkpointed(
        self,
        u0,
        rhs,
        *,
        checkpoint_path: str,
        checkpoint_every: int = 32,
        name: str = "",
    ) -> Tuple[jax.Array, SolveInfo]:
        """Resumable sharded solve (the distributed counterpart of
        ``PoissonBVP.solve_checkpointed`` — the 1024^3 north-star
        configuration runs the explicit engine, so long solves there
        need the same kill-and-resume contract).  V-cycles run in
        chunks of ``checkpoint_every`` with the global iterate written
        atomically to ``checkpoint_path`` (.npz) between chunks; an
        interrupted solve restarts from the last checkpoint with a
        bitwise-identical iterate sequence (mixed mode pins strict
        defect groups, see ``_strict_sibling``).

        Multi-host: the global iterate is allgathered for the write
        (one full-array broadcast per chunk — size the cadence
        accordingly) and process 0 writes; on resume every process
        reads the same path (shared filesystem, as for orbax)."""
        import os as _os

        from .multihost import put_global

        sb = self._strict_sibling()
        o = sb.options
        vc_tol, ex_tol = o.vc_tol, o.ex_tol
        nmax, nmax_exact = o.ncycles_max, o.niterex_max
        multi = jax.process_count() > 1

        u = np.asarray(u0, dtype=sb.dtype)
        cycles_done = 0
        du = float("inf")
        if _os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            if tuple(ck["shape"]) == tuple(sb.h.fine_shape):
                u = np.asarray(ck["u"], dtype=sb.dtype)
                cycles_done = int(ck["cycles"])
                du = float(ck["du"])
        u = put_global(u, sb.sharding)
        rhs_g = put_global(np.asarray(rhs, dtype=sb.dtype), sb.sharding)

        from ..options import IERR_COVFAIL, IERR_SUCCESS

        ierr = IERR_COVFAIL
        coarse_noconv = False
        while cycles_done < nmax:
            if du < vc_tol:
                ierr = IERR_SUCCESS
                break
            chunk = min(int(checkpoint_every), nmax - cycles_done)
            u, du_j, it_j, _, flag = sb._solve_jit(
                u,
                rhs_g,
                jnp.asarray(vc_tol, jnp.float64),
                jnp.asarray(ex_tol, jnp.float64),
                jnp.int32(chunk),
                jnp.int32(nmax_exact),
            )
            du = float(du_j)
            cycles_done += int(it_j)
            coarse_noconv = coarse_noconv or bool(flag)
            if multi:
                from jax.experimental import multihost_utils

                # tiled=True: concatenate shards back into the global
                # shape (required for non-fully-addressable arrays)
                u_host = np.asarray(
                    multihost_utils.process_allgather(u, tiled=True)
                )
            else:
                u_host = np.asarray(u)
            if jax.process_index() == 0:
                tmp = checkpoint_path + ".tmp.npz"
                np.savez(
                    tmp,
                    u=u_host,
                    cycles=cycles_done,
                    du=du,
                    shape=np.asarray(sb.h.fine_shape),
                )
                _os.replace(tmp, checkpoint_path)
        if du < vc_tol:
            ierr = IERR_SUCCESS
        info = SolveInfo(
            ierr=ierr,
            du_last=du,
            cycles=cycles_done,
            name=name,
            coarse_noconv=coarse_noconv,
        )
        from ..mg.poisson import PoissonBVP

        PoissonBVP._post_warnings([info])
        return u, info


# ----------------------------------------------------------------------
# Standalone single-level builders.
#
# The distributed analogue of one reference relax/residual call
# (ndsm_optimized.f90:40,346) as an isolated building block — used by the
# halo-exchange unit tests and as a minimal example of the sharded
# smoother.  They reuse the exact ShardStencilKernels methods that the
# full engine runs, so there is one halo implementation to maintain.
# ----------------------------------------------------------------------


class _SingleLevelOps(ShardStencilKernels):
    """Geometry adapter: one level, axis 0 partitioned over one mesh axis."""

    def __init__(self, global_shape, bcs, dq, mesh, axis_names):
        self.h_shape = tuple(global_shape)
        self.bcs = stencils.validate_bcs(bcs, len(global_shape))
        self.names = tuple(axis_names)
        self.ndev = {nm: mesh.shape[nm] for nm in self.names}
        self.parts = list(enumerate(self.names))
        self.dq = np.asarray(dq, dtype=np.float64)
        for ax, nm in self.parts:
            if self.h_shape[ax] % self.ndev[nm]:
                raise ValueError(
                    f"axis {ax} ({self.h_shape[ax]}) must divide over "
                    f"{self.ndev[nm]} devices"
                )

    def _gshape(self, level: int):
        return self.h_shape

    def _dq_of(self, level: int):
        return self.dq


def _single_level(global_shape, bcs, dq, mesh, axis_name):
    ops = _SingleLevelOps(global_shape, bcs, dq, mesh, (axis_name,))
    spec = P(axis_name, *([None] * (len(global_shape) - 1)))
    return ops, spec


def make_sharded_sweep(
    global_shape,
    bcs,
    dq,
    mesh: Mesh,
    axis_name: str = "z",
    dtype=jnp.float32,
):
    """Jitted red-black sweep over arrays block-partitioned along axis 0
    of ``mesh`` — semantics identical to ops.stencils.rb_sweep.  Returns
    (f, sharding) where f(u, rhs) -> u on globally-shaped arrays."""
    ops, spec = _single_level(global_shape, bcs, dq, mesh, axis_name)
    f = shard_map(
        lambda u, rhs: ops._sharded_sweep(u, rhs, 0),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=spec,
    )
    return jax.jit(f), NamedSharding(mesh, spec)


def make_sharded_residual(
    global_shape,
    bcs,
    dq,
    mesh: Mesh,
    axis_name: str = "z",
):
    """Jitted residual r = rhs - L[u] over axis-0 block-partitioned arrays
    (one halo exchange per evaluation)."""
    ops, spec = _single_level(global_shape, bcs, dq, mesh, axis_name)
    f = shard_map(
        lambda u, rhs: ops._sharded_residual(u, rhs, 0),
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=spec,
    )
    return jax.jit(f), NamedSharding(mesh, spec)
