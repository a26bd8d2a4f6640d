"""Color-compact red-black Gauss-Seidel sweep.

The masked formulation (ops/stencils.py) updates half the points per pass
but still streams the FULL u array through device memory twice per sweep
(~6 array-traffic units).  Storing the two colors as separate half-width
arrays cuts a sweep to ~3 units at plain-XLA level — each half-update
reads only the opposite color + its own rhs half and writes its own half.

Layout (color-major split along the last axis):

  R[..., k] = u[..., 2k + p]     where p = (sum of leading indices) % 2
  B[..., k] = u[..., 2k + 1 - p]

i.e. R holds the points of 0-based total-index-parity 0 ("red" when the
first color parity is 0) and B the others.  With this layout every
neighbor read is a pure shift:

  * along any leading axis a: the neighbor of R[..., i_a, ..., k] in B is
    B[..., i_a +- 1, ..., k] — same k (the row parity flips, and B's
    x-offset flips with it);
  * along the split axis: the two neighbors are B[..., k-1], B[..., k]
    on even-parity rows and B[..., k], B[..., k+1] on odd rows, with
    edge CLAMP (the index reflection -1 -> +1 / n -> n-2 lands on the
    clamped entry of the opposite color).

Odd last-axis extents are padded with one ghost column in the B half
(sizes ceil(nx/2) each); the ghost is masked out of updates, metrics and
neighbor reads (the top-edge clamp handles it naturally).

Dirichlet faces are masked out via half-coordinate index tests; the
all-Neumann global mean is computed over both halves (ghost excluded).

Results are identical (to rounding) to ops/stencils.rb_sweep; the update
order respects the first-color-parity rule (x-lower Dirichlet in 3D flips
the starting color — ndsm_optimized.f90:106).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import stencils
from .stencils import BCS

__all__ = [
    "split_colors",
    "split_colors_p",
    "merge_colors",
    "merge_colors_p",
    "rb_sweep_compact",
    "compact_supported",
]


def compact_supported(shape, bcs: BCS) -> bool:
    return len(shape) >= 2 and shape[-1] >= 4


def _row_parity(shape_lead: Tuple[int, ...]) -> jax.Array:
    """(…lead, 1) array of (sum of leading indices) % 2."""
    s = None
    full = shape_lead + (1,)
    for ax in range(len(shape_lead)):
        it = lax.broadcasted_iota(jnp.int32, full, ax)
        s = it if s is None else s + it
    return s % 2


def _nxh(nx: int) -> int:
    return (nx + 1) // 2


def _ghost_fix(v: jax.Array, own_par: jax.Array, nx: int) -> jax.Array:
    """For odd nx: entries whose global x = 2k + par >= nx are ghosts;
    set each to a copy of the row's last REAL value (x = nx-2), so the
    clamp-based neighbor reads realize the index reflection exactly."""
    if nx % 2 == 0:
        return v
    last = v[..., -1:]
    mirror = v[..., -2:-1]
    gx_last = 2 * (v.shape[-1] - 1) + own_par
    fixed = jnp.where(gx_last >= nx, mirror, last)
    return jnp.concatenate([v[..., :-1], fixed], axis=-1)


def split_colors_p(u: jax.Array, rowpar: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Split with an explicitly supplied (…lead, 1) row-parity array —
    needed when the leading indices are a block of a larger (sharded)
    array and the parity must be computed from GLOBAL indices."""
    nx = u.shape[-1]
    even = u[..., 0::2]
    odd = u[..., 1::2]
    if nx % 2:
        pad = [(0, 0)] * (u.ndim - 1) + [(0, 1)]
        odd = jnp.pad(odd, pad)
    R = jnp.where(rowpar == 0, even, odd)
    B = jnp.where(rowpar == 0, odd, even)
    R = _ghost_fix(R, rowpar, nx)
    B = _ghost_fix(B, 1 - rowpar, nx)
    return R, B


def split_colors(u: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """u -> (R, B) halves of shape (..., ceil(nx/2)); for odd nx each
    half's per-row ghost entries mirror the row's last real value."""
    return split_colors_p(u, _row_parity(u.shape[:-1]))


def merge_colors_p(R: jax.Array, B: jax.Array, nx: int, rowpar: jax.Array) -> jax.Array:
    even = jnp.where(rowpar == 0, R, B)
    odd = jnp.where(rowpar == 0, B, R)
    u = jnp.stack([even, odd], axis=-1).reshape(R.shape[:-1] + (2 * R.shape[-1],))
    return u[..., :nx]


def merge_colors(R: jax.Array, B: jax.Array, nx: int) -> jax.Array:
    """(R, B) -> u with last-axis extent nx."""
    return merge_colors_p(R, B, nx, _row_parity(R.shape[:-1]))


def _shift_clamp(v: jax.Array, axis: int, delta: int) -> jax.Array:
    """Shift by +-1 along ``axis`` with edge clamp (the value at the edge
    repeats), matching the Neumann reflection as seen from the opposite
    color's indexing."""
    n = v.shape[axis]
    if delta == -1:  # v[k-1], v[-1] -> v[0]
        body = lax.slice_in_dim(v, 0, n - 1, axis=axis)
        edge = lax.slice_in_dim(v, 0, 1, axis=axis)
        return jnp.concatenate([edge, body], axis=axis)
    else:  # v[k+1], v[n] -> v[n-1]
        body = lax.slice_in_dim(v, 1, n, axis=axis)
        edge = lax.slice_in_dim(v, n - 1, n, axis=axis)
        return jnp.concatenate([body, edge], axis=axis)


def _lead_neighbor(v: jax.Array, axis: int) -> Tuple[jax.Array, jax.Array]:
    """(lower, upper) neighbors along a LEADING axis with index
    reflection (-1 -> 1, n -> n-2), same as stencils._neighbors."""
    return stencils._neighbors(v, axis)


def _half_masks(shape_half, nx: int, bcs: BCS, own_par: jax.Array):
    """Update mask for a color half: excludes Dirichlet-face points and
    the ghost column.  ``own_par`` is the (…lead, 1) parity p such that
    the half's global x is 2k + p."""
    ndim = len(shape_half)
    kk = lax.broadcasted_iota(jnp.int32, shape_half, ndim - 1)
    gx = 2 * kk + own_par  # global x index, broadcast over rows
    mask = gx < nx  # ghost exclusion (odd nx)
    for ax in range(ndim - 1):
        idx = lax.broadcasted_iota(jnp.int32, shape_half, ax)
        if bcs[ax][0] == "D":
            mask = mask & (idx > 0)
        if bcs[ax][1] == "D":
            mask = mask & (idx < shape_half[ax] - 1)
    if bcs[-1][0] == "D":
        mask = mask & (gx > 0)
    if bcs[-1][1] == "D":
        mask = mask & (gx < nx - 1)
    return mask, gx


def _update_half(own, opp, rhs_own, w, w0, mask, own_par, nx):
    """Gauss-Seidel update of one color half, reading the other."""
    ndim = own.ndim
    total = None
    for ax in range(ndim - 1):
        lo, hi = _lead_neighbor(opp, ax)
        term = (lo + hi) * w[ax]
        total = term if total is None else total + term
    # Split-axis neighbors: on even-parity rows (own x = 2k) the x
    # neighbors are opp[k-1], opp[k]; on odd rows (own x = 2k+1) they are
    # opp[k], opp[k+1].  Edge clamp = Neumann reflection.
    km1 = _shift_clamp(opp, ndim - 1, -1)
    kp1 = _shift_clamp(opp, ndim - 1, +1)
    nbx = jnp.where(own_par == 0, km1 + opp, opp + kp1)
    # Odd-nx top edge: for own x = nx-1 with even parity rows... handled:
    # reflection nx -> nx-2 is same-half? No: nx-2 has parity of nx, which
    # is the OPPOSITE parity of nx-1 — the clamp on opp covers it.
    total = total + nbx * w[ndim - 1]
    unew = (total - rhs_own) * w0
    return jnp.where(mask, unew, own)


@partial(jax.jit, static_argnames=("bcs", "nx"))
def rb_sweep_compact(
    R: jax.Array,
    B: jax.Array,
    rhs_R: jax.Array,
    rhs_B: jax.Array,
    dq: jax.Array,
    bcs: BCS,
    nx: int,
) -> Tuple[jax.Array, jax.Array]:
    """One red-black sweep on color-split state.  R holds total-parity-0
    points; the first updated color follows stencils.first_color_parity."""
    w, w0 = stencils.stencil_weights(dq, R.dtype)
    rowpar = _row_parity(R.shape[:-1])
    par_R = rowpar  # R's global x = 2k + rowpar
    par_B = 1 - rowpar
    mask_R, _ = _half_masks(R.shape, nx, bcs, par_R)
    mask_B, _ = _half_masks(B.shape, nx, bcs, par_B)

    first = stencils.first_color_parity(bcs)
    if first == 0:
        R = _update_half(R, B, rhs_R, w, w0, mask_R, par_R, nx)
        R = _ghost_fix(R, par_R, nx)
        B = _update_half(B, R, rhs_B, w, w0, mask_B, par_B, nx)
        B = _ghost_fix(B, par_B, nx)
    else:
        B = _update_half(B, R, rhs_B, w, w0, mask_B, par_B, nx)
        B = _ghost_fix(B, par_B, nx)
        R = _update_half(R, B, rhs_R, w, w0, mask_R, par_R, nx)
        R = _ghost_fix(R, par_R, nx)

    if stencils.is_all_neumann(bcs):
        n_total = float(np.prod(R.shape[:-1])) * nx

        def real_sum(v, par):
            if nx % 2 == 0:
                return jnp.sum(v)
            kk = lax.broadcasted_iota(jnp.int32, v.shape, v.ndim - 1)
            return jnp.sum(jnp.where(2 * kk + par < nx, v, 0))

        mean = (real_sum(R, par_R) + real_sum(B, par_B)) / jnp.asarray(
            n_total, R.dtype
        )
        R = R - mean
        B = B - mean  # ghosts shift too — they mirror shifted values
    return R, B
