"""Second-order Poisson stencil kernels: red-black Gauss-Seidel sweep and
residual, for any number of dimensions.

Functional (array-at-a-time) re-design of the reference's in-place OpenMP loops:

  * ``red_black_gauss_3D`` / ``red_black_gauss_2D``
    (reference: fortran/ndsm_optimized.f90:40,199) and the generic N-D
    ``relax`` (fortran/ndsm_poisson.f90:451) become *two masked dense
    half-updates* per sweep.  The red half-sweep reads only black values
    and vice versa (the 7-point stencil couples opposite parities only,
    including through boundary reflection), so the functional update
    reproduces the reference's Gauss-Seidel sequencing exactly.
  * ``poisson_residual_3D`` (fortran/ndsm_optimized.f90:346) and the
    generic ``residual`` (fortran/ndsm_poisson.f90:280) become one fused
    dense stencil evaluation.

Boundary conditions (homogeneous, per face):
  * Neumann ("N"): index reflection — the out-of-range neighbor ``i = -1``
    maps to ``i = 1`` and ``i = n`` maps to ``i = n-2``
    (reference: ndsm_optimized.f90:113-120, ndsm_poisson.f90:633-658).
  * Dirichlet ("D"): boundary points are frozen (update masked out) and
    their residual is zero (reference: ndsm_optimized.f90:75-76,439-445;
    ndsm_poisson.f90:325-328,591-594).

For an all-Neumann problem the global mean is subtracted after every sweep
to pin the additive-constant null space (reference: ndsm_optimized.f90:
173-189; ndsm_poisson.f90:534-547; quirk Q7 in SURVEY.md).

Coloring: points are colored by the parity of the sum of their (0-based)
indices.  The first-updated color matches the reference exactly in the
library paths: the optimized 3D kernel starts at parity
``(i+j+k) ≡ lb(1) (mod 2)`` in 1-based Fortran indices
(ndsm_optimized.f90:106), i.e. 0-based sum-parity 0 when the x-lower face
(the *last* axis here, Fortran dimension 1) is Neumann and parity 1 when it
is Dirichlet; the generic N-D path's "all indices even or all odd" rule
(ndsm_poisson.f90:501) equals 0-based sum-parity 0 in 2D.  For ndim >= 4
the reference's generic coloring is not a true checkerboard and its black
half-sweep is racy (quirk Q8); we deliberately use true sum-parity coloring
everywhere, which is deterministic and equivalent where the reference is
well-defined.

All functions are dtype-polymorphic (float32/float64) and shape-static.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

BCS = Tuple[Tuple[str, str], ...]  # per-axis (lower, upper), each "N" or "D"

__all__ = [
    "first_color_parity",
    "stencil_weights",
    "rb_sweep",
    "poisson_residual",
    "subtract_mean",
]


def validate_bcs(bcs: Sequence[Sequence[str]], ndim: int) -> BCS:
    bcs = tuple(tuple(b) for b in bcs)
    if len(bcs) != ndim or any(
        len(b) != 2 or b[0] not in "ND" or b[1] not in "ND" for b in bcs
    ):
        raise ValueError(f"bcs must be {ndim} pairs drawn from 'N'/'D', got {bcs}")
    return bcs


def first_color_parity(bcs: BCS) -> int:
    """0-based sum-parity of the first-updated ("red") color.

    3D: parity 0 if the last axis' lower face is Neumann, else 1
    (matches ndsm_optimized.f90:106 with lb(1) = 1 or 2).
    Other ndim: parity 0 (matches the generic rule in 2D,
    ndsm_poisson.f90:501; deliberate true-checkerboard choice otherwise).
    """
    if len(bcs) == 3 and bcs[-1][0] == "D":
        return 1
    return 0


def is_all_neumann(bcs: BCS) -> bool:
    return all(b == ("N", "N") for b in bcs)


def stencil_weights(dq, dtype):
    """Per-axis off-diagonal weights ``w_i = 1/dq_i^2`` and inverse diagonal
    ``w0 = 1 / (2 * sum_i w_i)`` (reference: ndsm_optimized.f90:87-94)."""
    dq = jnp.asarray(dq)
    w = (1.0 / (dq * dq)).astype(dtype)
    w0 = (1.0 / (2.0 * jnp.sum(w))).astype(dtype)
    return w, w0


def _neighbors(u: jax.Array, axis: int) -> Tuple[jax.Array, jax.Array]:
    """(lower, upper) neighbor arrays along ``axis`` with Neumann index
    reflection baked into the boundary rows: at index 0 the lower neighbor
    is ``u[1]``; at index n-1 the upper neighbor is ``u[n-2]``.

    Dirichlet faces read these reflected values too, but every point *on* a
    Dirichlet face is masked out of the update (and its residual zeroed),
    so the reflection there is inert — exactly like the reference, where
    the shrunken loop bounds simply never evaluate those points.
    """
    lo = jnp.concatenate(
        [
            lax.slice_in_dim(u, 1, 2, axis=axis),
            lax.slice_in_dim(u, 0, u.shape[axis] - 1, axis=axis),
        ],
        axis=axis,
    )
    hi = jnp.concatenate(
        [
            lax.slice_in_dim(u, 1, u.shape[axis], axis=axis),
            lax.slice_in_dim(u, u.shape[axis] - 2, u.shape[axis] - 1, axis=axis),
        ],
        axis=axis,
    )
    return lo, hi


def _axis_iota(shape: Tuple[int, ...], axis: int) -> jax.Array:
    return lax.broadcasted_iota(jnp.int32, shape, axis)


def _interior_mask(shape: Tuple[int, ...], bcs: BCS) -> jax.Array:
    """True where the point is NOT on any Dirichlet face
    (reference: at_dirichlet_boundary, ndsm_poisson.f90:361-390)."""
    mask = None
    for ax, (blo, bhi) in enumerate(bcs):
        if blo == "D":
            m = _axis_iota(shape, ax) > 0
            mask = m if mask is None else (mask & m)
        if bhi == "D":
            m = _axis_iota(shape, ax) < shape[ax] - 1
            mask = m if mask is None else (mask & m)
    if mask is None:
        return jnp.ones(shape, dtype=bool)
    return mask


def _parity_mask(shape: Tuple[int, ...], parity: int) -> jax.Array:
    s = _axis_iota(shape, 0)
    for ax in range(1, len(shape)):
        s = s + _axis_iota(shape, ax)
    return (s % 2) == parity


def subtract_mean(u: jax.Array) -> jax.Array:
    """Pin the additive null space of all-Neumann problems
    (reference: ndsm_optimized.f90:173-189)."""
    return u - jnp.mean(u)


def _half_sweep(u, rhs, w, w0, mask):
    total = None
    for ax in range(u.ndim):
        lo, hi = _neighbors(u, ax)
        term = (lo + hi) * w[ax]
        total = term if total is None else total + term
    unew = (total - rhs) * w0
    return jnp.where(mask, unew, u)


@partial(jax.jit, static_argnames=("bcs",))
def rb_sweep(u: jax.Array, rhs: jax.Array, dq: jax.Array, bcs: BCS) -> jax.Array:
    """One red-black Gauss-Seidel sweep: red half-update, black half-update
    (reading the updated red values), then mean subtraction when all faces
    are Neumann.  Functionally identical to one call of the reference's
    relax operator (ndsm_optimized.f90:40; ndsm_poisson.f90:451)."""
    w, w0 = stencil_weights(dq, u.dtype)
    interior = _interior_mask(u.shape, bcs)
    red = first_color_parity(bcs)
    red_mask = _parity_mask(u.shape, red) & interior
    black_mask = _parity_mask(u.shape, 1 - red) & interior
    u = _half_sweep(u, rhs, w, w0, red_mask)
    u = _half_sweep(u, rhs, w, w0, black_mask)
    if is_all_neumann(bcs):
        u = subtract_mean(u)
    return u


@partial(jax.jit, static_argnames=("bcs",))
def poisson_residual(u: jax.Array, rhs: jax.Array, dq: jax.Array, bcs: BCS) -> jax.Array:
    """Residual ``r = -(L[u] - rhs) = rhs - L[u]`` with reflected-neighbor
    Neumann handling, zeroed on Dirichlet faces
    (reference: ndsm_optimized.f90:346-447; ndsm_poisson.f90:280-353)."""
    w, _ = stencil_weights(dq, u.dtype)
    lap = None
    for ax in range(u.ndim):
        lo, hi = _neighbors(u, ax)
        term = (lo - 2.0 * u + hi) * w[ax]
        lap = term if lap is None else lap + term
    r = rhs - lap
    interior = _interior_mask(u.shape, bcs)
    return jnp.where(interior, r, jnp.zeros((), dtype=u.dtype))
