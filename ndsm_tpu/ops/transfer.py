"""Coordinate-based grid-transfer operators: N-linear prolongation and its
full-weighting adjoint restriction.

The reference computes these point-by-point with per-point coordinate
bracketing and a 2^N corner gather (``ninterp`` / ``nrestrict``,
fortran/ndsm_interp.f90:85,186).  Because every mesh is uniform per axis
(coarse meshes are regenerated linspaces, ndsm_multigrid_core.f90:253-259),
both operators are exactly *separable*: the N-D weight is a product of
per-axis 1-D weights.  We therefore precompute one small dense matrix per
axis and apply them as per-axis contractions — dense matrix products
instead of gather traffic, and they shard trivially.

Per-axis weights (identical math to the reference):

  * Prolongation ``P[f, c]``: linear interpolation of the coarse value at
    the fine coordinate using the bracketing coarse cell, with clamped
    extrapolation beyond the ends (find_bracket_points_uniform,
    ndsm_interp.f90:373-435; weights ndsm_interp.f90:141-152).
  * Restriction ``R[c, f] = |dq_c - |q_f - q_c|| * dq_f / dq_c^2`` over the
    fine points bracketed by ``q_c ± dq_c``
    (ndsm_interp.f90:218-290).

``R_axis = (dq_f/dq_c) * P_axis^T`` on interior rows, which is what makes
the Galerkin identity ``<u_c, R u_f>_c = <P u_c, u_f>_f`` hold to rounding
(verified by tests/test_transfer.py, the port of unit_test_galerkin.f90).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "bracket_uniform",
    "interp_matrix_1d",
    "restrict_matrix_1d",
    "apply_axis_matrices",
    "prolong",
    "restrict",
    "ninterp",
    "inner_product",
]


def bracket_uniform(qvec: np.ndarray, q0: float) -> Tuple[int, int, int]:
    """0-based port of ``find_bracket_points_uniform``
    (ndsm_interp.f90:373-435).  Returns (lo, hi, ierr) with ierr = -1/+1
    when q0 lies below/above the mesh (clamped bracket), else 0."""
    nq = len(qvec)
    if nq == 1:
        raise ValueError("mesh vector has length 1")
    if q0 <= qvec[0]:
        return 0, 1, -1
    if q0 >= qvec[nq - 1]:
        return nq - 2, nq - 1, +1
    dq = qvec[1] - qvec[0]
    lo = int(math.floor((q0 - qvec[0]) / dq))
    if lo >= nq - 1:
        lo, hi = nq - 2, nq - 1
    else:
        hi = lo + 1
    return lo, hi, 0


def interp_matrix_1d(qf: np.ndarray, qc: np.ndarray) -> np.ndarray:
    """(nf, nc) linear-interpolation matrix taking coarse-mesh values to
    fine-mesh coordinates (per-axis factor of ninterp, ndsm_interp.f90:85)."""
    qf = np.asarray(qf, dtype=np.float64)
    qc = np.asarray(qc, dtype=np.float64)
    P = np.zeros((qf.size, qc.size), dtype=np.float64)
    for i, q0 in enumerate(qf):
        lo, hi, _ = bracket_uniform(qc, q0)
        ql, qh = qc[lo], qc[hi]
        dq = qh - ql
        wl = (q0 - ql) / dq  # weight of the HIGH bracket point
        wh = -(q0 - qh) / dq  # weight of the LOW bracket point
        P[i, lo] += wh
        P[i, hi] += wl
    return P


def restrict_matrix_1d(qc: np.ndarray, qf: np.ndarray) -> np.ndarray:
    """(nc, nf) full-weighting restriction matrix, the per-axis factor of
    ``nrestrict`` (ndsm_interp.f90:186-292) including its bracket-edge
    selection rules."""
    qc = np.asarray(qc, dtype=np.float64)
    qf = np.asarray(qf, dtype=np.float64)
    dq_c = qc[1] - qc[0]
    dq_f = qf[1] - qf[0]
    w2 = dq_f / dq_c**2
    R = np.zeros((qc.size, qf.size), dtype=np.float64)
    for c, q0 in enumerate(qc):
        il, ih, ierr = bracket_uniform(qf, q0 - dq_c)
        lo = il if ierr < 0 else ih
        il, ih, ierr = bracket_uniform(qf, q0 + dq_c)
        hi = ih if ierr > 0 else il
        for f in range(lo, hi + 1):
            c1 = abs(qf[f] - q0)
            c2 = abs(dq_c - c1)
            R[c, f] = c2 * w2
    return R


def apply_axis_matrices(x: jax.Array, mats: Sequence[np.ndarray]) -> jax.Array:
    """Apply one matrix per axis: ``y = (M_0 ⊗ M_1 ⊗ ...) x``.

    Each contraction is a dense matmul.  HIGHEST precision keeps float32
    runs at true f32 accuracy (a GPU would otherwise compute float32
    products in TF32, which keeps about three decimal digits).
    """
    for ax, m in enumerate(mats):
        mj = jnp.asarray(m, dtype=x.dtype)
        x = jnp.moveaxis(x, ax, 0)
        x = jnp.tensordot(
            mj, x, axes=([1], [0]), precision=jax.lax.Precision.HIGHEST
        )
        x = jnp.moveaxis(x, 0, ax)
    return x


def prolong(u_c: jax.Array, interp_mats: Sequence[np.ndarray]) -> jax.Array:
    """Coarse -> fine N-linear interpolation (mg_interp,
    ndsm_multigrid_core.f90:865-921)."""
    return apply_axis_matrices(u_c, interp_mats)


def restrict(u_f: jax.Array, restrict_mats: Sequence[np.ndarray]) -> jax.Array:
    """Fine -> coarse full-weighting restriction (mg_restrict,
    ndsm_multigrid_core.f90:1010-1065)."""
    return apply_axis_matrices(u_f, restrict_mats)


def ninterp(
    f: np.ndarray, meshes: Sequence[np.ndarray], q0: Sequence[float]
) -> float:
    """Interpolate the gridded function ``f`` at one arbitrary point ``q0``
    (direct port of ninterp semantics, ndsm_interp.f90:85-158; used by the
    exactness unit tests).  ``f`` has shape ``(n_0, ..., n_{d-1})`` with
    axis i ↔ meshes[i]."""
    f = np.asarray(f)
    ndim = f.ndim
    # Bracket each axis, then reduce one axis at a time with linear weights.
    vals = f
    for ax in range(ndim - 1, -1, -1):
        q = np.asarray(meshes[ax], dtype=np.float64)
        lo, hi, _ = bracket_uniform(q, float(q0[ax]))
        ql, qh = q[lo], q[hi]
        dq = qh - ql
        wl = (float(q0[ax]) - ql) / dq
        wh = -(float(q0[ax]) - qh) / dq
        vals = wh * np.take(vals, lo, axis=ax) + wl * np.take(vals, hi, axis=ax)
    return float(vals)


def inner_product(u: jax.Array, v: jax.Array, dq: Sequence[float]) -> jax.Array:
    """Cell-volume-weighted inner product ``sum(u v) * prod(dq)``
    (ndsm_interp.f90:503-543)."""
    dV = float(np.prod(np.asarray(dq, dtype=np.float64)))
    return jnp.sum(u * v) * jnp.asarray(dV, dtype=u.dtype)
