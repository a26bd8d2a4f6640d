"""Second-order finite differences and curl.

Vectorized re-design of the reference's per-point ``derivq``
(ndsm_vector_potential.f90:825-872): central differences in the interior
and one-sided second-order stencils [-3, +4, -1]/(2h) at the ends, applied
as fused slice arithmetic along an axis.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "deriv_axis",
    "curl",
    "deriv_axis_np",
    "curl_np",
    "curl_np_into",
]


def _sl(u: jax.Array, axis: int, lo: int, hi) -> jax.Array:
    if hi is None:
        hi = u.shape[axis]
    elif hi < 0:
        hi = u.shape[axis] + hi
    return lax.slice_in_dim(u, lo, hi, axis=axis)


def deriv_axis(u: jax.Array, h: jax.Array, axis: int) -> jax.Array:
    """du/dq along ``axis`` with uniform spacing ``h``: second-order central
    in the interior, one-sided [-3,+4,-1]/(2h) at the two boundary layers
    (reference: derivq, ndsm_vector_potential.f90:852-864)."""
    inv2h = (0.5 / jnp.asarray(h)).astype(u.dtype)
    interior = (_sl(u, axis, 2, None) - _sl(u, axis, 0, -2)) * inv2h
    lo = (
        -3.0 * _sl(u, axis, 0, 1) + 4.0 * _sl(u, axis, 1, 2) - _sl(u, axis, 2, 3)
    ) * inv2h
    n = u.shape[axis]
    hi = (
        3.0 * _sl(u, axis, n - 1, n)
        - 4.0 * _sl(u, axis, n - 2, n - 1)
        + _sl(u, axis, n - 3, n - 2)
    ) * inv2h
    return jnp.concatenate([lo, interior, hi], axis=axis)


@partial(jax.jit)
def curl(A: jax.Array, dq: jax.Array) -> jax.Array:
    """B = curl(A) for ``A`` of shape (3, nz, ny, nx) with components
    (Ax, Ay, Az) and ``dq = (dx, dy, dz)``
    (reference: curl, ndsm_vector_potential.f90:759-811).

    Axis map (C order): d/dx -> axis -1, d/dy -> axis -2, d/dz -> axis -3
    of each (nz, ny, nx) component.
    """
    Ax, Ay, Az = A[0], A[1], A[2]
    dx, dy, dz = dq[0], dq[1], dq[2]
    dAz_dy = deriv_axis(Az, dy, -2)
    dAy_dz = deriv_axis(Ay, dz, -3)
    dAx_dz = deriv_axis(Ax, dz, -3)
    dAz_dx = deriv_axis(Az, dx, -1)
    dAy_dx = deriv_axis(Ay, dx, -1)
    dAx_dy = deriv_axis(Ax, dy, -2)
    return jnp.stack([dAz_dy - dAy_dz, dAx_dz - dAz_dx, dAy_dx - dAx_dy])


# ----------------------------------------------------------------------
# Host (numpy) mirrors — same expression sequences, ulp-level agreement.
#
# Why these exist: B = curl(A) is the last pipeline stage and, under the
# default flux-correction order, is a pure function of the RETURNED A.
# On hosts whose device link is slow relative to host memory bandwidth,
# shipping B (same bytes as A again) can dwarf the solve; computing the
# curl on the host
# from the already-downloaded A halves the result traffic.  The operand
# order matches the XLA forms exactly, but XLA fuses multiply-adds into
# FMAs (single rounding), so agreement is at the ~1-2 ulp level
# (measured max 2.5e-14 relative; tests/test_potential.py pins 1e-13) —
# eight orders below the h^2 truncation error of the returned fields.
# ----------------------------------------------------------------------


def deriv_axis_np(u, h, axis: int):
    """numpy mirror of :func:`deriv_axis` — identical operand order."""
    import numpy as _np

    u = _np.asarray(u)
    inv2h = _np.asarray(0.5 / _np.asarray(h), dtype=u.dtype)

    def sl(lo, hi):
        n = u.shape[axis]
        if hi is None:
            hi = n
        elif hi < 0:
            hi = n + hi
        idx = [slice(None)] * u.ndim
        idx[axis] = slice(lo, hi)
        return u[tuple(idx)]

    interior = (sl(2, None) - sl(0, -2)) * inv2h
    lo = (-3.0 * sl(0, 1) + 4.0 * sl(1, 2) - sl(2, 3)) * inv2h
    n = u.shape[axis]
    hi = (3.0 * sl(n - 1, n) - 4.0 * sl(n - 2, n - 1) + sl(n - 3, n - 2)) * inv2h
    return _np.concatenate([lo, interior, hi], axis=axis)


def curl_np(A, dq):
    """numpy mirror of :func:`curl` — identical component expressions."""
    import numpy as _np

    A = _np.asarray(A)
    Ax, Ay, Az = A[0], A[1], A[2]
    dx, dy, dz = dq[0], dq[1], dq[2]
    dAz_dy = deriv_axis_np(Az, dy, -2)
    dAy_dz = deriv_axis_np(Ay, dz, -3)
    dAx_dz = deriv_axis_np(Ax, dz, -3)
    dAz_dx = deriv_axis_np(Az, dx, -1)
    dAy_dx = deriv_axis_np(Ay, dx, -1)
    dAx_dy = deriv_axis_np(Ax, dy, -2)
    return _np.stack([dAz_dy - dAy_dz, dAx_dz - dAz_dx, dAy_dx - dAx_dy])


def _deriv_z_rows_np(F, h, z0: int, z1: int, compute_dtype):
    """Rows [z0, z1) of deriv_axis_np(F, h, axis=-3): the same per-row
    expressions (central interior, one-sided [-3,+4,-1]/(2h) at the two
    global faces), reading only F[max(z0-1,0) : min(z1+1, n)] plus the
    3-point one-sided stencils when the range touches a face."""
    import numpy as _np

    n = F.shape[0]
    inv2h = _np.asarray(0.5 / _np.asarray(h), dtype=compute_dtype)

    def rows(a, b):
        r = F[a:b]
        return r if r.dtype == compute_dtype else r.astype(compute_dtype)

    parts = []
    if z0 == 0:
        parts.append((-3.0 * rows(0, 1) + 4.0 * rows(1, 2) - rows(2, 3)) * inv2h)
    a, b = max(z0, 1), min(z1, n - 1)
    if b > a:
        parts.append((rows(a + 1, b + 1) - rows(a - 1, b - 1)) * inv2h)
    if z1 == n:
        parts.append(
            (3.0 * rows(n - 1, n) - 4.0 * rows(n - 2, n - 1) + rows(n - 3, n - 2))
            * inv2h
        )
    return parts[0] if len(parts) == 1 else _np.concatenate(parts, axis=0)


def curl_np_into(A, dq, out, z0: int = 0, z1=None):
    """Write ``out[:, z0:z1] = curl_np(A)[:, z0:z1]`` bitwise-identically,
    reading only A[:, z0-1 : z1+1] (plus the 3-row one-sided stencils at
    the global z faces).  Differencing runs in float64 regardless of the
    dtypes of ``A``/``out`` (matching the production host-curl path,
    which upcasts a float32 download before differencing).

    This is the chunk kernel of the pipelined download+curl: each z
    chunk's curl is computed while later chunks are still in flight,
    hiding the host curl entirely behind the device->host transfer.
    """
    import numpy as _np

    A = _np.asarray(A)
    nz = A.shape[1]
    z1 = nz if z1 is None else z1
    cd = _np.float64
    Ax, Ay, Az = A[0], A[1], A[2]
    dx, dy, dz = dq[0], dq[1], dq[2]

    def chunk(F):
        r = F[z0:z1]
        return r if r.dtype == cd else r.astype(cd)

    dAz_dy = deriv_axis_np(chunk(Az), dy, -2)
    dAy_dz = _deriv_z_rows_np(Ay, dz, z0, z1, cd)
    dAx_dz = _deriv_z_rows_np(Ax, dz, z0, z1, cd)
    dAz_dx = deriv_axis_np(chunk(Az), dx, -1)
    dAy_dx = deriv_axis_np(chunk(Ay), dx, -1)
    dAx_dy = deriv_axis_np(chunk(Ax), dy, -2)
    out[0, z0:z1] = dAz_dy - dAy_dz
    out[1, z0:z1] = dAx_dz - dAz_dx
    out[2, z0:z1] = dAy_dx - dAx_dy
    return out
