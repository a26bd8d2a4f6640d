"""Injectable multigrid operators — the engine's extension point.

The reference multigrid core is operator-agnostic: callers inject
problem-specific relaxation/residual procedures through the abstract
interfaces ``MG_RELAX``/``MG_RESIDUAL``
(fortran/ndsm_multigrid_core.f90:106-136), and the Poisson layer plugs
in via dispatch wrappers (fortran/ndsm_poisson.f90:163-276).  This
module is the JAX counterpart: an :class:`MGOperator` bundles
the traceable per-level relax/residual functions (plus two optional
hooks the reference expresses differently — a dense coarse-operator
assembly for the direct coarse solve, and a nullspace declaration),
and ``MGEngine``/``PoissonBVP`` accept one via their ``operator=``
argument.  Every driver capability (V-cycle/two-grid/one-grid, relax
or direct coarse solves, fp64/fp32 and mixed defect-correction
precision, history, checkpointing, batching via vmap) then runs the
injected operator: the mixed outer defect residual routes through
``MGEngine.t_residual`` and therefore through the operator as well.

Design notes (deliberately different from the reference):

  * The reference passes bare subroutines that mutate ``this%u(g_id)``
    in place; here an operator is a *hashable value object* whose
    methods are pure traceable functions ``(u, rhs, dq, bcs) -> array``.
    Hashability matters: it keys the engine/BVP caches, so two
    operators that compare equal share compiled programs.
  * Level geometry is passed explicitly (``dq`` — the level's per-axis
    spacings, f64) rather than through a mutable handle: each level
    re-discretizes the operator exactly like the reference's wrappers
    re-read ``this%meshes(:,g_id)``.
  * The engine's color-compact fast path encodes the Poisson stencil
    and stays reserved for the default (``operator=None``) engine; an
    injected operator runs through the masked-XLA formulation path,
    which XLA fuses per sweep.  An operator whose ``relax`` is itself a
    custom kernel gets kernel performance with no engine changes.

Contract for implementers:

  * ``relax(u, rhs, dq, bcs)`` — ONE full relaxation sweep of
    ``L u = rhs`` (the engine composes ``ms``-sweep smoothing and the
    coarse relax-to-tolerance loop from it).  It must keep Dirichlet
    points frozen (the engine carries inhomogeneous Dirichlet data in
    the iterate, reference ndsm_poisson.f90:591-594) and must handle
    any nullspace pinning itself (the reference's relax subtracts the
    mean for all-Neumann Poisson, ndsm_optimized.f90:173-189).
  * ``residual(u, rhs, dq, bcs)`` — ``rhs - L[u]``, zeroed on
    Dirichlet faces (reference ndsm_poisson.f90:325-328).
  * ``coarse_matrix(shape, dq, bcs)`` — optional: return
    ``(S, int_mask_flat)`` such that ``e_int = S @ rhs_int`` solves the
    coarse problem (see mg/coarse.py), or None to use the reference's
    relax-to-``ex_tol`` coarse solve (which only needs ``relax``).
  * ``is_singular(bcs)`` — True when L has the constant nullspace for
    these BCs; the outer defect-correction loop then pins the mean of
    the corrected iterate exactly as for all-Neumann Poisson.
  * Both methods must be dtype-polymorphic (f32/f64): mixed precision
    calls ``residual`` in f64 and ``relax`` in f32.

Instances must be hashable and comparable by value — use frozen
dataclasses (both built-ins here are).

Distribution: injected operators compose with the GSPMD path
(``PoissonBVP(shard_spec=...)`` — XLA partitions the operator's ops
and inserts the collectives; tested on an 8-device mesh).  The
explicit shard_map engine (parallel/sm_engine.py) is
Poisson-specialized (hand-placed halos encode the 7-point stencil
radius) and does not take operators; its reference counterpart — the
OpenMP loops — is equally Poisson-bound there.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import stencils
from ..ops.stencils import BCS

__all__ = [
    "MGOperator",
    "PoissonOperator",
    "HelmholtzOperator",
    "DiffusionOperator",
]


class MGOperator:
    """Abstract injectable operator (see module docstring for the
    contract; reference analogue: the MG_RELAX/MG_RESIDUAL abstract
    interfaces, fortran/ndsm_multigrid_core.f90:106-136)."""

    def relax(self, u: jax.Array, rhs: jax.Array, dq, bcs: BCS) -> jax.Array:
        raise NotImplementedError

    def residual(self, u: jax.Array, rhs: jax.Array, dq, bcs: BCS) -> jax.Array:
        raise NotImplementedError

    def coarse_matrix(self, shape, dq, bcs: BCS):
        """(S, int_mask_flat) for a one-matvec direct coarse solve, or
        None to relax the coarsest grid to ``ex_tol`` instead."""
        return None

    def is_singular(self, bcs: BCS) -> bool:
        """True when the operator has the additive-constant nullspace
        under these BCs (all-Neumann Poisson semantics: per-sweep mean
        pinning in ``relax``, outer-iterate mean pinning in the
        drivers)."""
        return False


@dataclasses.dataclass(frozen=True)
class PoissonOperator(MGOperator):
    """The default operator, as an explicit value: second-order
    red-black Gauss-Seidel Poisson (ops/stencils.py; reference
    ndsm_optimized.f90:40,346).  ``MGEngine(operator=None)`` encodes
    exactly this with its compact fast path enabled; injecting
    ``PoissonOperator()`` runs the same math through the generic
    operator route (masked XLA formulation) — tests pin the two
    bitwise-equal against the masked smoother."""

    def relax(self, u, rhs, dq, bcs):
        return stencils.rb_sweep(u, rhs, dq, bcs)

    def residual(self, u, rhs, dq, bcs):
        return stencils.poisson_residual(u, rhs, dq, bcs)

    def coarse_matrix(self, shape, dq, bcs):
        from .coarse import build_coarse_solver_matrix

        return build_coarse_solver_matrix(shape, dq, bcs)

    def is_singular(self, bcs):
        return stencils.is_all_neumann(bcs)


@dataclasses.dataclass(frozen=True)
class HelmholtzOperator(MGOperator):
    """Shifted operator ``L[u] = laplace(u) - c*u`` (modified Helmholtz
    for ``c > 0``) — the non-Poisson client of the injection point.

    Same second-order discretization, Neumann index reflection, frozen
    Dirichlet faces, and red-black ordering as the Poisson stencil;
    only the diagonal changes: ``u_new = (sum_ax (lo+hi)*w_ax - rhs) /
    (2*sum_ax w_ax + c)``.  For ``c > 0`` the operator is nonsingular
    even with all-Neumann faces (no mean pinning; the direct coarse
    solve uses a true inverse); ``c == 0`` degrades gracefully to
    Poisson semantics.
    """

    c: float = 0.0

    def __post_init__(self):
        if not (self.c >= 0.0):
            raise ValueError(f"HelmholtzOperator needs c >= 0, got {self.c}")

    def relax(self, u, rhs, dq, bcs):
        return _helmholtz_relax(
            u, rhs, jnp.asarray(dq), c=self.c, bcs=bcs,
            singular=self.is_singular(bcs),
        )

    def residual(self, u, rhs, dq, bcs):
        return _helmholtz_residual(u, rhs, jnp.asarray(dq), c=self.c, bcs=bcs)

    def coarse_matrix(self, shape, dq, bcs):
        from .coarse import build_coarse_solver_matrix

        return build_coarse_solver_matrix(
            shape, dq, bcs, diag_shift=-float(self.c)
        )

    def is_singular(self, bcs):
        return self.c == 0.0 and stencils.is_all_neumann(bcs)


@dataclasses.dataclass(frozen=True)
class DiffusionOperator(MGOperator):
    """Variable-coefficient diffusion ``L[u] = div(a(q) grad u)`` —
    the second non-Poisson client of the injection point, exercising
    what :class:`HelmholtzOperator` cannot: per-level operator
    *re-discretization* from spatially varying data (the reference's
    wrappers re-read ``this%meshes(:,g_id)`` per level for exactly this
    reason, ndsm_poisson.f90:163-276).

    ``coef`` maps NORMALIZED per-axis coordinates (each in [0, 1] over
    the domain, ``ndim`` broadcastable arrays in ``indexing='ij'``
    order) to a strictly positive coefficient array.  Normalized
    coordinates make the definition level-independent: every multigrid
    level re-evaluates ``coef`` on its own nodes (coarse nodes are an
    exact subset of fine nodes for the power-of-2-plus-1 hierarchies,
    so the coarse coefficient is the injected fine one).

    Discretization: standard second-order flux form with
    arithmetic-mean face coefficients,

      ``L[u]_i = sum_ax (a_{i+1/2}(u_{i+1}-u_i)
                         - a_{i-1/2}(u_i-u_{i-1})) / dq_ax^2``,

    red-black Gauss-Seidel relaxation solving pointwise
    ``u_i = (sum_ax (a_lo u_lo + a_hi u_hi) w_ax - rhs_i) / den_i``
    with ``den_i = sum_ax (a_lo + a_hi) w_ax``.  Boundary faces reuse
    the engine's Neumann index reflection (ops/stencils._neighbors) for
    both ``u`` and ``a`` — the mirrored half-coefficient at index 0 is
    ``a_{1/2}``, exactly the image flux of the zero-normal-derivative
    condition.  ``a == const`` reduces to ``const *`` the Poisson
    stencil (and to the Poisson iterates exactly, since the relax
    fixed-point equation is scale-invariant).

    Like all-Neumann Poisson, the operator has the additive-constant
    nullspace under all-Neumann BCs for ANY positive ``a``; the direct
    coarse solve is assembled generically from the operator's own
    residual (mg/coarse.build_coarse_matrix_from_operator).

    ``coef`` is compared/hashed by identity (it keys the jit and engine
    caches): reuse one function object per operator, as with any jitted
    closure.

    Performance note: the face coefficients are (re)computed inside the
    traced relax/residual, so within the engine's cycle ``while_loop``
    XLA may re-materialize them per iteration.  That is the documented
    cost tier of the generic operator route; an operator whose
    ``relax`` is a custom kernel closing over precomputed
    coefficient arrays gets kernel performance with no engine changes.
    """

    coef: object = None  # Callable[*norm_coords] -> positive array

    def __post_init__(self):
        if not callable(self.coef):
            raise ValueError("DiffusionOperator needs coef=<callable>")

    def relax(self, u, rhs, dq, bcs):
        return _diffusion_relax(
            u, rhs, jnp.asarray(dq), coef=self.coef, bcs=bcs,
            singular=self.is_singular(bcs),
        )

    def residual(self, u, rhs, dq, bcs):
        return _diffusion_residual(
            u, rhs, jnp.asarray(dq), coef=self.coef, bcs=bcs
        )

    def coarse_matrix(self, shape, dq, bcs):
        from .coarse import build_coarse_matrix_from_operator

        return build_coarse_matrix_from_operator(self, shape, dq, bcs)

    def is_singular(self, bcs):
        return stencils.is_all_neumann(bcs)


def _diffusion_halves(shape, coef, dtype):
    """Face coefficients ``(a_lo, a_hi)`` per axis: evaluate ``coef`` on
    the level's normalized node grid, then arithmetic-mean to the
    half-points with the same index reflection as the stencil reads
    (so the mirrored boundary half-coefficient matches the mirrored
    neighbor)."""
    coords = jnp.meshgrid(
        *[jnp.linspace(0.0, 1.0, n, dtype=dtype) for n in shape],
        indexing="ij",
    )
    a = jnp.broadcast_to(jnp.asarray(coef(*coords), dtype), shape)
    halves = []
    for ax in range(len(shape)):
        lo, hi = stencils._neighbors(a, ax)
        halves.append((0.5 * (a + lo), 0.5 * (a + hi)))
    return halves


def _diffusion_apply(u, halves, w):
    """``L[u]`` in flux form (no masking)."""
    out = None
    for ax in range(u.ndim):
        lo, hi = stencils._neighbors(u, ax)
        alo, ahi = halves[ax]
        term = (ahi * (hi - u) - alo * (u - lo)) * w[ax]
        out = term if out is None else out + term
    return out


@partial(jax.jit, static_argnames=("coef", "bcs", "singular"))
def _diffusion_relax(u, rhs, dq, *, coef, bcs, singular):
    w = (1.0 / (dq * dq)).astype(u.dtype)
    halves = _diffusion_halves(u.shape, coef, u.dtype)
    den = None
    for ax in range(u.ndim):
        alo, ahi = halves[ax]
        t = (alo + ahi) * w[ax]
        den = t if den is None else den + t
    interior = stencils._interior_mask(u.shape, bcs)
    red = stencils.first_color_parity(bcs)
    masks = (
        stencils._parity_mask(u.shape, red) & interior,
        stencils._parity_mask(u.shape, 1 - red) & interior,
    )
    for mask in masks:
        num = None
        for ax in range(u.ndim):
            lo, hi = stencils._neighbors(u, ax)
            alo, ahi = halves[ax]
            t = (alo * lo + ahi * hi) * w[ax]
            num = t if num is None else num + t
        u = jnp.where(mask, (num - rhs) / den, u)
    if singular:
        u = stencils.subtract_mean(u)
    return u


@partial(jax.jit, static_argnames=("coef", "bcs"))
def _diffusion_residual(u, rhs, dq, *, coef, bcs):
    w = (1.0 / (dq * dq)).astype(u.dtype)
    halves = _diffusion_halves(u.shape, coef, u.dtype)
    r = rhs - _diffusion_apply(u, halves, w)
    interior = stencils._interior_mask(u.shape, bcs)
    return jnp.where(interior, r, jnp.zeros((), dtype=u.dtype))


def _helmholtz_weights(dq, c, dtype):
    """w_ax = 1/dq_ax^2 and inverse diagonal 1/(2*sum(w) + c); at c = 0
    bitwise stencils.stencil_weights."""
    w = (1.0 / (dq * dq)).astype(dtype)
    w0 = (1.0 / (2.0 * jnp.sum(w) + jnp.asarray(c, dtype))).astype(dtype)
    return w, w0


@partial(jax.jit, static_argnames=("c", "bcs", "singular"))
def _helmholtz_relax(u, rhs, dq, *, c, bcs, singular):
    w, w0 = _helmholtz_weights(dq, c, u.dtype)
    interior = stencils._interior_mask(u.shape, bcs)
    red = stencils.first_color_parity(bcs)
    red_mask = stencils._parity_mask(u.shape, red) & interior
    black_mask = stencils._parity_mask(u.shape, 1 - red) & interior
    u = stencils._half_sweep(u, rhs, w, w0, red_mask)
    u = stencils._half_sweep(u, rhs, w, w0, black_mask)
    if singular:
        u = stencils.subtract_mean(u)
    return u


@partial(jax.jit, static_argnames=("c", "bcs"))
def _helmholtz_residual(u, rhs, dq, *, c, bcs):
    w, _ = _helmholtz_weights(dq, c, u.dtype)
    cc = jnp.asarray(c, u.dtype)
    lap = None
    for ax in range(u.ndim):
        lo, hi = stencils._neighbors(u, ax)
        term = (lo - 2.0 * u + hi) * w[ax]
        lap = term if lap is None else lap + term
    r = rhs - (lap - cc * u)
    interior = stencils._interior_mask(u.shape, bcs)
    return jnp.where(interior, r, jnp.zeros((), dtype=u.dtype))
