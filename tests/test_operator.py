"""Operator-injection extension point (mg/operator.py).

The reference engine is operator-agnostic via the MG_RELAX/MG_RESIDUAL
abstract interfaces (fortran/ndsm_multigrid_core.f90:106-136); these
tests pin the JAX counterpart: loop-level oracles for the non-Poisson
client (HelmholtzOperator), bitwise equivalence of the generic routing
against the built-in Poisson path, dense-solve oracles end-to-end
through solve_poisson_bvp, h^2 truncation scaling, mixed precision
through the injected operator, and the relax-coarse fallback for
operators without a dense coarse assembly.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from ndsm_tpu import (
    DiffusionOperator,
    GridHierarchy,
    HelmholtzOperator,
    Options,
    PoissonOperator,
    solve_poisson_bvp,
)
from ndsm_tpu.mg.coarse import build_coarse_solver_matrix
from ndsm_tpu.mg.poisson import PoissonBVP
from ndsm_tpu.ops import stencils

from oracle import _reflect


# ----------------------------------------------------------------------
# Loop-level oracles for the shifted operator L[u] = lap(u) - c*u
# ----------------------------------------------------------------------

def _relax_shifted(u, rhs, dq, bcs, c):
    """Red-black Gauss-Seidel for lap(u) - c*u = rhs; first color from
    stencils.first_color_parity (the library's reference-pinned rule)."""
    u = u.copy()
    ndim = u.ndim
    shape = u.shape
    w = [1.0 / (d * d) for d in dq]
    w0 = 1.0 / (2.0 * sum(w) + c)
    red = stencils.first_color_parity(tuple(tuple(b) for b in bcs))

    def at_dirichlet(idx):
        return any(
            (idx[ax] == 0 and bcs[ax][0] == "D")
            or (idx[ax] == shape[ax] - 1 and bcs[ax][1] == "D")
            for ax in range(ndim)
        )

    for parity in (red, 1 - red):
        for idx in itertools.product(*[range(n) for n in shape]):
            if sum(idx) % 2 != parity or at_dirichlet(idx):
                continue
            s = 0.0
            for ax in range(ndim):
                lo, hi = list(idx), list(idx)
                lo[ax] = _reflect(idx[ax] - 1, shape[ax])
                hi[ax] = _reflect(idx[ax] + 1, shape[ax])
                s += (u[tuple(lo)] + u[tuple(hi)]) * w[ax]
            u[idx] = (s - rhs[idx]) * w0
    return u


def _residual_shifted(u, rhs, dq, bcs, c):
    ndim = u.ndim
    shape = u.shape
    w = [1.0 / (d * d) for d in dq]
    r = np.zeros_like(u)
    for idx in itertools.product(*[range(n) for n in shape]):
        if any(
            (idx[ax] == 0 and bcs[ax][0] == "D")
            or (idx[ax] == shape[ax] - 1 and bcs[ax][1] == "D")
            for ax in range(ndim)
        ):
            continue
        lap = 0.0
        for ax in range(ndim):
            lo, hi = list(idx), list(idx)
            lo[ax] = _reflect(idx[ax] - 1, shape[ax])
            hi[ax] = _reflect(idx[ax] + 1, shape[ax])
            lap += (u[tuple(lo)] - 2.0 * u[idx] + u[tuple(hi)]) * w[ax]
        r[idx] = rhs[idx] - (lap - c * u[idx])
    return r


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape)


# ----------------------------------------------------------------------
# Operator-level oracles
# ----------------------------------------------------------------------

@pytest.mark.parametrize(
    "shape,bcs",
    [
        ((6, 5, 7), (("D", "N"), ("N", "N"), ("D", "D"))),
        ((6, 5, 7), (("N", "N"), ("N", "D"), ("N", "N"))),
        ((9, 8), (("D", "D"), ("N", "D"))),
    ],
)
def test_helmholtz_relax_residual_oracle(shape, bcs):
    c = 2.75
    dq = np.array([0.11, 0.09, 0.13][: len(shape)])
    u = _rand(shape, 0)
    rhs = _rand(shape, 1)
    op = HelmholtzOperator(c)
    got = np.asarray(op.relax(u, rhs, dq, bcs))
    want = _relax_shifted(u, rhs, dq, bcs, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-14)
    gotr = np.asarray(op.residual(u, rhs, dq, bcs))
    wantr = _residual_shifted(u, rhs, dq, bcs, c)
    np.testing.assert_allclose(gotr, wantr, rtol=0, atol=5e-12)


def test_helmholtz_c0_is_poisson_bitwise():
    """c = 0 must degrade exactly to the Poisson stencil (same graph)."""
    shape, bcs = (6, 5, 8), (("N", "N"), ("D", "N"), ("N", "N"))
    dq = np.array([0.1, 0.12, 0.07])
    u = _rand(shape, 2)
    rhs = _rand(shape, 3)
    op = HelmholtzOperator(0.0)
    a = np.asarray(op.relax(u, rhs, dq, bcs))
    b = np.asarray(stencils.rb_sweep(u, rhs, np.asarray(dq), bcs))
    assert np.array_equal(a, b)
    ar = np.asarray(op.residual(u, rhs, dq, bcs))
    br = np.asarray(stencils.poisson_residual(u, rhs, np.asarray(dq), bcs))
    assert np.array_equal(ar, br)


def test_poisson_operator_generic_route_bitwise():
    """Injecting PoissonOperator() through the generic operator route
    must reproduce the built-in masked path bitwise (same stopping
    cycle, same iterate)."""
    n = 21
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"), ("N", "D"), ("D", "N"))
    rhs = _rand((n, n, n), 4)
    opts = Options(precision="fp64", smoother="masked")
    bvp0 = PoissonBVP(h, bcs, opts)
    bvp1 = PoissonBVP(h, bcs, opts, operator=PoissonOperator())
    u0 = np.zeros((n, n, n))
    ua, ia = bvp0.solve(u0, rhs, vc_tol=1e-9)
    ub, ib = bvp1.solve(u0, rhs, vc_tol=1e-9)
    assert ia.cycles == ib.cycles
    assert np.array_equal(np.asarray(ua), np.asarray(ub))


# ----------------------------------------------------------------------
# End-to-end solves through solve_poisson_bvp
# ----------------------------------------------------------------------

def test_helmholtz_dense_oracle_3d():
    """Multigrid Helmholtz solve vs the dense fine-grid inverse."""
    n = 17
    c = 3.4
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "N"), ("N", "D"), ("D", "D"))
    rhs = np.sin(
        1.7 * x[:, None, None] * 10
        + 0.3 * x[None, :, None] * 7
        + 2.1 * x[None, None, :] * 4
    )
    u, info = solve_poisson_bvp(
        np.zeros_like(rhs),
        rhs,
        (x, x, x),
        bcs,
        options=Options(precision="fp64", vc_tol=1e-11),
        operator=HelmholtzOperator(c),
    )
    assert info.ierr == 0
    dq = [x[1] - x[0]] * 3
    S, int_mask = build_coarse_solver_matrix((n, n, n), dq, bcs, diag_shift=-c)
    u_dense = np.zeros(n**3)
    u_dense[int_mask] = S @ rhs.ravel()[int_mask]
    np.testing.assert_allclose(
        np.asarray(u).ravel(), u_dense, rtol=0, atol=1e-9
    )


@pytest.mark.parametrize("precision", ["fp64", "mixed", "fp32"])
def test_helmholtz_manufactured_scaling(precision):
    """u* = sin(pi x)sin(pi y)sin(pi z), L[u*] = -(3 pi^2 + c) u*:
    truncation error must shrink ~h^2 from 17^3 to 33^3, in every
    precision mode (mixed exercises the f64 defect residual through the
    injected operator)."""
    c = 1.9
    errs, hs = [], []
    tol = {"fp64": 1e-10, "mixed": 1e-10, "fp32": 2e-6}[precision]
    for n in (17, 33):
        x = np.linspace(0.0, 1.0, n)
        Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
        U = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
        rhs = -(3.0 * np.pi**2 + c) * U
        u, info = solve_poisson_bvp(
            np.zeros_like(U),
            rhs,
            (x, x, x),
            (("D", "D"),) * 3,
            options=Options(precision=precision, vc_tol=tol),
            operator=HelmholtzOperator(c),
        )
        assert info.ierr == 0
        errs.append(np.abs(np.asarray(u, dtype=np.float64) - U).max())
        hs.append(x[1] - x[0])
    rate = np.log(errs[0] / errs[1]) / np.log(hs[0] / hs[1])
    assert 1.7 < rate < 2.3, (rate, errs)


def test_helmholtz_all_neumann_nonsingular():
    """All-Neumann + c > 0 has NO nullspace: the solution is unique (not
    just up to a constant) and no mean pinning may be applied."""
    c = 1.0
    n = 33
    x = np.linspace(0.0, 1.0, n)
    Y, X = np.meshgrid(x, x, indexing="ij")
    U = np.cos(np.pi * X) * np.cos(np.pi * Y) + 0.37
    rhs = -(2.0 * np.pi**2) * (U - 0.37) - c * U
    op = HelmholtzOperator(c)
    assert not op.is_singular((("N", "N"), ("N", "N")))
    u, info = solve_poisson_bvp(
        np.zeros_like(U),
        rhs,
        (x, x),
        (("N", "N"), ("N", "N")),
        options=Options(precision="fp64", vc_tol=1e-11),
        operator=op,
    )
    assert info.ierr == 0
    # absolute comparison — constant offset must be recovered too
    assert np.abs(np.asarray(u) - U).max() < 5e-3


@dataclasses.dataclass(frozen=True)
class _NoCoarseHelmholtz(HelmholtzOperator):
    """Operator WITHOUT a dense coarse assembly: the engine must fall
    back to the reference's relax-to-ex_tol coarse solve."""

    def coarse_matrix(self, shape, dq, bcs):
        return None


def test_operator_coarse_relax_fallback():
    n = 17
    c = 3.4
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "N"), ("N", "D"), ("D", "D"))
    rhs = _rand((n, n, n), 7)
    h = GridHierarchy.from_mesh((x, x, x))
    opts = Options(precision="fp64", vc_tol=1e-10, coarse_solver="direct")
    bvp = PoissonBVP(h, bcs, opts, operator=_NoCoarseHelmholtz(c))
    assert not bvp._inner.coarse_direct  # gracefully disabled
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 0
    # same answer as the direct-coarse engine, to solver tolerance
    bvp2 = PoissonBVP(h, bcs, opts, operator=HelmholtzOperator(c))
    assert bvp2._inner.coarse_direct
    u2, info2 = bvp2.solve(np.zeros_like(rhs), rhs)
    assert info2.ierr == 0
    np.testing.assert_allclose(np.asarray(u), np.asarray(u2), atol=1e-8)


def test_engine_cache_keys_distinct_operators():
    """Same hierarchy/BCs/options with different operators must not
    collide in the engine/BVP caches."""
    n = 17
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "D"),) * 3
    rhs = _rand((n, n, n), 8)
    opts = Options(precision="fp64", vc_tol=1e-10)
    u_p1, _ = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts)
    u_h, _ = solve_poisson_bvp(
        np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts,
        operator=HelmholtzOperator(5.0),
    )
    u_p2, _ = solve_poisson_bvp(np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts)
    assert np.abs(np.asarray(u_p1) - np.asarray(u_h)).max() > 1e-6
    assert np.array_equal(np.asarray(u_p1), np.asarray(u_p2))


def test_helmholtz_history_and_info():
    """history=True works through the operator route (per-cycle du)."""
    n = 17
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "D"),) * 3
    rhs = _rand((n, n, n), 9)
    h = GridHierarchy.from_mesh((x, x, x))
    bvp = PoissonBVP(
        h, bcs, Options(precision="fp64", vc_tol=1e-10),
        operator=HelmholtzOperator(2.0),
    )
    u, info = bvp.solve(np.zeros_like(rhs), rhs, history=True)
    assert info.ierr == 0
    hist = np.asarray(info.du_history)
    assert np.isfinite(hist[: info.cycles]).all()
    assert hist[info.cycles - 1] < 1e-10


def test_helmholtz_gspmd_sharded():
    """Operator injection composes with GSPMD sharding: the sharded
    Helmholtz solve equals the unsharded one (XLA inserts the
    collectives around the injected relax/residual)."""
    import jax

    if len(jax.devices()) < 8:
        import pytest as _pytest

        _pytest.skip("needs 8 (virtual) devices")
    from ndsm_tpu.parallel.shard import ShardSpec, make_mesh

    n = 32
    c = 2.2
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"), ("N", "N"), ("D", "D"))
    rhs = _rand((n, n, n), 12)
    opts = Options(precision="fp64", vc_tol=1e-10)
    op = HelmholtzOperator(c)
    u_ref, i_ref = PoissonBVP(h, bcs, opts, operator=op).solve(
        np.zeros_like(rhs), rhs
    )
    spec = ShardSpec(mesh=make_mesh(8), min_rows_per_shard=2)
    u_sh, i_sh = PoissonBVP(h, bcs, opts, shard_spec=spec, operator=op).solve(
        np.zeros_like(rhs), rhs
    )
    assert i_sh.ierr == 0
    assert i_sh.cycles == i_ref.cycles
    np.testing.assert_allclose(
        np.asarray(u_sh), np.asarray(u_ref), rtol=0, atol=1e-11
    )


def test_helmholtz_4d_dense_oracle():
    """The injected operator is N-D generic like the engine (reference
    generic relax/residual, ndsm_poisson.f90:451,280): 4D Helmholtz
    solve vs the dense inverse."""
    n = 7
    c = 1.3
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "D"), ("N", "N"), ("D", "N"), ("D", "D"))
    rhs = _rand((n, n, n, n), 21)
    h = GridHierarchy.from_mesh((x, x, x, x), ngrids=2)
    bvp = PoissonBVP(
        h, bcs, Options(precision="fp64", vc_tol=1e-11),
        operator=HelmholtzOperator(c),
    )
    u, info = bvp.solve(np.zeros_like(rhs), rhs)
    assert info.ierr == 0
    dq = [x[1] - x[0]] * 4
    S, int_mask = build_coarse_solver_matrix((n,) * 4, dq, bcs, diag_shift=-c)
    u_dense = np.zeros(n**4)
    u_dense[int_mask] = S @ rhs.ravel()[int_mask]
    np.testing.assert_allclose(
        np.asarray(u).ravel(), u_dense, rtol=0, atol=1e-9
    )


# ----------------------------------------------------------------------
# Variable-coefficient diffusion client (DiffusionOperator): per-level
# re-discretization from spatially varying data — the capability the
# reference's per-level wrapper re-reads of this%meshes exist for
# (ndsm_poisson.f90:163-276).
# ----------------------------------------------------------------------

def _coef_smooth(*q):
    """Strictly positive, smoothly varying test coefficient."""
    import jax.numpy as _jnp

    a = 1.0
    for i, qi in enumerate(q):
        a = a + 0.4 * _jnp.sin((1.3 + 0.7 * i) * qi + 0.2 * i)
    return a


def _coef_nodes_np(shape):
    coords = np.meshgrid(
        *[np.linspace(0.0, 1.0, n) for n in shape], indexing="ij"
    )
    a = 1.0
    for i, qi in enumerate(coords):
        a = a + 0.4 * np.sin((1.3 + 0.7 * i) * qi + 0.2 * i)
    return a


def _diffusion_relax_oracle(u, rhs, dq, bcs, a):
    """Loop-level red-black flux-form relax for div(a grad u) = rhs."""
    u = u.copy()
    shape = u.shape
    ndim = u.ndim
    w = [1.0 / (d * d) for d in dq]
    red = stencils.first_color_parity(tuple(tuple(b) for b in bcs))

    def at_dirichlet(idx):
        return any(
            (idx[ax] == 0 and bcs[ax][0] == "D")
            or (idx[ax] == shape[ax] - 1 and bcs[ax][1] == "D")
            for ax in range(ndim)
        )

    for parity in (red, 1 - red):
        for idx in itertools.product(*[range(n) for n in shape]):
            if sum(idx) % 2 != parity or at_dirichlet(idx):
                continue
            num = 0.0
            den = 0.0
            for ax in range(ndim):
                lo, hi = list(idx), list(idx)
                lo[ax] = _reflect(idx[ax] - 1, shape[ax])
                hi[ax] = _reflect(idx[ax] + 1, shape[ax])
                alo = 0.5 * (a[idx] + a[tuple(lo)])
                ahi = 0.5 * (a[idx] + a[tuple(hi)])
                num += (alo * u[tuple(lo)] + ahi * u[tuple(hi)]) * w[ax]
                den += (alo + ahi) * w[ax]
            u[idx] = (num - rhs[idx]) / den
    return u


def _diffusion_residual_oracle(u, rhs, dq, bcs, a):
    shape = u.shape
    ndim = u.ndim
    w = [1.0 / (d * d) for d in dq]
    r = np.zeros_like(u)
    for idx in itertools.product(*[range(n) for n in shape]):
        if any(
            (idx[ax] == 0 and bcs[ax][0] == "D")
            or (idx[ax] == shape[ax] - 1 and bcs[ax][1] == "D")
            for ax in range(ndim)
        ):
            continue
        lu = 0.0
        for ax in range(ndim):
            lo, hi = list(idx), list(idx)
            lo[ax] = _reflect(idx[ax] - 1, shape[ax])
            hi[ax] = _reflect(idx[ax] + 1, shape[ax])
            alo = 0.5 * (a[idx] + a[tuple(lo)])
            ahi = 0.5 * (a[idx] + a[tuple(hi)])
            lu += (
                ahi * (u[tuple(hi)] - u[idx]) - alo * (u[idx] - u[tuple(lo)])
            ) * w[ax]
        r[idx] = rhs[idx] - lu
    return r


@pytest.mark.parametrize(
    "shape,bcs",
    [
        ((6, 5, 7), (("D", "N"), ("N", "N"), ("D", "D"))),
        ((9, 8), (("N", "N"), ("N", "D"))),
    ],
)
def test_diffusion_relax_residual_oracle(shape, bcs):
    dq = np.array([0.11, 0.09, 0.13][: len(shape)])
    u = _rand(shape, 40)
    rhs = _rand(shape, 41)
    a = _coef_nodes_np(shape)
    op = DiffusionOperator(_coef_smooth)
    got = np.asarray(op.relax(u, rhs, dq, bcs))
    want = _diffusion_relax_oracle(u, rhs, dq, bcs, a)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-13)
    gotr = np.asarray(op.residual(u, rhs, dq, bcs))
    wantr = _diffusion_residual_oracle(u, rhs, dq, bcs, a)
    np.testing.assert_allclose(gotr, wantr, rtol=0, atol=5e-12)


def test_diffusion_constant_coef_is_poisson():
    """a == const: same fixed-point equation as Poisson (the const
    cancels), so the solves must agree to solver tolerance."""
    n = 17
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "D"), ("N", "D"), ("D", "N"))
    rhs = _rand((n, n, n), 42)
    opts = Options(precision="fp64", vc_tol=1e-11)
    u_p, i_p = solve_poisson_bvp(
        np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts
    )
    u_d, i_d = solve_poisson_bvp(
        np.zeros_like(rhs), rhs, (x, x, x), bcs, options=opts,
        operator=DiffusionOperator(lambda *q: 3.25 + 0.0 * q[0]),
    )
    assert i_p.ierr == 0 and i_d.ierr == 0
    # const*lap(u) = rhs  <=>  lap(u) = rhs/const: the diffusion solve
    # is the Poisson one divided by the constant.
    np.testing.assert_allclose(
        3.25 * np.asarray(u_d), np.asarray(u_p), rtol=0, atol=1e-9
    )


def test_generic_coarse_assembly_matches_hand_assembly():
    """build_coarse_matrix_from_operator probed on PoissonOperator must
    reproduce the hand-assembled Poisson coarse matrix (both the
    regular inverse and the all-Neumann pseudo-inverse branch)."""
    from ndsm_tpu.mg.coarse import build_coarse_matrix_from_operator

    dq = [0.125, 0.2, 0.11]
    for bcs in [
        (("D", "N"), ("N", "N"), ("D", "D")),
        (("N", "N"), ("N", "N"), ("N", "N")),
    ]:
        S_hand, m_hand = build_coarse_solver_matrix((5, 6, 5), dq, bcs)
        S_gen, m_gen = build_coarse_matrix_from_operator(
            PoissonOperator(), (5, 6, 5), dq, bcs
        )
        assert np.array_equal(m_hand, m_gen)
        np.testing.assert_allclose(S_gen, S_hand, rtol=0, atol=1e-9)


def test_diffusion_dense_oracle_3d():
    """Multigrid variable-coefficient solve vs the dense fine-grid
    inverse assembled generically from the operator's own residual."""
    from ndsm_tpu.mg.coarse import build_coarse_matrix_from_operator

    n = 17
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "N"), ("N", "D"), ("D", "D"))
    rhs = _rand((n, n, n), 43)
    op = DiffusionOperator(_coef_smooth)
    u, info = solve_poisson_bvp(
        np.zeros_like(rhs),
        rhs,
        (x, x, x),
        bcs,
        options=Options(precision="fp64", vc_tol=1e-11),
        operator=op,
    )
    assert info.ierr == 0
    dq = [x[1] - x[0]] * 3
    S, int_mask = build_coarse_matrix_from_operator(op, (n, n, n), dq, bcs)
    u_dense = np.zeros(n**3)
    u_dense[int_mask] = S @ rhs.ravel()[int_mask]
    np.testing.assert_allclose(
        np.asarray(u).ravel(), u_dense, rtol=0, atol=1e-8
    )


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
def test_diffusion_manufactured_scaling(precision):
    """u* = sin(pi x)sin(pi y)sin(pi z), a = 1 + x y z:
    rhs = a lap(u*) + grad(a).grad(u*) analytic; truncation error must
    shrink ~h^2 (mixed runs the f64 defect residual through the
    variable-coefficient operator)."""
    errs, hs = [], []
    for n in (17, 33):
        x = np.linspace(0.0, 1.0, n)
        Z = x[:, None, None]
        Y = x[None, :, None]
        X = x[None, None, :]
        sx, cx = np.sin(np.pi * X), np.cos(np.pi * X)
        sy, cy = np.sin(np.pi * Y), np.cos(np.pi * Y)
        sz, cz = np.sin(np.pi * Z), np.cos(np.pi * Z)
        U = sz * sy * sx
        a = 1.0 + Z * Y * X
        rhs = a * (-3.0 * np.pi**2) * U + np.pi * (
            Y * X * cz * sy * sx + Z * X * sz * cy * sx + Z * Y * sz * sy * cx
        )
        u, info = solve_poisson_bvp(
            np.zeros((n, n, n)),
            rhs,
            (x, x, x),
            (("D", "D"),) * 3,
            options=Options(precision=precision, vc_tol=1e-10),
            operator=DiffusionOperator(lambda q0, q1, q2: 1.0 + q0 * q1 * q2),
        )
        assert info.ierr == 0
        errs.append(np.abs(np.asarray(u, dtype=np.float64) - U).max())
        hs.append(x[1] - x[0])
    rate = np.log(errs[0] / errs[1]) / np.log(hs[0] / hs[1])
    assert 1.7 < rate < 2.3, (rate, errs)


def test_diffusion_all_neumann_singular():
    """All-Neumann variable-coefficient diffusion keeps the constant
    nullspace for any positive a: mean-pinned solve converges to the
    mean-subtracted manufactured solution at ~h^2."""
    op = DiffusionOperator(lambda q0, q1: 1.0 + 0.3 * q0 * q1)
    assert op.is_singular((("N", "N"), ("N", "N")))
    errs, hs = [], []
    for n in (33, 65):
        x = np.linspace(0.0, 1.0, n)
        Y = x[:, None]
        X = x[None, :]
        cy, sy = np.cos(np.pi * Y), np.sin(np.pi * Y)
        cx, sx = np.cos(np.pi * X), np.sin(np.pi * X)
        U = cy * cx
        a = 1.0 + 0.3 * Y * X
        # div(a grad U) = a lap U + grad a . grad U
        rhs = a * (-2.0 * np.pi**2) * U + 0.3 * np.pi * (
            X * (-sy) * cx + Y * cy * (-sx)
        )
        u, info = solve_poisson_bvp(
            np.zeros((n, n)),
            rhs,
            (x, x),
            (("N", "N"), ("N", "N")),
            options=Options(precision="fp64", vc_tol=1e-11, mean=True),
            operator=op,
        )
        assert info.ierr == 0
        got = np.asarray(u)
        got = got - got.mean()
        want = U - U.mean()
        errs.append(np.abs(got - want).max())
        hs.append(x[1] - x[0])
    rate = np.log(errs[0] / errs[1]) / np.log(hs[0] / hs[1])
    assert 1.7 < rate < 2.3, (rate, errs)


def test_diffusion_gspmd_sharded():
    """The variable-coefficient operator composes with GSPMD sharding
    exactly like the constant-coefficient clients (the per-level
    coefficient evaluation is traced into the partitioned program)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from ndsm_tpu.parallel.shard import ShardSpec, make_mesh

    n = 32
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"), ("N", "N"), ("D", "D"))
    rhs = _rand((n, n, n), 44)
    opts = Options(precision="fp64", vc_tol=1e-10)
    op = DiffusionOperator(_coef_smooth)
    u_ref, i_ref = PoissonBVP(h, bcs, opts, operator=op).solve(
        np.zeros_like(rhs), rhs
    )
    spec = ShardSpec(mesh=make_mesh(8), min_rows_per_shard=2)
    u_sh, i_sh = PoissonBVP(h, bcs, opts, shard_spec=spec, operator=op).solve(
        np.zeros_like(rhs), rhs
    )
    assert i_sh.ierr == 0
    assert i_sh.cycles == i_ref.cycles
    np.testing.assert_allclose(
        np.asarray(u_sh), np.asarray(u_ref), rtol=0, atol=1e-11
    )


def test_helmholtz_checkpointed_resume(tmp_path):
    """solve_checkpointed composes with an injected operator (the
    resumable-solve contract holds for non-Poisson problems too)."""
    n = 17
    c = 2.0
    x = np.linspace(0.0, 1.0, n)
    bcs = (("D", "D"),) * 3
    rhs = _rand((n, n, n), 30)
    h = GridHierarchy.from_mesh((x, x, x))
    bvp = PoissonBVP(
        h, bcs, Options(precision="mixed", vc_tol=1e-10),
        operator=HelmholtzOperator(c),
    )
    u_ref, i_ref = bvp.solve(np.zeros_like(rhs), rhs)
    ck = str(tmp_path / "hck.npz")
    u_ck, i_ck = bvp.solve_checkpointed(
        np.zeros_like(rhs), rhs, checkpoint_path=ck, checkpoint_every=2
    )
    assert i_ck.ierr == 0
    # strict-group checkpointing vs default-group solve: same solution
    # to solver tolerance
    np.testing.assert_allclose(
        np.asarray(u_ck), np.asarray(u_ref), rtol=0, atol=1e-9
    )
    # resume: already converged, no further cycles
    u2, i2 = bvp.solve_checkpointed(
        np.zeros_like(rhs), rhs, checkpoint_path=ck, checkpoint_every=2
    )
    assert i2.cycles == i_ck.cycles
    assert np.array_equal(np.asarray(u2), np.asarray(u_ck))
