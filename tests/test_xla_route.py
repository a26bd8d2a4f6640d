"""The engine's XLA smoothing route against the plain references.

``MGEngine.t_smooth`` runs the color-compact sweep (ops/stencils_compact.py)
by default and the masked sweep (ops/stencils.rb_sweep) when asked; the
V-cycle composes it with the residual, the transfers and the coarse solve.
These cases cover aligned, unaligned and odd extents, every boundary-face
mix the vector-potential pipeline uses, and 1, 2 and 5 sweeps per call,
checked against ``stencils.rb_sweep``, the loop-level oracle
(tests/oracle.py) and the native C++ core.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from ndsm_tpu import GridHierarchy
from ndsm_tpu.mg.engine import MGEngine
from ndsm_tpu.ops import stencils

BCS = {
    "DDD": (("D", "D"), ("D", "D"), ("D", "D")),
    "DDN": (("D", "D"), ("D", "D"), ("N", "N")),  # component Az
    "NDD": (("N", "N"), ("D", "D"), ("D", "D")),  # component Ax (D x-face)
    "mixed": (("D", "N"), ("N", "D"), ("D", "N")),
}
SHAPES = {
    "aligned": (16, 16, 32),
    "unaligned": (22, 22, 22),
    "odd": (7, 9, 11),
    "flat": (6, 10, 17),
}


def _hierarchy(shape, ngrids=2):
    meshes = [np.linspace(0.0, 1.0 + 0.1 * i, n) for i, n in enumerate(shape)]
    return GridHierarchy.from_mesh(meshes, ngrids=ngrids)


def _engine(h, bcs, dtype=jnp.float64, compact=True, ms=5):
    return MGEngine(
        h, bcs, ms=ms, du_max=True, dtype=dtype, compact_smoother=compact
    )


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _masked(u, rhs, dq, bcs, n):
    for _ in range(n):
        u = stencils.rb_sweep(u, rhs, dq, bcs)
    return np.asarray(u)


@pytest.mark.parametrize("ns", [1, 2, 5])
@pytest.mark.parametrize("bcs", list(BCS), ids=list(BCS))
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_t_smooth_matches_masked_reference(shape, bcs, ns):
    """f64 compact route == ns masked reference sweeps to rounding."""
    shape, bcs = SHAPES[shape], BCS[bcs]
    h = _hierarchy(shape)
    eng = _engine(h, bcs)
    assert eng.compact_smoother
    u, rhs = _fields(shape, ns)
    got = np.asarray(
        jax.jit(lambda u, r: eng.t_smooth(u, r, 0, nsweeps=ns))(u, rhs)
    )
    want = _masked(u, rhs, h.dq[0], bcs, ns)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("bcs", list(BCS), ids=list(BCS))
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_t_smooth_f32_tracks_f64(shape, bcs):
    """The f32 engine a mixed solve smooths with stays within f32
    resolution of the f64 masked reference over ms = 5 sweeps."""
    shape, bcs = SHAPES[shape], BCS[bcs]
    h = _hierarchy(shape)
    eng = _engine(h, bcs, dtype=jnp.float32)
    u, rhs = _fields(shape, 11)
    got = np.asarray(
        jax.jit(lambda u, r: eng.t_smooth(u, r, 0))(
            jnp.asarray(u, jnp.float32), jnp.asarray(rhs, jnp.float32)
        )
    )
    want = _masked(u, rhs, h.dq[0], bcs, 5)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "masked"])
@pytest.mark.parametrize("bcs", list(BCS), ids=list(BCS))
def test_single_sweep_matches_oracle(bcs, compact):
    """One engine sweep == the loop-level in-place reference sweep."""
    shape, bcs = (6, 7, 8), BCS[bcs]
    h = _hierarchy(shape)
    eng = _engine(h, bcs, compact=compact)
    u, rhs = _fields(shape, 3)
    got = np.asarray(eng.t_smooth(jnp.asarray(u), jnp.asarray(rhs), 0, nsweeps=1))
    want = oracle.rb_gauss_3d(u, rhs, h.dq[0], bcs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("bcs", list(BCS), ids=list(BCS))
def test_sweeps_match_native_core(bcs):
    """ms engine sweeps == ms sweeps of the native C++ core."""
    from ndsm_tpu.native import rb_sweep_3d

    shape, bcs = (10, 12, 14), BCS[bcs]
    h = _hierarchy(shape)
    eng = _engine(h, bcs)
    u, rhs = _fields(shape, 5)
    got = np.asarray(eng.t_smooth(jnp.asarray(u), jnp.asarray(rhs), 0))
    want = u
    for _ in range(5):
        want = rb_sweep_3d(want, rhs, h.dq[0], bcs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ref", ["oracle", "native"])
@pytest.mark.parametrize("bcs", list(BCS), ids=list(BCS))
def test_residual_matches_references(bcs, ref):
    from ndsm_tpu.native import residual_3d

    shape, bcs = (6, 7, 9), BCS[bcs]
    h = _hierarchy(shape)
    eng = _engine(h, bcs)
    u, rhs = _fields(shape, 7)
    got = np.asarray(eng.t_residual(jnp.asarray(u), jnp.asarray(rhs), 0))
    if ref == "oracle":
        want = oracle.residual_nd(u, rhs, h.dq[0], bcs)
    else:
        want = residual_3d(u, rhs, h.dq[0], bcs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def _vcycle_by_hand(h, bcs, u, rhs, ms, n_coarse):
    """Two-level V-cycle written out from the reference primitives:
    ms sweeps, residual, restriction, n_coarse coarse sweeps from zero,
    ms coarse sweeps, prolongation, correction, ms sweeps."""
    from ndsm_tpu.ops.transfer import (
        apply_axis_matrices,
        interp_matrix_1d,
        restrict_matrix_1d,
    )

    fine, coarse = h.meshes[0], h.meshes[1]
    R = [restrict_matrix_1d(c, f) for f, c in zip(fine, coarse)]
    P = [interp_matrix_1d(f, c) for f, c in zip(fine, coarse)]
    u1 = _masked(u, rhs, h.dq[0], bcs, ms)
    r = stencils.poisson_residual(u1, rhs, h.dq[0], bcs)
    rc = apply_axis_matrices(r, R)
    uc = _masked(jnp.zeros(h.shapes[1]), rc, h.dq[1], bcs, n_coarse + ms)
    cor = apply_axis_matrices(uc, P)
    return _masked(u1 + cor, rhs, h.dq[0], bcs, ms)


@pytest.mark.parametrize("bcs", list(BCS), ids=list(BCS))
@pytest.mark.parametrize("shape", ["unaligned", "odd"])
def test_vcycle_is_smooth_residual_correction_composition(shape, bcs):
    """t_vcycle (compact smoother, relax coarse solve with ex_tol = 0 so
    it runs exactly n sweeps) == the hand-written composition."""
    shape, bcs = SHAPES[shape], BCS[bcs]
    h = _hierarchy(shape)
    eng = _engine(h, bcs, ms=3)
    u, rhs = _fields(shape, 13)
    got, _ = jax.jit(eng.t_vcycle)(
        jnp.asarray(u), jnp.asarray(rhs), jnp.float64(0.0), jnp.int32(20)
    )
    want = _vcycle_by_hand(h, bcs, u, rhs, 3, 20)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0, atol=1e-11 * np.abs(want).max()
    )


@pytest.mark.parametrize("ns", [1, 3, 5])
@pytest.mark.parametrize("shape", [(16, 24, 32), (22, 22, 22), (7, 9, 11)])
def test_all_neumann_mean_sweep(shape, ns):
    """All-Neumann faces: every sweep subtracts the global mean (quirk Q7);
    the compact route matches the masked reference and leaves a zero-mean
    iterate."""
    bcs = (("N", "N"),) * 3
    h = _hierarchy(shape)
    eng = _engine(h, bcs)
    u, rhs = _fields(shape, 17)
    rhs = rhs - rhs.mean()
    got = np.asarray(
        jax.jit(lambda u, r: eng.t_smooth(u, r, 0, nsweeps=ns))(u, rhs)
    )
    want = _masked(u, rhs, h.dq[0], bcs, ns)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert abs(got.mean()) <= 1e-13 * np.abs(got).max()
