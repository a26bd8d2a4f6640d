"""Every matrix product of the solvers asks for Precision.HIGHEST.

A float32 dot_general without it may run in TF32 on a GPU (about three
decimal digits), which would silently weaken the transfers and the
direct coarse solve of the mixed-precision V-cycles.  These tests walk
the jaxprs of the engine, batched and sharded V-cycles, the transfers
and the coarse solve and check each dot_general's precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from ndsm_tpu import GridHierarchy, Options
from ndsm_tpu.mg.batched import MultiBCSolver
from ndsm_tpu.mg.engine import MGEngine
from ndsm_tpu.mg.poisson import PoissonBVP
from ndsm_tpu.ops.transfer import apply_axis_matrices, restrict_matrix_1d

BCS = (("D", "D"), ("N", "N"), ("D", "N"))
N = 16


def _dot_precisions(jaxpr):
    """precision params of every dot_general in ``jaxpr``, recursively
    through jit, while/cond bodies, shard_map and vmap'd sub-jaxprs."""
    found = []

    def visit(obj):
        if hasattr(obj, "eqns"):
            for eqn in obj.eqns:
                if eqn.primitive.name == "dot_general":
                    found.append(eqn.params["precision"])
                for v in eqn.params.values():
                    visit(v)
        elif hasattr(obj, "jaxpr"):
            visit(obj.jaxpr)
        elif isinstance(obj, (tuple, list)):
            for v in obj:
                visit(v)

    visit(jaxpr)
    return found


def _assert_highest(closed):
    precs = _dot_precisions(closed)
    assert precs, "no dot_general found: the guard would be vacuous"
    for p in precs:
        assert p is not None, "dot_general with default precision"
        ps = p if isinstance(p, tuple) else (p, p)
        assert all(q == lax.Precision.HIGHEST for q in ps), p


def _hierarchy():
    x = np.linspace(0.0, 1.0, N)
    return GridHierarchy.from_mesh((x, x, x))


def _scalars():
    return jnp.float64(1e-10), jnp.float64(1e-13), jnp.int32(10), jnp.int32(10)


@pytest.mark.parametrize(
    "dtype,direct", [(jnp.float32, True), (jnp.float64, False)],
    ids=["f32-direct", "f64-relax"],
)
def test_engine_vcycle(dtype, direct):
    eng = MGEngine(_hierarchy(), BCS, ms=2, du_max=True, dtype=dtype,
                   coarse_direct=direct)
    u = jnp.zeros((N,) * 3, dtype)
    _assert_highest(jax.make_jaxpr(eng.t_vcycle)(u, u, dtype(0), jnp.int32(5)))


def test_mixed_solve_program():
    bvp = PoissonBVP(_hierarchy(), BCS, Options(precision="mixed"))
    u = jnp.zeros((N,) * 3)
    vc, ex, nm, ne = _scalars()
    _assert_highest(
        jax.make_jaxpr(bvp._solve_impl, static_argnums=(6,))(u, u, vc, ex, nm, ne, 6)
    )


def test_batched_solve_program():
    comps = [
        tuple(("N", "N") if (2 - ax) == c else ("D", "D") for ax in range(3))
        for c in range(3)
    ]
    mbs = MultiBCSolver(_hierarchy(), comps, Options(precision="mixed"))
    u = jnp.zeros((3,) + (N,) * 3)
    vc, ex, nm, ne = _scalars()
    _assert_highest(jax.make_jaxpr(mbs._solve_impl)(u, vc, ex, nm, ne))


def test_sharded_solve_program():
    from ndsm_tpu.parallel.shard import make_mesh
    from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

    sb = ShardedPoissonBVP(_hierarchy(), BCS, Options(precision="mixed"),
                           mesh=make_mesh(4), min_rows_per_shard=2)
    u = jnp.zeros((N,) * 3)
    vc, ex, nm, ne = _scalars()
    _assert_highest(jax.make_jaxpr(sb._solve_jit)(u, u, vc, ex, nm, ne))


def test_transfers_and_coarse_direct_solve():
    h = _hierarchy()
    mats = [restrict_matrix_1d(c, f) for f, c in zip(h.meshes[0], h.meshes[1])]
    x = jnp.zeros(h.shapes[0], jnp.float32)
    _assert_highest(jax.make_jaxpr(lambda v: apply_axis_matrices(v, mats))(x))
    eng = MGEngine(h, BCS, ms=2, du_max=True, dtype=jnp.float32,
                   coarse_direct=True)
    assert eng.coarse_direct
    rc = jnp.zeros(h.shapes[-1], jnp.float32)
    _assert_highest(jax.make_jaxpr(eng.t_coarse_solve_direct)(rc))
