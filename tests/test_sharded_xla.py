"""The explicit shard_map engine's per-shard XLA primitives (halo
exchange by ppermute, global-index boundary handling, psum means,
per-shard transfer blocks) against the single-device engine, on 1-axis
('z') and 2-axis ('z', 'y') meshes of virtual CPU devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ndsm_tpu import GridHierarchy, Options
from ndsm_tpu.mg.engine import MGEngine
from ndsm_tpu.ops import stencils
from ndsm_tpu.ops.transfer import apply_axis_matrices
from ndsm_tpu.parallel.shard import make_mesh, make_mesh_nd
from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

SHAPE = (32, 16, 16)
BCS = {
    "component_z": (("D", "D"), ("D", "D"), ("N", "N")),
    "mixed": (("D", "N"), ("N", "D"), ("D", "N")),
    "neumann": (("N", "N"), ("N", "N"), ("N", "N")),
}


def _setup(axes, bcs, smoother="auto"):
    meshes = [np.linspace(0.0, 1.0 + 0.1 * i, n) for i, n in enumerate(SHAPE)]
    h = GridHierarchy.from_mesh(meshes)
    if axes == 1:
        mesh, names = make_mesh(4), ("z",)
    else:
        mesh, names = make_mesh_nd((2, 2), ("z", "y")), ("z", "y")
    eng = ShardedPoissonBVP(
        h, bcs, Options(precision="fp64", smoother=smoother),
        mesh=mesh, axis_names=names, min_rows_per_shard=2,
    )
    spec = P(*names)
    return h, eng, mesh, spec


def _run(mesh, spec, fn, *arrays, n_out=1):
    out_specs = spec if n_out == 1 else (spec,) * n_out
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrays),
                          out_specs=out_specs))
    sh = NamedSharding(mesh, spec)
    return f(*[jax.device_put(jnp.asarray(a), sh) for a in arrays])


def _fields(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(SHAPE), rng.standard_normal(SHAPE)


@pytest.mark.parametrize(
    "op", ["smooth_compact", "smooth_masked", "residual", "smooth_residual"]
)
@pytest.mark.parametrize("bcs", list(BCS), ids=list(BCS))
@pytest.mark.parametrize("axes", [1, 2])
def test_sharded_level_op_matches_single_device(axes, bcs, op):
    bcs = BCS[bcs]
    h, eng, mesh, spec = _setup(
        axes, bcs, smoother="masked" if op == "smooth_masked" else "auto"
    )
    assert eng.seam >= 1
    u, rhs = _fields(axes)
    ms = 3
    single = MGEngine(h, bcs, ms=ms, du_max=True, dtype=jnp.float64)
    if op in ("smooth_compact", "smooth_masked"):
        got = _run(mesh, spec, lambda u, r: eng._smooth(u, r, 0, ms), u, rhs)
        want = [single.t_smooth(jnp.asarray(u), jnp.asarray(rhs), 0)]
        got = [got]
    elif op == "residual":
        got = [_run(mesh, spec, lambda u, r: eng._sharded_residual(u, r, 0), u, rhs)]
        want = [stencils.poisson_residual(u, rhs, h.dq[0], bcs)]
    else:
        got = _run(mesh, spec, lambda u, r: eng._smooth_residual_sh(u, r, 0, ms),
                   u, rhs, n_out=2)
        us = single.t_smooth(jnp.asarray(u), jnp.asarray(rhs), 0)
        want = [us, single.t_residual(us, jnp.asarray(rhs), 0)]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=0, atol=1e-12 * np.abs(w).max()
        )


@pytest.mark.parametrize("direction", ["restrict", "prolong"])
@pytest.mark.parametrize("axes", [1, 2])
def test_sharded_transfer_blocks_match_full_matrices(axes, direction):
    """Sharded->sharded restriction/prolongation with per-shard matrix
    blocks over an H-plane halo == the full per-axis matrices."""
    bcs = BCS["mixed"]
    h, eng, mesh, spec = _setup(axes, bcs)
    assert eng.seam >= 2  # levels 0 and 1 are both sharded
    rng = np.random.default_rng(5 + axes)
    if direction == "restrict":
        x = rng.standard_normal(h.shapes[0])
        got = _run(mesh, spec, lambda v: eng._restrict(v, 0), x)
        want = apply_axis_matrices(jnp.asarray(x), eng._restrict_full[0])
    else:
        x = rng.standard_normal(h.shapes[1])
        got = _run(mesh, spec, lambda v: eng._prolong(v, 0), x)
        want = apply_axis_matrices(jnp.asarray(x), eng._interp_full[0])
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-12 * np.abs(want).max())
