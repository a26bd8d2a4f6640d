"""Distribution-layer tests on a faked 8-device CPU mesh: the
halo-exchange shard_map smoother/residual must agree with the
single-device kernels, and the GSPMD-sharded full solver must agree with
the unsharded solve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ndsm_tpu import GridHierarchy, Options
from ndsm_tpu.mg.poisson import PoissonBVP
from ndsm_tpu.ops import stencils
from ndsm_tpu.parallel.sm_engine import make_sharded_sweep, make_sharded_residual
from ndsm_tpu.parallel.shard import ShardSpec, make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


BCS_CASES = [
    (("N", "N"), ("N", "N"), ("N", "N")),
    (("D", "D"), ("D", "D"), ("N", "N")),
    (("D", "N"), ("N", "D"), ("D", "D")),
]


@pytest.mark.parametrize("bcs", BCS_CASES)
def test_sharded_sweep_matches_single_device(bcs):
    mesh = make_mesh(8)
    shape = (16, 9, 11)
    rng = np.random.default_rng(3)
    u = rng.standard_normal(shape)
    rhs = rng.standard_normal(shape)
    dq = np.array([0.7, 1.1, 0.9])
    want = np.asarray(stencils.rb_sweep(u, rhs, dq, bcs))
    f, sharding = make_sharded_sweep(shape, bcs, dq, mesh, dtype=jnp.float64)
    us = jax.device_put(jnp.asarray(u), sharding)
    rs = jax.device_put(jnp.asarray(rhs), sharding)
    got = np.asarray(f(us, rs))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_sharded_sweep_iterated():
    """Multiple sweeps (red/black interleaving across shard boundaries)."""
    mesh = make_mesh(8)
    shape = (24, 12, 12)
    bcs = (("D", "D"), ("N", "N"), ("N", "N"))
    rng = np.random.default_rng(4)
    u = rng.standard_normal(shape)
    rhs = rng.standard_normal(shape)
    dq = np.array([1.0, 1.0, 1.0])
    want = u
    for _ in range(4):
        want = stencils.rb_sweep(want, rhs, dq, bcs)
    want = np.asarray(want)
    f, sharding = make_sharded_sweep(shape, bcs, dq, mesh, dtype=jnp.float64)
    got = jax.device_put(jnp.asarray(u), sharding)
    rs = jax.device_put(jnp.asarray(rhs), sharding)
    for _ in range(4):
        got = f(got, rs)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-11)


@pytest.mark.parametrize("bcs", BCS_CASES[:2])
def test_sharded_residual_matches(bcs):
    mesh = make_mesh(8)
    shape = (16, 9, 11)
    rng = np.random.default_rng(5)
    u = rng.standard_normal(shape)
    rhs = rng.standard_normal(shape)
    dq = np.array([0.8, 1.0, 1.2])
    want = np.asarray(stencils.poisson_residual(u, rhs, dq, bcs))
    f, sharding = make_sharded_residual(shape, bcs, dq, mesh)
    got = np.asarray(
        f(jax.device_put(jnp.asarray(u), sharding), jax.device_put(jnp.asarray(rhs), sharding))
    )
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_gspmd_solve_matches_unsharded():
    """Full V-cycle solve with per-level sharding constraints == the
    unsharded solve (same program semantics, XLA-inserted collectives)."""
    n = 32
    x = np.linspace(0, 1, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    U = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
    rhs = -3 * np.pi**2 * U
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"),) * 3
    opts = Options(precision="fp64")
    u_ref, info_ref = PoissonBVP(h, bcs, opts).solve(np.zeros_like(U), rhs)
    spec = ShardSpec(mesh=make_mesh(8), min_rows_per_shard=2)
    u_sh, info_sh = PoissonBVP(h, bcs, opts, shard_spec=spec).solve(
        np.zeros_like(U), rhs
    )
    assert info_sh.ierr == 0
    np.testing.assert_allclose(
        np.asarray(u_sh), np.asarray(u_ref), rtol=0, atol=1e-11
    )
    assert info_sh.cycles == info_ref.cycles


def test_gspmd_2d_mesh_solve():
    """2-axis (z, y) spatial decomposition over a 4x2 mesh."""
    from ndsm_tpu.parallel.shard import make_mesh_nd

    n = 32
    x = np.linspace(0, 1, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    U = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
    rhs = -3 * np.pi**2 * U
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"),) * 3
    opts = Options(precision="fp64")
    u_ref, _ = PoissonBVP(h, bcs, opts).solve(np.zeros_like(U), rhs)
    mesh = make_mesh_nd((4, 2), ("z", "y"))
    spec = ShardSpec(
        mesh=mesh, axis=0, axis_name="z", min_rows_per_shard=2,
        extra_axes=((1, "y"),),
    )
    u_sh, info = PoissonBVP(h, bcs, opts, shard_spec=spec).solve(
        np.zeros_like(U), rhs
    )
    assert info.ierr == 0
    np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref), atol=1e-11)


class TestShardMapEngine:
    """Fully explicit shard_map multigrid solver vs the single-device
    engine (identical results and cycle counts)."""

    def _problem(self, n, bcs):
        x = np.linspace(0, 1, n)
        Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
        U = np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)
        rhs = -3 * np.pi**2 * U
        return x, U, rhs

    @pytest.mark.parametrize(
        "bcs",
        [
            (("D", "D"), ("D", "D"), ("D", "D")),
            (("D", "D"), ("N", "N"), ("D", "D")),
            (("N", "N"), ("N", "N"), ("N", "N")),
        ],
    )
    def test_matches_single_device(self, bcs):
        from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

        n = 32
        x, U, rhs = self._problem(n, bcs)
        if all(b == ("N", "N") for b in bcs):
            rhs = rhs - rhs.mean()
        h = GridHierarchy.from_mesh((x, x, x))
        opts = Options(precision="fp64", smoother="masked")
        u_ref, info_ref = PoissonBVP(h, bcs, opts).solve(np.zeros_like(U), rhs)
        sbvp = ShardedPoissonBVP(h, bcs, opts, mesh=make_mesh(8), min_rows_per_shard=2)
        assert sbvp.seam >= 1
        u_sm, info_sm = sbvp.solve(np.zeros_like(U), rhs)
        assert info_sm.ierr == info_ref.ierr
        assert info_sm.cycles == info_ref.cycles
        if all(b == ("N", "N") for b in bcs):
            # Singular system: hundreds of mean-subtracted sweeps amplify
            # psum-vs-serial reduction-order differences; both iterates
            # satisfy the equation equally well, so compare mean-adjusted
            # solutions at a looser tolerance and check both residuals.
            a = np.asarray(u_sm) - np.asarray(u_sm).mean()
            b = np.asarray(u_ref) - np.asarray(u_ref).mean()
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            # and both iterates leave the same residual (the test rhs is
            # discretely incompatible, so the residual itself is not small)
            from ndsm_tpu.ops.stencils import poisson_residual

            dq = np.array([x[1] - x[0]] * 3)
            r_sm = np.asarray(poisson_residual(np.asarray(u_sm), rhs, dq, bcs))
            r_ref = np.asarray(poisson_residual(np.asarray(u_ref), rhs, dq, bcs))
            np.testing.assert_allclose(r_sm, r_ref, rtol=0, atol=1e-4)
        else:
            np.testing.assert_allclose(
                np.asarray(u_sm), np.asarray(u_ref), rtol=0, atol=1e-12
            )

    def test_mean_metric(self):
        from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

        n = 32
        bcs = (("D", "D"), ("D", "D"), ("D", "D"))
        x, U, rhs = self._problem(n, bcs)
        h = GridHierarchy.from_mesh((x, x, x))
        opts = Options(precision="fp64", smoother="masked", mean=True)
        u_ref, info_ref = PoissonBVP(h, bcs, opts).solve(np.zeros_like(U), rhs)
        sbvp = ShardedPoissonBVP(h, bcs, opts, mesh=make_mesh(8), min_rows_per_shard=2)
        u_sm, info_sm = sbvp.solve(np.zeros_like(U), rhs)
        assert info_sm.cycles == info_ref.cycles
        np.testing.assert_allclose(
            np.asarray(u_sm), np.asarray(u_ref), rtol=0, atol=1e-12
        )

    def test_direct_coarse_mode(self):
        from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

        n = 32
        bcs = (("D", "D"), ("N", "N"), ("D", "D"))
        x, U, rhs = self._problem(n, bcs)
        h = GridHierarchy.from_mesh((x, x, x))
        opts = Options(precision="fp64", smoother="masked", coarse_solver="direct")
        sbvp = ShardedPoissonBVP(h, bcs, opts, mesh=make_mesh(8), min_rows_per_shard=2)
        assert sbvp.coarse_direct
        u_sm, info = sbvp.solve(np.zeros_like(U), rhs)
        assert info.ierr == 0
        # direct coarse converges to the same limit
        u_ref, _ = PoissonBVP(h, bcs, opts).solve(np.zeros_like(U), rhs)
        np.testing.assert_allclose(
            np.asarray(u_sm), np.asarray(u_ref), rtol=0, atol=1e-11
        )

    def test_mixed_precision_sharded(self):
        """Sharded f32 V-cycles inside f64 defect correction converge to
        the fp64 single-device solution."""
        from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

        n = 32
        bcs = (("D", "D"), ("N", "N"), ("D", "D"))
        x, U, rhs = self._problem(n, bcs)
        h = GridHierarchy.from_mesh((x, x, x))
        u_ref, _ = PoissonBVP(h, bcs, Options(precision="fp64")).solve(
            np.zeros_like(U), rhs
        )
        sbvp = ShardedPoissonBVP(
            h, bcs, Options(precision="mixed"), mesh=make_mesh(8),
            min_rows_per_shard=2,
        )
        u_sm, info = sbvp.solve(np.zeros_like(U), rhs)
        assert info.ierr == 0
        np.testing.assert_allclose(
            np.asarray(u_sm), np.asarray(u_ref), rtol=0, atol=5e-11
        )

    def test_2d_sharded(self):
        """The shard_map engine is dimension-generic: 2D all-Neumann
        (chi-style) problem."""
        from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

        n = 48
        x = np.linspace(0, 1, n)
        X, Y = np.meshgrid(x, x, indexing="xy")
        U = np.cos(np.pi * X) * np.cos(np.pi * Y)
        rhs = -2 * np.pi**2 * U
        bcs = (("N", "N"), ("N", "N"))
        h = GridHierarchy.from_mesh((x, x))
        opts = Options(precision="fp64", smoother="masked")
        u_ref, iref = PoissonBVP(h, bcs, opts).solve(np.zeros_like(U), rhs)
        sbvp = ShardedPoissonBVP(
            h, bcs, opts, mesh=make_mesh(8), min_rows_per_shard=2
        )
        u_sm, ism = sbvp.solve(np.zeros_like(U), rhs)
        assert ism.ierr == 0
        a = np.asarray(u_sm) - np.asarray(u_sm).mean()
        b = np.asarray(u_ref) - np.asarray(u_ref).mean()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        err = np.abs(a - (U - U.mean())).max()
        assert err < 5e-3

    def test_compact_sharded_smoother(self):
        """The color-compact sharded smoother (default) matches the
        masked sharded path and the single-device engine."""
        from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

        n = 32
        bcs = (("D", "D"), ("N", "N"), ("D", "D"))
        x, U, rhs = self._problem(n, bcs)
        h = GridHierarchy.from_mesh((x, x, x))
        opts_c = Options(precision="fp64")           # compact (auto)
        opts_m = Options(precision="fp64", smoother="masked")
        mesh = make_mesh(8)
        u_c, info_c = ShardedPoissonBVP(
            h, bcs, opts_c, mesh=mesh, min_rows_per_shard=2
        ).solve(np.zeros_like(U), rhs)
        u_m, info_m = ShardedPoissonBVP(
            h, bcs, opts_m, mesh=mesh, min_rows_per_shard=2
        ).solve(np.zeros_like(U), rhs)
        assert info_c.ierr == 0
        assert info_c.cycles == info_m.cycles
        np.testing.assert_allclose(
            np.asarray(u_c), np.asarray(u_m), rtol=0, atol=1e-12
        )
        u_ref, _ = PoissonBVP(h, bcs, opts_m).solve(np.zeros_like(U), rhs)
        np.testing.assert_allclose(
            np.asarray(u_c), np.asarray(u_ref), rtol=0, atol=1e-12
        )

    def test_compact_sharded_odd_extent_all_neumann(self):
        """Compact sharded path with an odd last-axis extent (ghost
        columns) and the all-Neumann mean: still matches masked."""
        from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

        nz, nxy = 32, 27
        z = np.linspace(0, 1, nz)
        xy = np.linspace(0, 1, nxy)
        rng = np.random.default_rng(12)
        rhs = rng.standard_normal((nz, nxy, nxy))
        rhs -= rhs.mean()
        bcs = (("N", "N"), ("N", "N"), ("N", "N"))
        h = GridHierarchy.from_mesh((z, xy, xy), ngrids=3)
        mesh = make_mesh(8)
        opts_c = Options(precision="fp64", ncycles_max=3, vc_tol=1e-30)
        opts_m = Options(
            precision="fp64", ncycles_max=3, vc_tol=1e-30, smoother="masked"
        )
        u_c, _ = ShardedPoissonBVP(
            h, bcs, opts_c, mesh=mesh, min_rows_per_shard=2
        ).solve(np.zeros((nz, nxy, nxy)), rhs)
        u_m, _ = ShardedPoissonBVP(
            h, bcs, opts_m, mesh=mesh, min_rows_per_shard=2
        ).solve(np.zeros((nz, nxy, nxy)), rhs)
        np.testing.assert_allclose(
            np.asarray(u_c), np.asarray(u_m), rtol=0, atol=1e-11
        )

    def test_two_axis_explicit_engine(self):
        """(z, y) two-axis decomposition over a 4x2 mesh in the explicit
        shard_map engine, fp64 and mixed, vs single-device."""
        from ndsm_tpu.parallel.shard import make_mesh_nd
        from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

        n = 32
        bcs = (("D", "D"), ("N", "N"), ("D", "D"))
        x, U, rhs = self._problem(n, bcs)
        h = GridHierarchy.from_mesh((x, x, x))
        mesh = make_mesh_nd((4, 2), ("z", "y"))
        u_ref, info_ref = PoissonBVP(
            h, bcs, Options(precision="fp64")
        ).solve(np.zeros_like(U), rhs)
        sbvp = ShardedPoissonBVP(
            h, bcs, Options(precision="fp64"), mesh=mesh,
            axis_names=("z", "y"), min_rows_per_shard=2,
        )
        assert sbvp.seam >= 2
        u_sm, info = sbvp.solve(np.zeros_like(U), rhs)
        assert info.ierr == 0
        assert info.cycles == info_ref.cycles
        np.testing.assert_allclose(
            np.asarray(u_sm), np.asarray(u_ref), rtol=0, atol=1e-11
        )
        # mixed precision on the 2-axis mesh
        sbvp_m = ShardedPoissonBVP(
            h, bcs, Options(precision="mixed"), mesh=mesh,
            axis_names=("z", "y"), min_rows_per_shard=2,
        )
        u_mx, info_mx = sbvp_m.solve(np.zeros_like(U), rhs)
        assert info_mx.ierr == 0
        np.testing.assert_allclose(
            np.asarray(u_mx), np.asarray(u_ref), rtol=0, atol=5e-11
        )


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
def test_sharded_solve_batch_matches_sequential(precision):
    """ShardedPoissonBVP.solve_batch (lane axis in front of the shard
    axes): per-lane cycles and iterates equal the standalone sharded
    solves — the distributed chi-face batching contract.  Covers the 2D
    all-Neumann chi configuration and a mixed-BC lane set."""
    from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

    mesh = make_mesh(4)
    n = 24
    x = np.linspace(0, 1, n)
    h = GridHierarchy.from_mesh((x, x))
    bcs = (("N", "N"), ("N", "N"))
    opts = Options(precision=precision, vc_tol=1e-8, ncycles_max=60)
    sbvp = ShardedPoissonBVP(h, bcs, opts, mesh=mesh, min_rows_per_shard=2)
    rng = np.random.default_rng(8)
    rhss = []
    for k in range(3):
        r = rng.standard_normal((n, n))
        rhss.append(r - r.mean())  # compatible all-Neumann rhs
    u0s = [np.zeros((n, n))] * 3
    us_b, infos_b = sbvp.solve_batch(u0s, rhss, names=["a", "b", "c"])
    for k in range(3):
        u_s, info_s = sbvp.solve(u0s[k], rhss[k])
        assert infos_b[k].ierr == 0
        assert infos_b[k].cycles == info_s.cycles
        assert infos_b[k].batch_size == 3
        # vmapped tensordot/matmul reduce in a different order than the
        # unbatched ops -> ulp-level drift only (f64 ~1e-17; the mixed
        # mode's f32 inner cycles drift at f32 ulp of the corrections,
        # observed ~2e-11); sequences stay in lockstep (cycle counts
        # asserted exact above).
        atol = 1e-14 if precision == "fp64" else 1e-9
        np.testing.assert_allclose(
            np.asarray(us_b[k]), np.asarray(u_s), rtol=0, atol=atol
        )


def test_distributed_vector_potential():
    """The full vector-potential pipeline on the explicit shard_map
    engine matches the single-device pipeline."""
    from ndsm_tpu import vector_potential
    from ndsm_tpu.parallel.shard import DistConfig
    from ndsm_tpu.utils.testing import potential_field_case

    n = 16
    x = np.linspace(0, 1, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    _, b1 = potential_field_case(X, Y, Z)
    opts = Options(precision="fp64")
    i_ref, A_ref, B_ref = vector_potential(x, x, x, b1.copy(), options=opts)
    dist = DistConfig(mesh=make_mesh(4), axis_names=("z",), min_rows_per_shard=2)
    i_d, A_d, B_d = vector_potential(x, x, x, b1.copy(), options=opts, dist=dist)
    assert i_d == 0 and i_ref == 0
    np.testing.assert_allclose(A_d, A_ref, rtol=0, atol=1e-8)
    np.testing.assert_allclose(B_d, B_ref, rtol=0, atol=1e-7)


def test_sharded_zero_rhs_donate_output_dtype():
    """ShardedPoissonBVP feature parity with the single-device solve:
    zero_rhs materializes the RHS in-program, donate invalidates inputs
    without changing results, output_dtype casts on device."""
    from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

    mesh = make_mesh(4)
    n = 16
    x = np.linspace(0, 1, n)
    h = GridHierarchy.from_mesh((x, x, x), ngrids=2)
    bcs = (("N", "N"), ("D", "D"), ("D", "D"))
    opts = Options(precision="mixed", vc_tol=1e-8, ncycles_max=40)
    sbvp = ShardedPoissonBVP(h, bcs, opts, mesh=mesh, min_rows_per_shard=2)
    u0 = np.zeros((n, n, n))
    u0[:, 0, :] = 1.0  # inhomogeneous Dirichlet data carried in u0
    u_a, ia = sbvp.solve(u0, np.zeros_like(u0))
    u_b, ib = sbvp.solve(u0, None, zero_rhs=True)
    np.testing.assert_array_equal(np.asarray(u_a), np.asarray(u_b))
    assert ia.cycles == ib.cycles
    # donate: same result; the donated device buffer must not be reused
    u_c, ic = sbvp.solve(u0, None, zero_rhs=True, donate=True)
    np.testing.assert_array_equal(np.asarray(u_a), np.asarray(u_c))
    # output_dtype: on-device downcast
    u_d, _ = sbvp.solve(u0, None, zero_rhs=True, output_dtype="float32")
    assert u_d.dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(u_d), np.asarray(u_a).astype(np.float32), rtol=0, atol=0
    )


def test_gspmd_checkpointed_resume_bitwise(tmp_path):
    """solve_checkpointed on a GSPMD-sharded BVP (the 512^3 north-star
    kill-and-resume configuration, scripts/multihost_512.py, scaled
    down): an interrupted run resumed from its checkpoint reaches a
    BITWISE-identical final iterate to the uninterrupted run."""
    from ndsm_tpu.parallel.shard import ShardSpec

    n = 32
    x = np.linspace(0, 1, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"), ("N", "N"), ("D", "D"))
    spec = ShardSpec(mesh=make_mesh(8), min_rows_per_shard=2)
    opts = Options(precision="mixed", vc_tol=1e-30, niterex_max=40)
    bvp = PoissonBVP(h, bcs, opts, shard_spec=spec)
    rng = np.random.default_rng(11)
    rhs = rng.standard_normal((n, n, n))
    u0 = np.zeros((n, n, n))

    from ndsm_tpu.utils.msgs import suppress_warnings

    ck = str(tmp_path / "ck.npz")
    with suppress_warnings():  # capped cycles: covfail is expected
        # "interrupted" run: budget exhausted after 2 cycles, state on disk
        bvp.solve_checkpointed(
            u0, rhs, checkpoint_path=ck, checkpoint_every=1, ncycles_max=2
        )
        # resume to the full budget
        u_res, i_res = bvp.solve_checkpointed(
            u0, rhs, checkpoint_path=ck, checkpoint_every=1, ncycles_max=5
        )
        # uninterrupted reference
        ck2 = str(tmp_path / "ck2.npz")
        u_full, i_full = bvp.solve_checkpointed(
            u0, rhs, checkpoint_path=ck2, checkpoint_every=1, ncycles_max=5
        )
    assert i_res.cycles == i_full.cycles == 5
    assert np.array_equal(np.asarray(u_res), np.asarray(u_full))


def test_sharded_engine_checkpointed_resume(tmp_path):
    """ShardedPoissonBVP.solve_checkpointed (explicit shard_map engine):
    interrupt + resume is bitwise the uninterrupted run, and the final
    iterate matches the strict-mode plain solve."""
    import dataclasses

    from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP
    from ndsm_tpu.utils.msgs import suppress_warnings

    n = 32
    x = np.linspace(0, 1, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "D"), ("N", "N"), ("D", "D"))
    opts = Options(precision="mixed", vc_tol=1e-8)
    sb = ShardedPoissonBVP(h, bcs, opts, mesh=make_mesh(8), min_rows_per_shard=2)
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((n, n, n))
    u0 = np.zeros((n, n, n))

    ck = str(tmp_path / "sck.npz")
    with suppress_warnings():
        # interrupted: cap the budget to 3 cycles via a sibling with
        # small ncycles_max (same strict iterate sequence)
        sb_short = ShardedPoissonBVP(
            h, bcs, dataclasses.replace(opts, ncycles_max=3),
            mesh=make_mesh(8), min_rows_per_shard=2,
        )
        sb_short.solve_checkpointed(
            u0, rhs, checkpoint_path=ck, checkpoint_every=1
        )
        # resume to convergence from the cycle-3 state
        u_res, i_res = sb.solve_checkpointed(
            u0, rhs, checkpoint_path=ck, checkpoint_every=2
        )
        # uninterrupted
        ck2 = str(tmp_path / "sck2.npz")
        u_full, i_full = sb.solve_checkpointed(
            u0, rhs, checkpoint_path=ck2, checkpoint_every=4
        )
    assert i_res.ierr == 0 and i_full.ierr == 0
    assert i_res.cycles == i_full.cycles
    assert np.array_equal(np.asarray(u_res), np.asarray(u_full))
    # matches the plain strict solve too
    strict = sb._strict_sibling()
    u_ref, i_ref = strict.solve(u0, rhs)
    assert i_ref.cycles == i_full.cycles
    assert np.array_equal(np.asarray(u_full), np.asarray(u_ref))
