#!/usr/bin/env python3
"""Single-shard overhead of the explicit shard_map engine: run ShardedPoissonBVP on a 1-device mesh on the accelerator vs
the plain MGEngine path at the same size, warm, device-resident.

The ratio bounds the per-shard cost the multi-device projection rests on
(halo plumbing, per-shard transfer blocks, replication seam) with zero
actual communication — target <10% overhead.

Usage:  python3 scripts/perf_shard1.py [N ...]   (default: 256)
Env: NDSM_PERF_REPS (3).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPS = int(os.environ.get("NDSM_PERF_REPS", "3"))


def _timed(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return out, min(ts)


def main(sizes):
    from ndsm_tpu import GridHierarchy, Options
    from ndsm_tpu.mg.poisson import PoissonBVP
    from ndsm_tpu.parallel.shard import make_mesh
    from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

    mesh = make_mesh(1)
    rng = np.random.default_rng(3)
    for n in sizes:
        print(f"== single-shard overhead, {n}^3 mixed ==", flush=True)
        x = np.linspace(0, 1, n)
        h = GridHierarchy.from_mesh((x, x, x))
        bcs = (("N", "N"), ("D", "D"), ("D", "D"))
        opts = Options(precision="mixed")
        u0_np = np.zeros((n, n, n))
        u0_np[0] = rng.standard_normal((n, n))
        u0_np[-1] = rng.standard_normal((n, n))

        u0 = jnp.asarray(u0_np)  # pre-upload: keep the transfer out of dt
        bvp = PoissonBVP(h, bcs, opts)
        (_, info_p), dt_p = _timed(
            lambda: bvp.solve(u0, None, zero_rhs=True)
        )
        print(
            f"  MGEngine          : {dt_p*1e3:9.2f} ms  cycles={info_p.cycles} "
            f"du={info_p.du_last:.2e}",
            flush=True,
        )

        sbvp = ShardedPoissonBVP(
            h, bcs, opts, mesh=mesh, axis_names=("z",), min_rows_per_shard=2
        )
        (_, info_s), dt_s = _timed(
            lambda: sbvp.solve(u0, None, zero_rhs=True)
        )
        print(
            f"  ShardedPoissonBVP : {dt_s*1e3:9.2f} ms  cycles={info_s.cycles} "
            f"du={info_s.du_last:.2e}",
            flush=True,
        )
        print(
            f"  single-shard overhead: {dt_s/dt_p:.3f}x "
            f"(cycle parity: {info_s.cycles == info_p.cycles})",
            flush=True,
        )


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [256])
