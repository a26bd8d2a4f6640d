"""Multi-process CPU validation worker (run via ``python -m
ndsm_tpu.parallel._mh_worker``) — one process of the two-level
host-outer/device-inner mesh dry run.

Env: NDSM_MH_COORD (host:port), NDSM_MH_NPROC, NDSM_MH_PID,
NDSM_MH_NDEV (virtual CPU devices per process).  Each process runs the
SAME sharded solve over a (nproc, ndev) mesh — z partitioned across
processes (the host network's stand-in), y across each process's
devices — and process 0 prints ``MH_CHECKSUM <sum> <cycles>`` for the
parent to compare against the single-process result.
"""

import os
import sys


def main() -> None:
    nproc = int(os.environ["NDSM_MH_NPROC"])
    pid = int(os.environ["NDSM_MH_PID"])
    ndev = int(os.environ["NDSM_MH_NDEV"])
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={ndev}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=os.environ["NDSM_MH_COORD"],
        num_processes=nproc,
        process_id=pid,
        cluster_detection_method="deactivate",
    )

    import numpy as np

    from ndsm_tpu import GridHierarchy, Options
    from ndsm_tpu.parallel.multihost import make_multihost_mesh
    from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

    assert jax.process_count() == nproc
    mesh = make_multihost_mesh(("z", "y"))
    assert mesh.devices.shape == (nproc, ndev), mesh.devices.shape

    # Size/depth/cycle knobs (defaults = the dryrun's tiny problem;
    # scripts/multihost_512.py drives the 512^3 configuration through
    # the same worker).
    size = os.environ.get("NDSM_MH_SIZE")
    if size:
        nz, ny, nx = (int(v) for v in size.split(","))
    else:
        nz, ny, nx = 8 * nproc, 8 * ndev, 20
    ngrids = int(os.environ.get("NDSM_MH_NGRIDS", "2")) or None
    ncycles = int(os.environ.get("NDSM_MH_CYCLES", "3"))
    z = np.linspace(0.0, 1.0, nz)
    y = np.linspace(0.0, 1.0, ny)
    x = np.linspace(0.0, 1.0, nx)
    h = GridHierarchy.from_mesh((z, y, x), ngrids=ngrids)
    sbvp = ShardedPoissonBVP(
        h,
        (("D", "D"), ("N", "N"), ("D", "D")),
        Options(precision="mixed", ncycles_max=ncycles, vc_tol=1e-30, niterex_max=40, mixed_inner_max=1),
        mesh=mesh,
        axis_names=("z", "y"),
        min_rows_per_shard=2,
    )
    rng = np.random.default_rng(7)
    u0 = np.zeros((nz, ny, nx))
    rhs = rng.standard_normal((nz, ny, nx))
    ck = os.environ.get("NDSM_MH_CKPT")
    if ck:
        # exercise the multihost branch of solve_checkpointed
        # (process-0 allgather write; shared-filesystem resume)
        u, info = sbvp.solve_checkpointed(
            u0, rhs, checkpoint_path=ck, checkpoint_every=1
        )
    else:
        u, info = sbvp.solve(u0, rhs)
    # Checksum via a replicated reduction every process can compute.
    import jax.numpy as jnp

    s = float(jnp.sum(jnp.abs(u)))
    if pid == 0:
        print(f"MH_CHECKSUM {s:.12e} {info.cycles}", flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
    sys.exit(0)
