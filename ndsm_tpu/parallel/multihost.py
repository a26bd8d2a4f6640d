"""Multi-host (multi-process) distribution: host-outer / device-inner meshes.

The reference is strictly single-node shared-memory (OpenMP,
README.md:100-103); this layer scales the solver across devices and
hosts (BASELINE config 5: 1024^3 vector-potential solve).  Layout:

  * array axis 0 (z) is partitioned across HOSTS — its 1-plane-deep halo
    exchanges are the only traffic that crosses the data-center network,
    a few MB per sweep at 1024^3;
  * array axis 1 (y) is partitioned across the devices within each host,
    so the per-sweep halo volume rides the host's device interconnect;
  * coarse levels below the threshold are replicated per device as in the
    single-host engine (the latency-bound coarse solve never touches any
    network).

Run ``init_distributed()`` once per process, build the mesh with
``make_multihost_mesh()``, and pass ``DistConfig(mesh, ("z", "y"))`` to
``compute_vector_potential`` / ``ShardedPoissonBVP`` as usual — the
engine code is identical; only mesh construction and global-array
feeding (``put_global``) differ.  See docs/MULTIHOST.md for the 1024^3
recipe, and __graft_entry__.dryrun_multichip for the multi-process CPU
validation of this path.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init_distributed", "make_multihost_mesh", "put_global"]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from arguments or the standard
    environment (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID).  Idempotent."""
    if jax.process_count() > 1:
        return  # already initialized
    kw = {}
    if coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kw["coordinator_address"] = coordinator_address or os.environ.get(
            "JAX_COORDINATOR_ADDRESS"
        )
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = int(
            num_processes or os.environ["JAX_NUM_PROCESSES"]
        )
    if process_id is not None or os.environ.get("JAX_PROCESS_ID") is not None:
        kw["process_id"] = int(
            process_id if process_id is not None else os.environ["JAX_PROCESS_ID"]
        )
    if not kw and jax.default_backend() == "cpu":
        return  # single-process CPU run: nothing to do
    jax.distributed.initialize(**kw)


def make_multihost_mesh(
    axis_names: Sequence[str] = ("z", "y"),
    per_host: Optional[int] = None,
) -> Mesh:
    """(n_hosts, devices_per_host) device mesh with the HOST axis first:
    partitioning array axis 0 over ``axis_names[0]`` puts only z-plane
    halos on the host network while axis 1's halos stay on each host's
    device interconnect.

    ``per_host`` overrides devices-per-host (defaults to the uniform local
    device count).  For a single process this degenerates to a (1, n)
    mesh — same program, no cross-host axis."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_proc = jax.process_count()
    if per_host is None:
        per_host = len(devs) // n_proc
    arr = np.array(devs).reshape(n_proc, per_host)
    return Mesh(arr, tuple(axis_names))


def put_global(x, sharding: NamedSharding) -> jax.Array:
    """Create a (possibly multi-host) global array from host data.

    Each process passes the FULL logical array (or anything indexable by
    global slices — e.g. a np.memmap for 1024^3 inputs); only the shards
    addressable by this process are materialized on its devices.  In a
    single-process run this is jax.device_put."""
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    x = np.asarray(x)
    return jax.make_array_from_callback(
        x.shape, sharding, lambda idx: np.ascontiguousarray(x[idx])
    )
