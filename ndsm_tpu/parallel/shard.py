"""Spatial domain decomposition over a JAX device mesh.

The reference's only parallel substrate is shared-memory OpenMP inside one
node (SURVEY.md §2); distribution is a new, first-class layer here.  The
grid is block-partitioned along one array axis over the device mesh; every
level above a size threshold is sharded, and coarse levels below it are
replicated so the latency-bound coarse solve never pays collective costs
(BASELINE.json north star).

Two mechanisms are provided:

  * ``ShardSpec`` + GSPMD sharding constraints (this module): the whole
    V-cycle program is annotated per level and XLA inserts the halo
    exchanges / collectives.  This is the default multi-chip path: the
    stencil's shifted-slice reads become 1-deep halo transfers between devices,
    reductions become cross-shard collectives, and the sharded<->replicated
    seam at the threshold level becomes a gather/slice pair.
  * ``ndsm_tpu.parallel.sm_engine``: an explicit shard_map + ppermute
    formulation of the whole solver (hand-placed halos/collectives) for
    cases where manual communication placement beats the XLA-chosen
    schedule; its single-level building blocks are exported as
    ``make_sharded_sweep`` / ``make_sharded_residual``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["ShardSpec", "DistConfig", "make_mesh", "make_mesh_nd"]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "z") -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def make_mesh_nd(shape: Sequence[int], axis_names: Sequence[str] = ("z", "y")) -> Mesh:
    """N-D device mesh, e.g. make_mesh_nd((4, 2)) for a 4x2 (z, y)
    decomposition over 8 devices."""
    n = int(np.prod(shape))
    devs = np.array(jax.devices()[:n]).reshape(shape)
    return Mesh(devs, tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Distribution request for the high-level pipelines: run every
    sub-solve on the explicit shard_map engine over ``mesh`` with the
    leading array axes partitioned per ``axis_names`` (sub-problems whose
    shapes cannot be partitioned fall back to the single-device path)."""

    mesh: Mesh
    axis_names: Tuple[str, ...] = ("z",)
    min_rows_per_shard: int = 4

    def __hash__(self):
        return hash(
            (
                tuple(self.mesh.devices.flat),
                self.mesh.axis_names,
                self.axis_names,
                self.min_rows_per_shard,
            )
        )


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How to partition solver arrays over a device mesh.

    Attributes:
      mesh: the device mesh.
      axis: array axis to block-partition (default 0 — the slowest-varying
        axis, "z" for (nz, ny, nx) volumes).
      axis_name: mesh axis name.
      min_rows_per_shard: a level is sharded only if its partitioned-axis
        extent is at least ``n_devices * min_rows_per_shard``; smaller
        (coarse) levels are replicated.
    """

    mesh: Mesh
    axis: int = 0
    axis_name: str = "z"
    min_rows_per_shard: int = 8
    #: Additional (array_axis, mesh_axis_name) pairs for multi-axis
    #: decomposition, e.g. extra_axes=((1, "y"),) with a 2-D mesh.
    extra_axes: Tuple[Tuple[int, str], ...] = ()

    @property
    def n_devices(self) -> int:
        return self.mesh.shape[self.axis_name]

    def partitioned_axes(self) -> Tuple[Tuple[int, str], ...]:
        return ((self.axis, self.axis_name),) + tuple(self.extra_axes)

    def is_sharded_level(self, shape: Sequence[int]) -> bool:
        return shape[self.axis] >= self.n_devices * self.min_rows_per_shard

    def sharding_for(self, shape: Sequence[int]) -> NamedSharding:
        parts: list = [None] * len(shape)
        for ax, name in self.partitioned_axes():
            ndev = self.mesh.shape[name]
            if shape[ax] >= ndev * self.min_rows_per_shard:
                parts[ax] = name
        return NamedSharding(self.mesh, P(*parts))

    def constrain(self, x: jax.Array) -> jax.Array:
        return lax.with_sharding_constraint(x, self.sharding_for(x.shape))

    def put(self, x) -> jax.Array:
        return jax.device_put(x, self.sharding_for(x.shape))

    def __hash__(self):
        return hash(
            (
                tuple(self.mesh.devices.flat),
                self.mesh.axis_names,
                self.axis,
                self.axis_name,
                self.min_rows_per_shard,
                self.extra_axes,
            )
        )

    def __eq__(self, other):
        if not isinstance(other, ShardSpec):
            return NotImplemented
        return (
            tuple(self.mesh.devices.flat) == tuple(other.mesh.devices.flat)
            and self.mesh.axis_names == other.mesh.axis_names
            and self.axis == other.axis
            and self.axis_name == other.axis_name
            and self.min_rows_per_shard == other.min_rows_per_shard
            and self.extra_axes == other.extra_axes
        )
