"""Device-mesh helpers for the (batch, horizon) 2-D solver mesh.

The reference has zero parallelism (SURVEY.md §2.3); this framework's
distribution model is: ``batch`` axis = embarrassingly-parallel independent
QPs (DP analogue), ``horizon`` axis = block-tridiagonal Schur-complement
partitioning of long trajectories (TP/SP analogue).  The cards of one host
are joined all to all (NVLink), so no device order is better than another:
the mesh shape follows the algorithm alone — all cards on ``batch`` for a
fleet, all on ``horizon`` for one long trajectory.  Every mesh position
holds a distinct device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

BATCH_AXIS = "batch"
HORIZON_AXIS = "horizon"


def make_mesh(
    batch: Optional[int] = None,
    horizon: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Create a ``(batch, horizon)`` mesh over the available devices.

    ``batch=None`` uses all remaining devices on the batch axis.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if batch is None:
        assert n % horizon == 0, (n, horizon)
        batch = n // horizon
    assert batch * horizon <= n, f"mesh {batch}x{horizon} > {n} devices"
    assert len(set(devs)) == n, "devices must be distinct"
    grid = np.asarray(devs[: batch * horizon]).reshape(batch, horizon)
    return Mesh(grid, (BATCH_AXIS, HORIZON_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for arrays with a leading problem-batch axis."""
    return NamedSharding(mesh, PartitionSpec(BATCH_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
