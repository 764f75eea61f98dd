"""Batch-parallel solver: vmapped ADMM sharded over the mesh batch axis.

The scale-out of the reference's one-``QPSolver``-per-problem
pattern (``gomp-solver.h:61-64``; SURVEY.md §2.3 "batch parallelism"):
problems are independent, so the batch axis shards across chips/hosts with
``shard_map`` — each device runs its own masked-convergence while-loop over
its shard (no cross-device sync inside the solve; this is why ``shard_map``
is used rather than jit-auto-sharding, which would globalize the
loop-termination reduction).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import admm
from .mesh import BATCH_AXIS


def solve_batch(qps, settings: admm.Settings = admm.Settings(), warm_x=None):
    """Solve a leading-axis batch of QPs (single device / auto-sharded) via
    :func:`osqp_solver_tpu.ops.admm.solve_batched` — per-problem adaptive ρ
    with the refactorization guarded by a batch-level scalar."""
    return admm.solve_batched(qps, settings, warm_x=warm_x)


@functools.lru_cache(maxsize=64)
def _sharded_batch_fn(mesh: Mesh, settings, axis: str):
    """Cached jitted shard_map program (repeated solves must not re-trace)."""
    vsolve = lambda qps_shard: admm.solve_batched(qps_shard, settings)
    spec = P(axis)
    fn = jax.shard_map(
        vsolve,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
        check_vma=False,
    )
    return jax.jit(fn)


def solve_batch_sharded(
    qps,
    mesh: Mesh,
    settings: admm.Settings = admm.Settings(),
    axis: str = BATCH_AXIS,
):
    """Shard the problem batch across ``mesh[axis]`` and solve.

    The batch size must divide by the axis size.  Per-device shards converge
    independently (device-local while loops) — near-linear scaling since no
    collectives are emitted inside the solve.
    """
    return _sharded_batch_fn(mesh, settings, axis)(qps)
