"""Long-horizon trajectory QPs with chunk-partitioned KKT solves.

BASELINE config 5: a single 10k-step trajectory QP whose banded KKT system is
partitioned along the horizon (SURVEY.md §5 "sequence parallelism").  The
ADMM loop itself is cheap at these sizes (vector ops are O(n)); the KKT
factor/solve dominates, so this container swaps the sequential scan solver
for the Schur-complement chunked factorization in
:mod:`osqp_solver_tpu.parallel.schur`:

* ``kkt_factor``  → per-chunk interior block-Cholesky (vmapped over the
  chunk axis — data-parallel across chunks) + the factored (K-1)-separator
  reduced system, cached across ADMM iterations;
* ``kkt_solve``   → chunk-local substitution + tiny reduced solve.

On a real mesh, placing the chunk axis on devices via
``jax.sharding.NamedSharding`` (or the explicit ``shard_map`` path
``schur.schur_solve_sharded``) distributes the interior work; the math here
is bit-identical to the sharded kernels by construction (tests pin this).
"""
from __future__ import annotations

import jax.numpy as jnp
from .. import struct

from ..gomp.trajectory_qp import TrajectoryQP
from .schur import schur_factor, schur_solve_cached


@struct.dataclass
class ChunkedTrajectoryQP(TrajectoryQP):
    """TrajectoryQP whose reduced KKT is factored/solved in ``n_chunks``
    horizon chunks (Schur complement) instead of one sequential scan."""

    n_chunks: int = struct.field(pytree_node=False, default=2)

    def kkt_factor(self, rho_vec, sigma):
        diag, lower = self.kkt_blocks(rho_vec, sigma)
        return schur_factor(diag, lower, self.n_chunks)

    def kkt_solve(self, factor, rhs):
        s = schur_solve_cached(factor, self._interleave(rhs))
        return self._deinterleave(s)


def auto_chunks(waypoints: int) -> int:
    """Chunk-count policy for single-device long horizons.

    The sequential block-tridiagonal scan is a chain of tiny latency-bound
    B×B steps on an accelerator; interiors of ~150-300 waypoints balance
    the chunk vmap width against the reduced-system size.  Short horizons
    keep the scan (the redundancy isn't paid back below a few hundred
    waypoints).  The policy's constants are not yet measured on a GPU
    (benchmarks/long_horizon.py measures them)."""
    if waypoints < 512:
        return 1
    return max(2, min(128, waypoints // 160))


def as_chunked(qp: TrajectoryQP, n_chunks: int | None = None) -> ChunkedTrajectoryQP:
    """Re-wrap a :class:`TrajectoryQP` for chunk-partitioned KKT solves.

    ``n_chunks=None`` applies :func:`auto_chunks`."""
    if n_chunks is None:
        n_chunks = auto_chunks(qp.waypoints)
    if int(n_chunks) <= 1:
        # One chunk IS the sequential scan — keep the plain container
        # (schur's reduced system would be empty).
        return qp
    fields = {
        name: getattr(qp, name)
        for name in TrajectoryQP.__dataclass_fields__  # noqa: SLF001
    }
    return ChunkedTrajectoryQP(n_chunks=int(n_chunks), **fields)


# ---------------------------------------------------------------------------
# Fully distributed ADMM: state, data, and KKT sharded over the horizon axis
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from ..ops import admm as admm_mod  # noqa: E402
from .banded import (  # noqa: E402
    banded_from_trajectory,
    deinterleave_state,
    interleave_state,
    solve_banded_sharded,
)
from .mesh import HORIZON_AXIS  # noqa: E402


def solve_horizon_sharded(
    qp: TrajectoryQP,
    mesh: Mesh,
    settings: admm_mod.Settings = admm_mod.Settings(),
    warm_x=None,
    axis: str = HORIZON_AXIS,
    local_chunks: int = 1,
) -> admm_mod.SolveResult:
    """Run the full OSQP-semantics ADMM for ONE long-horizon trajectory QP
    with *everything* — vector state, problem data, KKT factor/solve —
    sharded over ``mesh[axis]`` (the separator-only redesign, VERDICT r1
    next #3; implementation in :mod:`osqp_solver_tpu.parallel.banded`).

    Per ADMM iteration each device exchanges one ``(2N,)`` halo with each
    neighbour (``ppermute``) and ``(K, 2N)`` separator right-hand sides
    (``all_gather``); residual norms reduce as scalars.  No collective
    payload scales with the horizon length (pinned by
    ``tests/test_banded.py::test_sharded_communication_is_separator_only``).

    Accepts/returns the reference ``[q..., v...]`` layout; duals map back
    through the banded row permutation.
    """
    W, N = qp.waypoints, qp.n_dim
    banded, row_map = banded_from_trajectory(qp)
    warm_int = (
        interleave_state(jnp.asarray(warm_x, banded.q_wb.dtype), W, N)
        if warm_x is not None
        else None
    )
    res = solve_banded_sharded(banded, mesh, settings, warm_x=warm_int, axis=axis,
                               local_chunks=local_chunks)
    rm = jnp.asarray(np.asarray(row_map))
    return res.replace(
        x=deinterleave_state(res.x, W, N),
        y=res.y[rm],
        z=res.z[rm],
    )
