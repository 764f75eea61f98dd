"""Trajectory objective and warm-start helpers.

JAX-native equivalents of ``triDiagonalMatrix`` and ``linspace``
(``/root/reference/src/utils.h:50-64, 72-82``) plus the planner's warm start
(``/root/reference/src/gomp-solver.h:105-116``).  Dense variants are numpy
(host-side problem setup); jnp variants are provided for on-device use.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def tri_diagonal_matrix(
    a: float, b: float, n: int, offset: int = 0, diagonal_num: int = 1
) -> np.ndarray:
    """Dense mirror of ``triDiagonalMatrix`` (``utils.h:50-64``).

    Rows/cols ``i < offset`` are zero; for ``i >= offset``: ``M[i,i] = a``,
    ``M[i, i±diagonal_num] = b`` (upper written when ``i+diag < n``, lower when
    ``i-diag >= offset``).
    """
    m = np.zeros((n, n), dtype=np.float64)
    for i in range(offset, n):
        m[i, i] = a
        if i + diagonal_num < n:
            m[i, i + diagonal_num] = b
        if i - diagonal_num >= offset:
            m[i, i - diagonal_num] = b
    return m


def smoothness_objective(waypoints: int, n_dim: int) -> np.ndarray:
    """The GOMP objective ``P`` used by the planner (``gomp-solver.h:61-64``):
    ``triDiagonalMatrix(2, -1, 2*W*N, offset=W*N, diag=N)`` — a block
    Laplacian on the velocity half, i.e. ``x'Px ≈ Σ_t ||v_{t+1} - v_t||² +
    boundary terms`` (minimum squared acceleration)."""
    n = 2 * waypoints * n_dim
    return tri_diagonal_matrix(2.0, -1.0, n, offset=waypoints * n_dim, diagonal_num=n_dim)


def linspace_configs(a, b, n_steps: int) -> np.ndarray:
    """Flat ``(n_steps*N,)`` linear interpolation from ``a`` to ``b``
    (``utils.h:72-82``)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    step = (b - a) / (n_steps - 1)
    out = a[None, :] + step[None, :] * np.arange(n_steps)[:, None]
    return out.reshape(-1)


def calc_warm_start(start_pos, end_pos, waypoints: int) -> np.ndarray:
    """Planner warm start (``gomp-solver.h:105-116``): linspace positions +
    zero velocities, flat ``(2*W*N,)``."""
    positions = linspace_configs(start_pos, end_pos, waypoints)
    return np.concatenate([positions, np.zeros_like(positions)])


def calc_warm_start_jnp(start_pos, end_pos, waypoints: int):
    """jnp version of :func:`calc_warm_start` for batched/on-device use."""
    a = jnp.asarray(start_pos)
    b = jnp.asarray(end_pos)
    frac = jnp.arange(waypoints, dtype=a.dtype) / (waypoints - 1)
    positions = (a[None, :] + frac[:, None] * (b - a)[None, :]).reshape(-1)
    return jnp.concatenate([positions, jnp.zeros_like(positions)])


def map_joint_trajectory_to_xyz(trajectory, fk, n_dim: int):
    """FK-map the position half of a flat trajectory to ``(W, 3)`` points
    (``utils.h:84-96``, minus the printf spew).  ``fk`` must be vmappable."""
    import jax

    traj = jnp.asarray(trajectory)
    waypoints = traj.shape[-1] // (2 * n_dim)
    q = traj[..., : waypoints * n_dim].reshape(*traj.shape[:-1], waypoints, n_dim)
    return jax.vmap(fk)(q.reshape(-1, n_dim)).reshape(*traj.shape[:-1], waypoints, 3)


def calc_warm_start_masked(start_pos, end_pos, w_max: int, w_active):
    """Pad-to-max warm start: linspace over the first ``w_active`` waypoints
    (traced scalar), clamped at the end configuration beyond — the padded
    equivalent of ``calcWarmStart`` (``gomp-solver.h:105-116``)."""
    a = jnp.asarray(start_pos)
    b = jnp.asarray(end_pos)
    wa = jnp.asarray(w_active, jnp.int32)
    t = jnp.arange(w_max, dtype=a.dtype)
    denom = jnp.maximum(wa - 1, 1).astype(a.dtype)
    frac = jnp.minimum(t, wa.astype(a.dtype) - 1) / denom
    positions = (a[None, :] + frac[:, None] * (b - a)[None, :]).reshape(-1)
    return jnp.concatenate([positions, jnp.zeros_like(positions)])
