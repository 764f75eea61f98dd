"""Dense constraint assembly with the reference's fluent API.

Host-side (numpy) re-design of
``/root/reference/src/constraints/constraint-builder.h`` (285 LoC).  The
reference accumulates Eigen triplets into a sparse CSC matrix; a batched accelerator solver
wants fixed shapes and direct indexing, so this builder writes straight into a
dense ``(n_rows, n_vars)`` array whose row/column layout is fixed by
:class:`~osqp_solver_tpu.gomp.layout.TrajectoryLayout`.  The reference's
"dummy constraint" trick for keeping the sparsity pattern fixed across SCP
iterations (``constraint-builder.h:108-117``) is subsumed by the fact that our
shapes never change at all.

This dense builder is the *test and small-problem* path (it mirrors the
reference unit-test surface, ``/root/reference/tests/test.cpp``).  The hot SCP
path uses the structured, jit-compiled assembly in
:mod:`osqp_solver_tpu.gomp.trajectory_qp`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .constraints import Constraint, INF, is_loose
from .geometry import HorizontalLine
from .layout import TrajectoryLayout, make_layout
from ..models.robot import RobotBall

# <lower_bounds, constraint_matrix, upper_bounds> — mirror of QPConstraints
# (constraint-builder.h:16); dense here.
QPConstraints = Tuple[np.ndarray, np.ndarray, np.ndarray]


class ConstraintBuilder:
    """Fluent builder for the trajectory QP's ``(l, A, u)``.

    Mirrors ``ConstraintBuilder<N_DIM>`` (``constraint-builder.h:19-151``):
    the constructor immediately appends the dynamics-linking rows
    ``v_t - q_{t+1} + q_t = 0`` and pre-allocates all remaining rows with
    ``(-INF, INF)`` bounds.
    """

    def __init__(
        self,
        waypoints: int,
        n_dim: int,
        balls: Sequence[RobotBall] = (),
        obstacles: Sequence[HorizontalLine] = (),
    ):
        self.layout = make_layout(
            waypoints, n_dim, [b.is_gripper for b in balls], len(obstacles)
        )
        self.waypoints = waypoints
        self.n_dim = n_dim
        self.balls = list(balls)
        self.obstacles = list(obstacles)

        m, n = self.layout.n_rows, self.layout.n_vars
        self.A = np.zeros((m, n), dtype=np.float64)
        self.l = np.full((m,), -INF, dtype=np.float64)
        self.u = np.full((m,), INF, dtype=np.float64)

        self._link_velocity_to_position()

    # ------------------------------------------------------------------ box

    def position(self, i: int, c: Constraint) -> "ConstraintBuilder":
        return self.positions(i, i, c)

    def positions(self, first: int, last: int, c: Constraint) -> "ConstraintBuilder":
        for i in range(first, last + 1):
            self._constrain_variable(self.layout.nth_pos(i), c)
        return self

    def velocity(self, i: int, c: Constraint) -> "ConstraintBuilder":
        assert 0 <= i < self.waypoints - 1
        return self.velocities(i, i, c)

    def velocities(self, first: int, last: int, c: Constraint) -> "ConstraintBuilder":
        assert first <= last < self.waypoints - 1
        for i in range(first, last + 1):
            self._constrain_variable(self.layout.nth_velocity(i), c)
        return self

    def acceleration(self, i: int, c: Constraint) -> "ConstraintBuilder":
        """``l <= v_{t+1} - v_t <= u`` rows (``constraint-builder.h:71-88``)."""
        assert i + 2 < self.waypoints
        lay = self.layout
        row = lay.user_offset + lay.nth_acceleration(i)
        base_v = lay.nth_velocity(i)
        base_nv = lay.nth_velocity(i + 1)
        for j in range(self.n_dim):
            self._add_constraint(
                row + j,
                [(base_nv + j, 1.0), (base_v + j, -1.0)],
                c.lower[j],
                c.upper[j],
            )
        return self

    def accelerations(self, first: int, last: int, c: Constraint) -> "ConstraintBuilder":
        for i in range(first, last + 1):
            self.acceleration(i, c)
        return self

    # ------------------------------------------------------ SCP linearization

    def with_obstacles(
        self, con_3d: Constraint, trajectory: np.ndarray
    ) -> "ConstraintBuilder":
        """Linearized workspace + obstacle rows (``constraint-builder.h:90-122``).

        ``trajectory`` is the current ``(2*W*N,)`` iterate; only its position
        half is read (pinned by the reference test
        ``ignore_velocity_trajectory``, ``tests/test.cpp:403-448``).
        """
        lay = self.layout
        W, N = self.waypoints, self.n_dim
        q_traj = np.asarray(trajectory, dtype=np.float64)[: W * N].reshape(W, N)

        for b, ball in enumerate(self.balls):
            points = np.stack([np.asarray(ball.fk(q)) for q in q_traj])  # (W, 3)
            jacs = np.stack([np.asarray(ball.jacobian(q)) for q in q_traj])  # (W,3,N)
            # Per-obstacle precompute: the reference's HorizontalLine keeps
            # its scalar per-waypoint loop (byte-exact vs tests/test.cpp
            # fixtures); generic obstacles (SphereObstacle, ...) go through
            # the duck-typed vectorized protocol (geometry.py) shared with
            # the structured hot path.
            per_obs = []
            jq = np.einsum("waj,wj->wa", jacs, q_traj)  # (W, 3) per-axis J·q0
            for obs in self.obstacles:
                if isinstance(obs, HorizontalLine):
                    per_obs.append(
                        ("line", np.asarray(obs.has_collision(points, ball.radius)))
                    )
                else:
                    per_obs.append((
                        "generic",
                        tuple(
                            np.asarray(a, dtype=np.float64)
                            for a in obs.linearize_rows(
                                points, jacs, jq, ball.radius
                            )
                        ),
                    ))
            for t in range(W):
                q = q_traj[t]
                p = points[t]
                jac = jacs[t]
                k = 0
                if ball.is_gripper:
                    # constraint-builder.h:221-244: per axis,
                    # bound_axis = con3d_axis - p_axis + J_axis·q  (±radius).
                    for axis in range(3):
                        low, upp = -INF, INF
                        if not is_loose(con_3d.lower[axis]):
                            low = con_3d.lower[axis] - p[axis] + jac[axis] @ q
                        if not is_loose(con_3d.upper[axis]):
                            upp = con_3d.upper[axis] - p[axis] + jac[axis] @ q
                        self._ws_row(
                            lay.workspace_row(b, t, k), ball, jac, axis, t, low, upp
                        )
                        k += 1
                for o, obstacle in enumerate(self.obstacles):
                    row = lay.workspace_row(b, t, k)
                    k += 1
                    kind, data = per_obs[o]
                    if kind == "generic":
                        row_jac, g_low, g_upp = data
                        self._ws_row_raw(
                            row, row_jac[t], t, float(g_low[t]), float(g_upp[t])
                        )
                        continue
                    if bool(data[t]):
                        # constraint-builder.h:246-267: single Z row bounding
                        # J_z·q above/below the line height at closest point.
                        bound = (
                            float(obstacle.closest_point(p)[2]) - p[2] + jac[2] @ q
                        )
                        if bool(obstacle.bypass_from_below):
                            low, upp = -INF, bound
                        else:
                            low, upp = bound, INF
                    else:
                        # Dummy row, same coefficients, infinite bounds
                        # (constraint-builder.h:112-116) — keeps values-only
                        # updates shape-stable.
                        low, upp = -INF, INF
                    self._ws_row(row, ball, jac, 2, t, low, upp)
        return self

    # --------------------------------------------------------------- output

    def build(self) -> QPConstraints:
        """Materialize ``(l, A, u)`` (``constraint-builder.h:124-136``).

        Returns views of the internal dense arrays (copy if you mutate)."""
        return self.l.copy(), self.A.copy(), self.u.copy()

    # Convenience index mirrors (constraint-builder.h:138-151).
    def nth_pos(self, i: int) -> int:
        return self.layout.nth_pos(i)

    def nth_velocity(self, i: int) -> int:
        return self.layout.nth_velocity(i)

    def nth_acceleration(self, i: int) -> int:
        return self.layout.nth_acceleration(i)

    # -------------------------------------------------------------- internal

    def _add_constraint(
        self,
        row: int,
        factors: Sequence[Tuple[int, float]],
        low: Optional[float],
        upp: Optional[float],
    ) -> None:
        """Mirror of ``addConstraint`` (``constraint-builder.h:173-183``).

        Loose (±INF) bounds leave the existing bound untouched, matching the
        reference's "absent optional is not written" semantics; coefficient
        writes overwrite (the reference resolves duplicate triplets
        keep-newest, ``constraint-builder.h:128-129``).
        """
        for var, coeff in factors:
            self.A[row, var] = coeff
        if low is not None and not is_loose(low):
            self.l[row] = low
        if upp is not None and not is_loose(upp):
            self.u[row] = upp
        assert self.l[row] <= self.u[row], f"l > u at row {row}"

    def _ws_row(self, row, ball, jac, axis, waypoint, low, upp) -> None:
        """Workspace row: ``J_axis`` over ``q_t`` vars, bounds tightened by
        ±radius (``constraint-builder.h:269-281``).  Bounds are written
        unconditionally (the reference passes concrete doubles here)."""
        base = self.layout.nth_pos(waypoint)
        self.A[row, base : base + self.n_dim] = jac[axis]
        self.l[row] = low + ball.radius
        self.u[row] = upp - ball.radius
        assert self.l[row] <= self.u[row], f"l > u at workspace row {row}"

    def _ws_row_raw(self, row, row_vec, waypoint, low, upp) -> None:
        """Workspace row with an arbitrary direction: ``row_vec`` over the
        ``q_t`` vars, bounds written as given (the obstacle protocol's
        ``linearize_rows`` already applied the ±ball-radius tightening)."""
        base = self.layout.nth_pos(waypoint)
        self.A[row, base : base + self.n_dim] = row_vec
        self.l[row] = low
        self.u[row] = upp
        assert self.l[row] <= self.u[row], f"l > u at workspace row {row}"

    def _constrain_variable(self, var_start: int, c: Constraint) -> None:
        """Identity box row for one N-dim variable group
        (``constraint-builder.h:185-193``)."""
        for j in range(self.n_dim):
            self._add_constraint(
                self.layout.user_offset + var_start + j,
                [(var_start + j, 1.0)],
                c.lower[j],
                c.upper[j],
            )

    def _link_velocity_to_position(self) -> None:
        """Dynamics rows ``v_t - q_{t+1} + q_t = 0``
        (``constraint-builder.h:203-219``)."""
        lay = self.layout
        for i in range(self.waypoints - 1):
            base_v = lay.nth_velocity(i)
            base_p = lay.nth_pos(i)
            base_np = lay.nth_pos(i + 1)
            for j in range(self.n_dim):
                row = i * self.n_dim + j
                self._add_constraint(
                    row,
                    [(base_v + j, 1.0), (base_np + j, -1.0), (base_p + j, 1.0)],
                    0.0,
                    0.0,
                )
