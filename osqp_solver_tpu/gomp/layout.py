"""Static variable/row layout of the trajectory QP.

Mirrors the reference's decision-vector and constraint-row arithmetic exactly
(``/root/reference/src/constraints/constraint-builder.h:138-151`` for
variables, ``:30-45`` and ``:90-122`` for rows) so that assembled ``(l, A, u)``
match the reference element-for-element.  Everything here is static Python
int arithmetic — these numbers fix the shapes that the solver compiles
against.

Decision vector (length ``2*W*N``): ``x = [q_0..q_{W-1}, v_0..v_{W-1}]``.

Row layout (total ``n_rows(...)``), in order:
  ① ``(W-1)*N`` dynamics rows ``v_t - q_{t+1} + q_t = 0``
     (``constraint-builder.h:203-219``)
  ② ``W*N`` position box rows            (``constraint-builder.h:185-201``)
  ③ ``(W-1)*N`` velocity box rows
  ④ ``(W-2)*N`` acceleration rows ``v_{t+1} - v_t``
     (``constraint-builder.h:65-88``)
  ⑤ workspace rows, compacted per ball/waypoint: 3 gripper rows (X,Y,Z) if
    ``is_gripper``, then one Z-row per obstacle (``constraint-builder.h:90-122``)
  ⑥ over-allocation padding: the reference reserves
    ``N*W*(3 + n_obstacles*n_balls)`` workspace rows (a factor ``N/3`` more
    than used, ``constraint-builder.h:43-44``); unused rows stay all-zero with
    ``(-INF, INF)`` bounds.  We reproduce the same total for parity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple


@dataclass(frozen=True)
class TrajectoryLayout:
    """Static index arithmetic for a ``W``-waypoint, ``N``-dof trajectory QP.

    ``gripper_flags`` is the per-ball ``is_gripper`` tuple (order matters —
    workspace rows are laid out ball-major like ``constraint-builder.h:95``).
    """

    waypoints: int
    n_dim: int
    gripper_flags: Tuple[bool, ...] = ()
    n_obstacles: int = 0

    # --- variables (constraint-builder.h:138-151) ---------------------------

    @property
    def n_vars(self) -> int:
        return 2 * self.waypoints * self.n_dim

    def nth_pos(self, i: int) -> int:
        assert 0 <= i < self.waypoints
        return i * self.n_dim

    def nth_velocity(self, i: int) -> int:
        assert 0 <= i < self.waypoints - 1
        return self.waypoints * self.n_dim + i * self.n_dim

    def nth_acceleration(self, i: int) -> int:
        """Row-offset helper (accelerations have no variables),
        ``constraint-builder.h:148-151``."""
        assert 0 <= i < self.waypoints - 2
        return (2 * self.waypoints - 1) * self.n_dim + i * self.n_dim

    # --- rows ---------------------------------------------------------------

    @property
    def n_balls(self) -> int:
        return len(self.gripper_flags)

    @property
    def dynamics_offset(self) -> int:
        return 0

    @property
    def n_dynamics_rows(self) -> int:
        return (self.waypoints - 1) * self.n_dim

    @property
    def user_offset(self) -> int:
        """``userConstraintOffset`` (``constraint-builder.h:35``)."""
        return self.n_dynamics_rows

    @property
    def position_offset(self) -> int:
        return self.user_offset

    @property
    def velocity_offset(self) -> int:
        return self.user_offset + self.waypoints * self.n_dim

    @property
    def acceleration_offset(self) -> int:
        return self.velocity_offset + (self.waypoints - 1) * self.n_dim

    @property
    def workspace_offset(self) -> int:
        """``obstacle_constraints_base`` (``constraint-builder.h:92``)."""
        return self.acceleration_offset + (self.waypoints - 2) * self.n_dim

    def rows_per_waypoint(self, ball: int) -> int:
        return (3 if self.gripper_flags[ball] else 0) + self.n_obstacles

    def ball_offset(self, ball: int) -> int:
        off = self.workspace_offset
        for b in range(ball):
            off += self.waypoints * self.rows_per_waypoint(b)
        return off

    def workspace_row(self, ball: int, waypoint: int, k: int = 0) -> int:
        """Row index of the ``k``-th workspace row of (``ball``, ``waypoint``).

        ``k`` counts 0..2 for gripper X/Y/Z rows then one per obstacle; for
        non-gripper balls ``k`` counts obstacles directly.  Matches the
        compacted append order of ``constraint-builder.h:95-119``.
        """
        assert 0 <= k < self.rows_per_waypoint(ball)
        return self.ball_offset(ball) + waypoint * self.rows_per_waypoint(ball) + k

    @property
    def n_used_workspace_rows(self) -> int:
        return sum(self.waypoints * self.rows_per_waypoint(b) for b in range(self.n_balls))

    @property
    def n_allocated_workspace_rows(self) -> int:
        """Reference over-allocation (``constraint-builder.h:43-44``)."""
        return self.n_dim * self.waypoints * (3 + self.n_obstacles * self.n_balls)

    @property
    def n_rows(self) -> int:
        return self.workspace_offset + self.n_allocated_workspace_rows


def make_layout(
    waypoints: int,
    n_dim: int,
    gripper_flags: Sequence[bool] = (),
    n_obstacles: int = 0,
) -> TrajectoryLayout:
    return TrajectoryLayout(
        waypoints=int(waypoints),
        n_dim=int(n_dim),
        gripper_flags=tuple(bool(g) for g in gripper_flags),
        n_obstacles=int(n_obstacles),
    )
