"""Robot collision-ball abstraction.

Mirror of ``RobotBall`` (``/root/reference/src/utils.h:33-42``): a sphere of
``radius`` attached to a robot frame, located by a forward-kinematics function
``fk(q) -> (3,)`` with Jacobian ``jacobian(q) -> (3, N)``.  ``is_gripper``
marks the ball whose position is boxed by the 3-D workspace constraint.

``fk`` / ``jacobian`` should be jnp-traceable (vmappable over waypoints and
problem batches); numpy callables also work on the host-side dense path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class RobotBall:
    fk: Callable  # q (N,) -> point (3,)
    jacobian: Callable  # q (N,) -> (3, N)
    radius: float
    is_gripper: bool = False
    # Optional combined batched evaluator q (..., N) -> (points (..., 3),
    # jac (..., 3, N)).  When set, the SCP linearization uses it instead of
    # vmapping fk/jacobian — a structure-of-arrays evaluator avoids the
    # (..., 4, 4) DH-matrix intermediates (see models/ur5e.py
    # fk_jacobian_points).  Must compute the SAME function as fk/jacobian.
    fk_jac_batched: Optional[Callable] = None
