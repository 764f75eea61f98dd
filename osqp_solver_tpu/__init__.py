"""osqp_solver_tpu — Batched ADMM QP solver + GOMP trajectory stack.

A JAX/XLA/Pallas framework with the capabilities of the reference
ZPP-Robotics/OSQP-Solver (see SURVEY.md): an OSQP-semantics ADMM core
(vmapped, fixed shapes, masked convergence), banded/block-tridiagonal KKT
solvers, a fused ADMM-chunk GPU kernel, UR5e analytical kinematics, SCP +
horizon-scaling trajectory planning, and multi-chip scaling via
``jax.sharding`` meshes (batch axis) and Schur-complement horizon splits.

Layer map (SURVEY.md §1, re-designed for batched accelerators):

    ops/       ADMM core, Ruiz scaling, dense + block-tridiagonal KKT,
               fused chunk kernel + backend choice, solver sessions, status
    gomp/      constraint DSL, line-obstacle geometry, static row layout,
               dense builder (test path), structured TrajectoryQP (hot path),
               SCP + time-scaling planner
    models/    UR5e analytical FK / Jacobians / closed-form IK, RobotBall,
               generic classic-DH arms (any DOF) + numeric DLS IK
    parallel/  device meshes, batch-sharded solves, Schur horizon partition
    utils/     native C++ oracle bridge, observability (stats, tracing)
"""

__version__ = "0.1.0"

from .gomp import constraints
from .gomp.builder import ConstraintBuilder
from .gomp.geometry import (
    CapsuleObstacle,
    HorizontalLine,
    SphereObstacle,
    stack_obstacles,
)
from .gomp.layout import TrajectoryLayout, make_layout
from .gomp.planner import GOMPSolver, PlanResult
from .gomp.trajectory import (
    calc_warm_start,
    linspace_configs,
    smoothness_objective,
    tri_diagonal_matrix,
)
from .gomp.trajectory_qp import (
    TrajectoryQP,
    empty_trajectory_qp,
    linearize_workspace,
    with_gomp_boxes,
)
from .models.robot import RobotBall
from .ops.admm import Settings, SolveResult, solve
from .ops.admm_lane import solve_batched_lane
from .ops.qp import DenseQP, dense_qp
from .ops.session_lane import (
    LaneSession,
    mpc_scan_lane,
    setup_lane,
    solve_lane,
    update_bounds_lane,
)
from .ops.status import ExitCode

__all__ = [
    "constraints",
    "ConstraintBuilder",
    "HorizontalLine",
    "SphereObstacle",
    "CapsuleObstacle",
    "stack_obstacles",
    "TrajectoryLayout",
    "make_layout",
    "RobotBall",
    "GOMPSolver",
    "PlanResult",
    "tri_diagonal_matrix",
    "smoothness_objective",
    "linspace_configs",
    "calc_warm_start",
    "TrajectoryQP",
    "empty_trajectory_qp",
    "solve_batched_lane",
    "LaneSession",
    "setup_lane",
    "solve_lane",
    "update_bounds_lane",
    "mpc_scan_lane",
    "with_gomp_boxes",
    "linearize_workspace",
    "Settings",
    "SolveResult",
    "solve",
    "DenseQP",
    "dense_qp",
    "ExitCode",
]
