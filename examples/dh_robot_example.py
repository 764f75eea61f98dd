"""Generic-arm demo: plan with a 7-DOF KUKA iiwa14 from a Cartesian goal.

What the reference cannot do (it is hard-wired to the UR5e via the external
``Kinematics-UR5e-arm`` library — ``/root/reference/examples/
solver-example.cpp:29-41``): pick any classic-DH arm, solve an XYZ goal into
a joint configuration with the numeric DLS IK, and run the same GOMP
planning stack (SCP + workspace constraints + time-scaling) on it.

Usage:  python examples/dh_robot_example.py [--robot iiwa14|ur10e|ur5e|scara]
        [--waypoints 16] [--cpu]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot",
                    choices=("iiwa14", "ur10e", "ur5e", "scara"),
                    default="iiwa14")
    ap.add_argument("--waypoints", type=int, default=16)
    ap.add_argument("--segments", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = ap.parse_args()
    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from osqp_solver_tpu import constraints as C
    from osqp_solver_tpu.gomp.planner import GOMPSolver
    from osqp_solver_tpu.models import dh_robot

    robot = {"iiwa14": dh_robot.IIWA14, "ur10e": dh_robot.UR10E,
             "ur5e": dh_robot.UR5E,
             "scara": dh_robot.SCARA}[args.robot]  # 4-DOF RRPR (prismatic Z)
    n = robot.n_joints
    print(f"robot: {robot.name} ({n} DOF)")

    # Cartesian goal -> joint configuration via the numeric DLS IK.
    q_start = np.zeros(n)
    seed = np.full(n, 0.5)
    q0_ik = np.full(n, 0.3)
    for i, t in enumerate(getattr(robot, "joint_types", ())):
        if t == "p":  # prismatic strokes are meters, not radians
            seed[i], q0_ik[i] = 0.1, 0.05
    goal_xyz = np.asarray(robot.point_fk(seed))
    q_end, ok = robot.position_ik(goal_xyz, q0=q0_ik)
    if not bool(ok):  # explicit (a bare assert vanishes under `python -O`)
        print("error: IK did not converge on the Cartesian goal",
              file=sys.stderr)
        return 1
    print(f"goal xyz: {goal_xyz.round(3)} -> q_end: "
          f"{np.asarray(q_end).round(3)}")

    solver = GOMPSolver(
        max_waypoints=args.waypoints,
        time_step=0.1,
        pos_con=C.in_range(n, -3.0, 3.0),
        vel_con=C.in_range(n, -np.pi, np.pi),
        acc_con=C.in_range(n, -4 * np.pi, 4 * np.pi),
        # workspace floor on the gripper ball, as in the reference example
        con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], C.INF),
        obstacles=[],
        balls=[
            robot.make_ball(link=n - 1, radius=0.12),
            robot.make_ball(radius=0.05, is_gripper=True),
        ],
        segments=args.segments,
    )

    t0 = time.time()
    res = solver.run(q_start, np.asarray(q_end))
    print(f"status: {res.status.name}  ({time.time() - t0:.1f}s inc. compile)")
    W = res.trajectory.size // (2 * n)
    q = res.trajectory[: W * n].reshape(W, n)
    reached = np.asarray(robot.point_fk(q[W - 3]))
    print(f"horizon: {W} waypoints; gripper FK at the endpoint "
          f"(waypoint W-3): {reached.round(3)}")
    err = float(np.linalg.norm(reached - goal_xyz))
    print(f"goal error: {err:.2e} m")
    return 0 if res.status.name == "kOptimal" and err < 1e-2 else 1


if __name__ == "__main__":
    raise SystemExit(main())
