"""End-to-end UR5e demo — mirror of the reference example app
(``/root/reference/examples/solver-example.cpp``, 101 LoC).

Plans a base sweep ``{0,0,0,0,0,0} → {π,0,0,0,0,0}`` with the workspace floor
``y ≥ -0.4`` on the gripper ball, then writes the joint trajectory and its
FK-mapped XYZ path to ``output_trajectory_ctrl.data`` /
``output_trajectory_xyz.data`` (same file formats, ``solver-example.cpp:73-81``)
and prints the start/mid/end FK summary (``:83-95``).

Usage:  python examples/solver_example.py [--waypoints 802] [--cpu] [--mode padded|exact]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

# Allow running straight from the repo: python examples/solver_example.py
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--waypoints", type=int, default=802)  # solver-example.cpp:13
    ap.add_argument("--time-step", type=float, default=0.1)  # :12
    ap.add_argument("--segments", type=int, default=10)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument(
        "--obstacles",
        action="store_true",
        help="enable the reference's (commented-out) line obstacles "
        "(solver-example.cpp:48-51)",
    )
    ap.add_argument("--f32", action="store_true", help="solve in float32")
    ap.add_argument(
        "--mode",
        choices=("padded", "exact"),
        default="padded",
        help="padded: ONE compiled program for the whole time-scaling loop "
        "(pad-to-max, accelerator-friendly); exact: one program per horizon length "
        "(reference-shaped)",
    )
    args = ap.parse_args()
    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from osqp_solver_tpu import constraints as C
    from osqp_solver_tpu.gomp.geometry import HorizontalLine
    from osqp_solver_tpu.gomp.planner import GOMPSolver
    from osqp_solver_tpu.models import ur5e

    dtype = jnp.float32 if args.f32 else jnp.float64

    # Two collision balls, as in solver-example.cpp:37-41.
    balls = [
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    ]

    solver = GOMPSolver(
        max_waypoints=args.waypoints,
        time_step=args.time_step,
        pos_con=C.in_range(6, -2 * np.pi, 2 * np.pi),  # :44
        vel_con=C.in_range(6, -np.pi, np.pi),  # :45
        acc_con=C.in_range(6, -np.pi * 800 / 180, np.pi * 800 / 180),  # :46
        con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], None),  # :47
        obstacles=(
            [
                HorizontalLine.create([0, 1], [0, 0, 0.6], True),
                HorizontalLine.create([0, 1], [0.3, 0, 0.5], False),
            ]
            if args.obstacles
            else []  # :48-51 (commented out in the reference too)
        ),
        balls=balls,
        gripper_ik=ur5e.inverse_kinematics_position,
        segments=args.segments,
        dtype=dtype,
    )

    start = np.zeros(6)
    end = np.array([np.pi, 0, 0, 0, 0, 0.0])  # :70

    t0 = time.time()
    run = solver.run_padded if args.mode == "padded" else solver.run
    res = run(start, end)
    wall = time.time() - t0

    traj = res.trajectory
    W = traj.size // 12
    q = traj[: W * 6].reshape(W, 6)

    from osqp_solver_tpu.utils.trajectory_io import write_trajectory_files

    fk = lambda qi: np.asarray(ur5e.forward_kinematics(jnp.asarray(qi, dtype)))
    points = np.stack([fk(q[i]) for i in range(W)])
    write_trajectory_files(
        q, points, "output_trajectory_ctrl.data", "output_trajectory_xyz.data"
    )

    start_gt = fk(start)
    print(f"status: {res.status.name}  waypoints: {W}  wall: {wall:.2f}s")
    print("per-segment stats:", res.stats)
    print("\nSummary:")
    print(f"Ground-truth start {start_gt} -> optimized start {fk(q[0])}")
    print(f"Middle position after optimization: {fk(q[min(10, W - 1)])}")
    print(f"Ground-truth end {fk(end)} -> optimized end {fk(q[W - 1])}")
    return 0 if res.status.name.startswith("kOptimal") else 1


if __name__ == "__main__":
    sys.exit(main())
