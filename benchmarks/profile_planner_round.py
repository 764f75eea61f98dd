"""Decompose the batched-planner SCP round.

``GOMPSolver.run_batch_lane`` (gomp/planner.py) iterates
solve → exact-FK check → re-linearize per SCP round on the whole batch.
This profiler measures each stage in isolation (in-program loops, one
readback) at the published config (batch 1024, W=50, honest UR5e class):

  1. ``from_trailing`` relayout (trailing container → lane container)
  2. ``solve_batched_lane`` cold (first SCP round: Ruiz + factor + ~27 it)
  3. ``solve_batched_lane`` warm-started (later rounds: few iterations)
  4. ``linearize_workspace`` vmapped (FK + Jacobian, all waypoints)
  5. exact-FK feasibility check (``_is_solution_ok_fn``)
  6. the full SCP body round (everything together, as the planner runs it)

Usage: python
       benchmarks/profile_planner_round.py [--batch 1024] [--waypoints 50]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--waypoints", type=int, default=50)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import jax

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from osqp_solver_tpu.gomp.geometry import HorizontalLine
    from osqp_solver_tpu.gomp.trajectory import calc_warm_start_jnp
    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        linearize_workspace,
        with_gomp_boxes,
    )
    from osqp_solver_tpu.gomp.trajectory_qp_lane import from_trailing
    from osqp_solver_tpu.models import ur5e
    from osqp_solver_tpu.ops import admm
    from osqp_solver_tpu.ops.admm_lane import solve_batched_lane

    dtype = jnp.float32
    B, W, N = args.batch, args.waypoints, 6
    DT, INF = 0.1, 1e30
    reps = args.reps

    balls = (
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    )
    obstacles = [HorizontalLine.create((0.0, 1.0), (0.35, 0.0, 0.15))]
    con3d = (jnp.asarray([-INF, -0.4, -INF], dtype),
             jnp.asarray([INF, INF, INF], dtype))
    boxes = (
        (jnp.full(N, -2 * np.pi, dtype), jnp.full(N, 2 * np.pi, dtype)),
        (jnp.full(N, -np.pi * DT, dtype), jnp.full(N, np.pi * DT, dtype)),
        (jnp.full(N, -800 * np.pi / 180 * DT**2, dtype),
         jnp.full(N, 800 * np.pi / 180 * DT**2, dtype)),
    )
    settings = dataclasses.replace(
        admm.Settings(), rho=0.04, check_termination=3,
        adaptive_rho_interval=45, scaling=3,
    )

    sync = jax.block_until_ready

    def build_one(start, end):
        warm = calc_warm_start_jnp(start, end, W)
        qp = empty_trajectory_qp(
            W, N, [b.is_gripper for b in balls], len(obstacles), dtype
        )
        qp = with_gomp_boxes(qp, start, end, *boxes)
        return linearize_workspace(qp, balls, obstacles, con3d, warm), warm

    starts = 0.02 * jnp.sin(
        jnp.arange(N, dtype=dtype)[None, :] + jnp.arange(B, dtype=dtype)[:, None]
    )
    ends = jnp.asarray([np.pi, 0, 0, 0, 0, 0], dtype)[None, :] + 0.02 * jnp.cos(
        jnp.arange(N, dtype=dtype)[None, :] * 1.3
        + jnp.arange(B, dtype=dtype)[:, None]
    )

    qp_t, x0 = jax.jit(jax.vmap(build_one, out_axes=-1))(starts, ends)
    sync(qp_t.q_vec)
    log(f"built B={B} W={W}")

    # Exact-FK feasibility check (planner._is_solution_ok_fn semantics).
    from osqp_solver_tpu.gomp.geometry import ERROR

    def is_ok(x):
        q = x[: W * N].reshape(W, N)
        ok = jnp.array(True)
        for ball in balls:
            if ball.fk_jac_batched is not None:
                pts = jnp.asarray(ball.fk_jac_batched(q)[0], dtype)
            else:
                pts = jax.vmap(lambda s: jnp.asarray(ball.fk(s), dtype))(q)
            r = ball.radius
            if ball.is_gripper:
                ok &= jnp.all(con3d[0][None, :] - ERROR <= pts - r)
                ok &= jnp.all(pts + r <= con3d[1][None, :] + ERROR)
            for line in obstacles:
                coll = line.has_collision(pts, r)
                above = line.is_above(pts, r)
                ok &= jnp.all(~coll | above)
        return ok

    ok_b = jax.vmap(is_ok, in_axes=-1)

    def timed(label, fn, *a):
        """Mean wall time of `reps` back-to-back dispatches after one warm-up
        call, synchronized once at the end."""
        jfn = jax.jit(fn)
        out = jfn(*a)
        sync(out)
        t0 = time.time()
        for _ in range(reps):
            out = jfn(*a)
        sync(out)
        dt = (time.time() - t0) / reps
        log(f"{label:36s} {dt*1e3:8.2f} ms")
        return dt

    results = {}
    results["relayout_from_trailing"] = timed(
        "from_trailing relayout", lambda q: from_trailing(
            q, row_layout="waypoint"
        ).q, qp_t,
    )
    lane = from_trailing(qp_t, row_layout="waypoint")
    sync(lane.q)

    results["solve_cold"] = timed(
        "solve_batched_lane cold",
        lambda l: solve_batched_lane(l, settings).x, lane,
    )
    res0 = jax.jit(lambda l: solve_batched_lane(l, settings))(lane)
    sync(res0.x)
    it0 = np.asarray(res0.iterations)
    log(f"  cold iters p50={int(np.median(it0))} "
        f"optimal={int(np.sum(np.asarray(res0.status) == 0))}/{B}")

    results["solve_warm"] = timed(
        "solve_batched_lane warm",
        lambda l, x, y: solve_batched_lane(l, settings, warm_x=x, warm_y=y).x,
        lane, res0.x, res0.y,
    )
    res1 = jax.jit(
        lambda l, x, y: solve_batched_lane(l, settings, warm_x=x, warm_y=y)
    )(lane, res0.x, res0.y)
    log(f"  warm iters p50={int(np.median(np.asarray(res1.iterations)))}")

    lin_b = jax.vmap(
        lambda qp, xi: linearize_workspace(qp, balls, obstacles, con3d, xi),
        in_axes=-1, out_axes=-1,
    )
    results["linearize_workspace"] = timed(
        "linearize_workspace (FK+Jac)",
        lambda q, x: lin_b(q, x).ws_l, qp_t, res0.x.T,
    )
    results["exact_fk_check"] = timed(
        "exact-FK feasibility check", lambda x: ok_b(x), res0.x.T,
    )

    def full_round(qp_t, x, y):
        lane = from_trailing(qp_t, row_layout="waypoint")
        res = solve_batched_lane(lane, settings, warm_x=x.T, warm_y=y.T)
        ok = ok_b(res.x.T)
        qp2 = lin_b(qp_t, res.x.T)
        return qp2.ws_l, ok, res.x

    results["full_scp_round"] = timed(
        "FULL SCP round (warm)", full_round, qp_t, res0.x.T, res0.y.T,
    )

    print(json.dumps({
        "metric": "planner_round_breakdown_ms",
        "value": round(results["full_scp_round"] * 1e3, 2),
        "unit": f"ms/SCP round (batch {B}, W={W}, honest class)",
        **{k: round(v * 1e3, 2) for k, v in results.items()},
    }))


if __name__ == "__main__":
    main()
