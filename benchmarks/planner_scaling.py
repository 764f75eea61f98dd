"""Planner-layer sharding overhead on the virtual CPU mesh.

The solver-layer scaling harness (``benchmarks/scaling.py``) measures the
batch/horizon axes of the RAW ADMM solve; this measures the PLANNER fleet
paths (``run_batch_lane_sharded`` / ``run_batch_padded_sharded`` — round-5
DP scale-out, one solver per problem, ``gomp-solver.h:61-64``): the same
query fleet planned by the single-device program vs ``shard_map`` over an
8-virtual-device mesh.

The compiled sharded programs contain ZERO cross-device collectives
(pinned by ``tests/test_planner_sharded.py::
test_sharded_planner_compiles_zero_collectives``), so on a real multi-chip
mesh throughput scales with the device count; what remains measurable on
one host is the sharding overhead itself — program partitioning +
per-device while-loop divergence (a device's shard finishes when ITS
slowest query does, which can BEAT the global batch's masked loop).
``--one-core`` pins the process to one core so both variants get identical
compute and the delta is pure overhead.

Usage: JAX_PLATFORMS=cpu python benchmarks/planner_scaling.py
       [--one-core] [--batch 64] [--waypoints 16] [--full]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if "--one-core" in sys.argv:
    os.sched_setaffinity(0, {0})
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

# CPU-only harness by design (virtual 8-device mesh + one-core pinning).
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--waypoints", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--one-core", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="measure run_batch_padded (the full time-scaling "
                    "search) instead of the fixed-horizon lane path")
    args = ap.parse_args()

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from osqp_solver_tpu import RobotBall, constraints as C
    from osqp_solver_tpu.gomp.planner import GOMPSolver
    from osqp_solver_tpu.parallel.mesh import make_mesh

    N = 3
    ball = RobotBall(
        fk=lambda s: s,
        jacobian=lambda s: jnp.eye(3, dtype=s.dtype),
        radius=0.05,
        is_gripper=True,
    )
    solver = GOMPSolver(
        max_waypoints=args.waypoints,
        time_step=0.1,
        pos_con=C.in_range(N, -10, 10),
        vel_con=C.in_range(N, -20, 20),
        acc_con=C.in_range(N, -40, 40),
        con_3d=C.in_range(3, -10, 10),
        obstacles=[],
        balls=[ball],
        segments=2,
        dtype=jnp.float32,
    )
    B, W = args.batch, args.waypoints
    rng = np.random.default_rng(42)
    starts = 0.1 * rng.standard_normal((B, N))
    ends = np.array([1.0, 0.5, -0.25]) + 0.1 * rng.standard_normal((B, N))
    mesh = make_mesh()
    log(f"devices: {len(jax.devices())}  mode: "
        f"{'one-core (pure overhead)' if args.one_core else 'all-cores'}")

    if args.full:
        single = lambda: solver.run_batch_padded(starts, ends)
        sharded = lambda: solver.run_batch_padded_sharded(starts, ends, mesh=mesh)
        label = "padded_full"
    else:
        single = lambda: solver.run_batch_lane(starts, ends, waypoints=W)
        sharded = lambda: solver.run_batch_lane_sharded(
            starts, ends, waypoints=W, mesh=mesh
        )
        label = "lane"

    results = {}
    for name, fn in (("single_device", single), ("sharded_8dev", sharded)):
        out = fn()  # compile + first
        float(jnp.sum(out[1]))
        t0 = time.time()
        for _ in range(args.reps):
            out = fn()
        float(jnp.sum(out[1]))
        dt = (time.time() - t0) / args.reps
        n_opt = int((np.asarray(out[0]) == 0).sum())
        results[name] = round(dt * 1e3, 1)
        log(f"[{label}/{name}] {dt*1e3:.1f} ms/batch, optimal {n_opt}/{B}")

    ratio = results["sharded_8dev"] / results["single_device"]
    print(json.dumps({
        "metric": "planner_sharding_overhead_ratio",
        "path": label,
        "value": round(ratio, 3),
        "unit": "sharded-8dev wall / single-device wall, same host "
                "(zero collectives in the sharded HLO; <=1 means the "
                "per-shard while-loops beat the global masked loop)",
        "one_core": bool(args.one_core),
        **results,
    }))


if __name__ == "__main__":
    main()
