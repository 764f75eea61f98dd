"""CPU wall-clock anchor: the native oracle on reference-equivalent QPs.

The reference publishes no numbers and its only timing artifact is a
commented-out chrono scaffold (``/root/reference/examples/solver-example.cpp:55-56``).
This script produces the measured stand-in: the from-scratch C++ ADMM oracle
(``native/osqp_oracle.cpp``, sparse-A/banded-KKT variant — the same
qdldl-equivalent cost model OSQP pays) solving

1. the honest headline QP class (100-waypoint 6-DOF UR5e trajectory with
   gripper workspace rows + one obstacle — what ``bench.py`` measures on the GPU),
   single-thread f64, and
2. the reference example's own full-horizon QP (W=802, ``solver-example.cpp:13``).

Prints one JSON line per config (diagnostics to stderr).

Usage: python benchmarks/cpu_anchor.py [--skip-802]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_honest_qp(W: int, dtype, seed: float = 0.0):
    """One honest-class trajectory QP: UR5e 2-ball linearization around the
    linspace warm start (mirrors examples/solver-example.cpp:37-51 with one
    HorizontalLine obstacle added so obstacle rows are exercised)."""
    import jax.numpy as jnp

    from osqp_solver_tpu.gomp.geometry import HorizontalLine
    from osqp_solver_tpu.gomp.trajectory import calc_warm_start_jnp
    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        linearize_workspace,
        with_gomp_boxes,
    )
    from osqp_solver_tpu.models import ur5e

    N, DT, INF = 6, 0.1, 1e30
    balls = (
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    )
    obstacles = [HorizontalLine.create((0.0, 1.0), (0.35, 0.0, 0.15))]
    con3d = (jnp.asarray([-INF, -0.4, -INF], dtype),
             jnp.asarray([INF, INF, INF], dtype))
    pos = (jnp.full(N, -2 * np.pi, dtype), jnp.full(N, 2 * np.pi, dtype))
    vel = (jnp.full(N, -np.pi * DT, dtype), jnp.full(N, np.pi * DT, dtype))
    acc = (jnp.full(N, -800 * np.pi / 180 * DT**2, dtype),
           jnp.full(N, 800 * np.pi / 180 * DT**2, dtype))
    start = 0.02 * jnp.sin(jnp.arange(N, dtype=dtype) + seed)
    end = jnp.asarray([np.pi, 0, 0, 0, 0, 0], dtype) + 0.02 * jnp.cos(
        jnp.arange(N, dtype=dtype) * 1.3 + seed
    )
    qp = empty_trajectory_qp(W, N, gripper_flags=(False, True), n_obstacles=1,
                             dtype=dtype)
    qp = with_gomp_boxes(qp, start, end, pos, vel, acc)
    warm = calc_warm_start_jnp(start, end, W)
    return linearize_workspace(qp, balls, obstacles, con3d, warm), warm


def emit(name, value, unit, extra=None):
    rec = {"metric": name, "value": round(float(value), 3), "unit": unit}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-802", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from osqp_solver_tpu.utils import oracle

    # ---- config A: honest W=100 class, single-thread f64 -------------------
    qp, warm = build_honest_qp(100, jnp.float64)
    P_csr, q, A_csr, l, u, kb, perm = qp.to_csr()
    warm_int = np.zeros_like(q)
    warm_int[perm] = np.asarray(warm)
    res = oracle.solve_sparse(P_csr, q, A_csr, l, u, kb, warm_x=warm_int)
    log(f"W=100 status={res.status} iters={res.iterations} "
        f"prim={res.prim_res:.2e} dual={res.dual_res:.2e}")
    t0 = time.time()
    for _ in range(args.reps):
        res = oracle.solve_sparse(P_csr, q, A_csr, l, u, kb, warm_x=warm_int)
    per = (time.time() - t0) / args.reps
    emit(
        "cpu_anchor_honest_100wp_ms",
        per * 1e3,
        "ms/solve (native oracle, sparse banded KKT, 1 thread, f64)",
        {"qps_per_sec_cpu": round(1.0 / per, 2), "iterations": res.iterations,
         "status": res.status},
    )

    # ---- config B: reference example scale (W=802) -------------------------
    if not args.skip_802:
        qp, warm = build_honest_qp(802, jnp.float64)
        P_csr, q, A_csr, l, u, kb, perm = qp.to_csr()
        warm_int = np.zeros_like(q)
        warm_int[perm] = np.asarray(warm)
        t0 = time.time()
        res = oracle.solve_sparse(P_csr, q, A_csr, l, u, kb, warm_x=warm_int)
        per = time.time() - t0
        log(f"W=802 status={res.status} iters={res.iterations} "
            f"prim={res.prim_res:.2e} dual={res.dual_res:.2e}")
        emit(
            "cpu_anchor_example_802wp_s",
            per,
            "s/solve (native oracle, W=802 full-horizon QP, 1 thread, f64)",
            {"iterations": res.iterations, "status": res.status},
        )


if __name__ == "__main__":
    main()
