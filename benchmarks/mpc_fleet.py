"""Fleet MPC throughput: B receding-horizon controllers × T ticks.

Each controller owns one honest W=100 UR5e trajectory QP (bench.py class);
per tick every problem's goal-position equality shifts and the whole fleet
re-solves warm-started on the session's cached factor — zero Ruiz, zero
refactorization per tick (ops/session_lane.py).

Usage: python benchmarks/mpc_fleet.py
       [--batch 1024] [--ticks 50] [--ct 5]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--ct", type=int, default=5)
    args = ap.parse_args()

    import os

    import jax

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from bench import build_honest_batch
    from osqp_solver_tpu.ops import admm
    from osqp_solver_tpu.ops.session_lane import mpc_scan_lane, setup_lane

    def sync(a):
        return float(jnp.sum(a))

    dtype = jnp.float32
    B, T, W, N = args.batch, args.ticks, 100, 6
    settings = dataclasses.replace(
        admm.Settings(), rho=0.05, check_termination=args.ct,
        adaptive_rho_interval=51,
    )
    lane = build_honest_batch(B, W, N, dtype)
    sync(lane.ws_l)
    log(f"fleet built: {B} controllers")

    # Per-tick goal shifts: tiny sinusoidal drift of the final-waypoint
    # position equality (classification-stable — equalities stay equalities).
    deltas = 2e-4 * jnp.sin(
        jnp.arange(T, dtype=dtype)[:, None, None] * 0.3
        + jnp.arange(N, dtype=dtype)[None, :, None]
    ) * jnp.ones((1, 1, 1), dtype)

    def shift_goal(base, d):
        return base.replace(
            pos_l=base.pos_l.at[-1].add(d), pos_u=base.pos_u.at[-1].add(d)
        )

    @jax.jit
    def run(lane, deltas):
        sess = setup_lane(lane, settings)
        sess, (status, iters) = mpc_scan_lane(
            sess, deltas, shift_goal, settings
        )
        return status, iters, sess.warm_x

    status, iters, wx = run(lane, deltas)
    t0 = time.time()
    sync(wx)
    log(f"compile+first: {time.time() - t0:.1f}s (already synced)")
    st = np.asarray(status)
    it = np.asarray(iters)
    n_opt = int(np.sum(st == 0))
    log(
        f"optimal {n_opt}/{B * T}; iters: tick0 p50={int(np.median(it[0]))} "
        f"warm p50={int(np.median(it[1:]))} max={int(np.max(it[1:]))}"
    )

    t0 = time.time()
    status, iters, wx = run(lane, deltas)
    sync(wx)
    dt = time.time() - t0
    resolves = B * T / dt
    per_tick_ms = dt / T * 1e3
    log(f"{dt*1e3:.0f} ms for {T} ticks -> {per_tick_ms:.2f} ms/tick")
    print(
        json.dumps(
            {
                "metric": "fleet_mpc_resolves_per_sec",
                "value": round(resolves, 1),
                "unit": f"warm re-solves/s ({B} controllers x {T} ticks, "
                f"W=100 honest class, cached factor)",
                "per_tick_ms": round(per_tick_ms, 2),
                "optimal": n_opt,
                "total": B * T,
            }
        )
    )


if __name__ == "__main__":
    main()
