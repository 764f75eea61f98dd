"""Reference-example-scale QPs (W=802, 6-DOF UR5e) batched on the lane driver.

The reference's own flagship problem (`/root/reference/examples/
solver-example.cpp:13`: 802 waypoints) solved as a BATCH on one chip —
this measures the lane driver (fused chunk kernel where the backend
selects it) on the same class.

Usage: python benchmarks/w802_lane.py
       [--batch 128] [--waypoints 802]
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
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--waypoints", type=int, default=802)
    ap.add_argument("--ct", type=int, default=13)
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--scaling", type=int, default=None)
    ap.add_argument(
        "--adapt-interval", type=int, default=60,
        help="adaptive-rho interval.  Default 60 defers adaptation past the "
        "measured 30-iteration tail (bench.py's rationale: adaptation stays "
        "on as a safety net, off the benchmark class).  The r2 default 3*ct "
        "= 9 fired mid-solve: rho moved, the whole batch refactored, and "
        "the post-adaptation trajectory needed 45 iters instead of 30 — "
        "3.1k vs 5.3k QPs/s at batch 512.",
    )
    args = ap.parse_args()

    import os

    import jax

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from bench import build_honest_batch
    from osqp_solver_tpu.ops import admm
    from osqp_solver_tpu.ops.admm_lane import solve_batched_lane

    def sync(a):
        return float(jnp.sum(a))

    dtype = jnp.float32
    B, W, N = args.batch, args.waypoints, 6
    settings = dataclasses.replace(
        admm.Settings(), rho=args.rho, check_termination=args.ct,
        adaptive_rho_interval=(
            args.adapt_interval if args.adapt_interval is not None
            else 3 * args.ct
        ),
        **({"scaling": args.scaling} if args.scaling is not None else {}),
    )
    t0 = time.time()
    lane = build_honest_batch(B, W, N, dtype)
    sync(lane.ws_l)
    log(f"batch built: {time.time()-t0:.1f}s (B={B}, W={W})")

    @jax.jit
    def solve(qps, rho0):
        r = solve_batched_lane(qps, settings, rho0=rho0)
        return r.x, r.status, r.iterations, r.prim_res

    r0 = jnp.asarray(args.rho, dtype)
    t0 = time.time()
    x, status, iters, pr = solve(lane, r0)
    sync(x)
    log(f"compile+first: {time.time()-t0:.1f}s")
    st = np.asarray(status)
    it = np.asarray(iters)
    n_opt = int(np.sum(st == 0))
    log(
        f"optimal {n_opt}/{B}; iters p50={int(np.median(it))} "
        f"max={int(np.max(it))}; prim_res max={float(np.max(np.asarray(pr))):.2e}"
    )

    reps = 3

    @jax.jit
    def solve_k(qps, rho0):
        def body(i, eps):
            r = solve_batched_lane(qps, settings, rho0=rho0 + eps)
            return 0.0 * jnp.sum(r.x)

        return jax.lax.fori_loop(0, reps, body, jnp.asarray(0.0, dtype))

    sync(solve_k(lane, r0))
    t0 = time.time()
    sync(solve_k(lane, r0))
    dt = (time.time() - t0) / reps
    log(f"steady-state: {dt*1e3:.1f} ms/batch -> {n_opt/dt:.1f} QPs/s")
    print(
        json.dumps(
            {
                "metric": "w802_reference_scale_qps_per_sec",
                "value": round(n_opt / dt, 2),
                "unit": f"QPs/s (W={W} 6-DOF UR5e honest class, batch {B})",
                "ms_per_batch": round(dt * 1e3, 1),
                "optimal": n_opt,
                "median_iters": int(np.median(it)),
            }
        )
    )


if __name__ == "__main__":
    main()
