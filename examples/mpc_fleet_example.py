"""Fleet MPC: many receding-horizon controllers stepped together on one chip.

The production serving pattern this framework is built for: B independent
robot controllers, each owning one GOMP trajectory QP (reference problem
class, ``/root/reference/examples/solver-example.cpp:37-51``), re-solved
warm-started every control tick on a cached KKT factorization — OSQP's
``Solve()``-in-a-loop session contract (``osqp-wrapper.h:12-60``,
``gomp-solver.h:41-52``) batched over the whole fleet
(:mod:`osqp_solver_tpu.ops.session_lane`).

Run: JAX_PLATFORMS=cpu python examples/mpc_fleet_example.py
     [--batch 8] [--ticks 10] [--waypoints 24]
(defaults are CPU-friendly; on a GPU use batch 1024 via benchmarks/mpc_fleet.py)
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--waypoints", type=int, default=24)
    args = ap.parse_args()
    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax

    import jax.numpy as jnp
    import numpy as np

    from bench import build_honest_batch
    from osqp_solver_tpu.ops import admm
    from osqp_solver_tpu.ops.session_lane import (
        mpc_scan_lane,
        setup_lane,
        solve_lane,
    )

    dtype = jnp.float32
    B, T, W, N = args.batch, args.ticks, args.waypoints, 6
    settings = dataclasses.replace(
        admm.Settings(), rho=0.05, check_termination=2,
        adaptive_rho_interval=50,
    )

    print(f"building a fleet of {B} UR5e controllers (W={W})...")
    lane = build_honest_batch(B, W, N, dtype)

    # Setup = OSQP Init for the whole fleet: Ruiz once, factor once.
    sess = setup_lane(lane, settings)
    sess, res0 = solve_lane(sess, settings)
    print(
        f"tick 0 (cold): {int(np.sum(np.asarray(res0.status) == 0))}/{B} "
        f"optimal, median {int(np.median(np.asarray(res0.iterations)))} iters"
    )

    # Per tick: every controller's goal equality drifts; the fleet re-solves
    # warm-started, zero refactorizations (classification-stable updates).
    deltas = 2e-4 * jnp.sin(
        jnp.arange(T, dtype=dtype)[:, None, None] * 0.3
        + jnp.arange(N, dtype=dtype)[None, :, None]
    ) * jnp.ones((1, 1, 1), dtype)

    def shift_goal(base, d):
        return base.replace(
            pos_l=base.pos_l.at[-1].add(d), pos_u=base.pos_u.at[-1].add(d)
        )

    t0 = time.time()
    sess, (status, iters) = mpc_scan_lane(sess, deltas, shift_goal, settings)
    status.block_until_ready()
    dt = time.time() - t0
    st = np.asarray(status)
    it = np.asarray(iters)
    print(
        f"{T} ticks x {B} controllers: {int(np.sum(st == 0))}/{B * T} optimal,"
        f" warm re-solves median {int(np.median(it))} iters,"
        f" {dt / T * 1e3:.1f} ms/tick (incl. compile on first call)"
    )


if __name__ == "__main__":
    main()
