"""The KKT factor's share of the full time-scaling search.

The full search (``GOMPSolver.run_batch_padded`` on ``bench.build_full_search``:
W=50, 10 segments, batch 1024) factors the lane KKT system at every solve's
set-up and at every ρ adaptation.  The share is the product of two numbers,
measured separately:

  --count   runs the full search once with ``LaneTrajectoryQP.kkt_factor``
            and ``solve_batched_lane`` wrapped in host callbacks, and prints
            how many batch-wide factorizations and solves it executed (a
            property of the algorithm and the data: run it on the CPU);
  default   times one batch-wide factorization of a W=50 lane QP on the
            default device, for the honest class (2 balls, floor, 1
            obstacle) and the box-only class, which bracket the full
            search's keep-outs (2 balls, floor, no obstacle).

    share ≈ factorizations × factor time / full-search time per batch

    python benchmarks/factor_share.py --count [--batch 1024]
    python benchmarks/factor_share.py          # on the GPU
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def count(batch, waypoints):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from osqp_solver_tpu.gomp.trajectory_qp_lane import LaneTrajectoryQP
    from osqp_solver_tpu.ops import admm_lane

    calls = {"factor": 0, "solve": 0}

    def counted(name, fn):
        def bump():
            calls[name] += 1

        def wrapped(*a, **k):
            jax.debug.callback(bump)
            return fn(*a, **k)

        return wrapped

    factor, solve = LaneTrajectoryQP.kkt_factor, admm_lane.solve_batched_lane
    LaneTrajectoryQP.kkt_factor = counted("factor", factor)
    admm_lane.solve_batched_lane = counted("solve", solve)
    try:
        solver, starts, ends = bench.build_full_search(
            jnp.float32, batch=batch, waypoints=waypoints
        )
        out = jax.block_until_ready(solver.run_batch_padded(starts, ends))
        jax.effects_barrier()
    finally:
        LaneTrajectoryQP.kkt_factor = factor
        admm_lane.solve_batched_lane = solve
    return {
        "batch": batch,
        "waypoints": waypoints,
        "factorizations": calls["factor"],
        "solves": calls["solve"],
        "scp_rounds_p50": int(np.median(np.asarray(out[3]))),
        "admm_iters_p50": int(np.median(np.asarray(out[4]))),
    }


def factor_time(batch, waypoints, reps=20):
    import jax
    import jax.numpy as jnp

    import bench
    from osqp_solver_tpu.ops.admm import Settings

    sigma = Settings().sigma
    fac = jax.jit(lambda q, r: q.kkt_factor(r, sigma))
    out = {}
    for name, build in (("honest", bench.build_honest_batch),
                        ("box", bench.build_box_batch)):
        lane = jax.block_until_ready(build(batch, waypoints, 6, jnp.float32))
        rho = jnp.full(lane.l.shape, 0.04, lane.l.dtype)
        jax.block_until_ready(fac(lane, rho))
        t0 = time.perf_counter()
        for _ in range(reps):
            f = fac(lane, rho)
        jax.block_until_ready(f)
        out[f"{name}_factor_ms"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--count", action="store_true",
                    help="count factorizations in one full search")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--waypoints", type=int, default=50)
    args = ap.parse_args()

    import jax

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    result = {"device": {"platform": dev.platform, "kind": dev.device_kind}}
    if args.count:
        result.update(count(args.batch, args.waypoints))
    else:
        result.update(factor_time(args.batch, args.waypoints))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
