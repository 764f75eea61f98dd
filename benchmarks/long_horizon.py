"""End-to-end long-horizon ADMM on one chip: sequential vs chunked KKT.

BASELINE config-5 adjacent, but the FULL solver rather than the KKT
microbenchmark: one W=10,000 trajectory QP solved to OSQP tolerances with
the KKT backend as (a) the sequential block-tridiagonal scan and (b) the
single-device Schur chunk split (``parallel/horizon.py::as_chunked``).
The scan at B=12 is a chain of tiny latency-bound steps, which the chunked
backend trades for ~1.5× traffic redundancy.  Prints both per-solve times.

Usage: python
       benchmarks/long_horizon.py [--waypoints 10000] [--chunks 64]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--waypoints", type=int, default=10000)
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        with_gomp_boxes,
    )
    from osqp_solver_tpu.ops import admm
    from osqp_solver_tpu.parallel.horizon import as_chunked

    dtype = jnp.float32
    W, N = args.waypoints, 6
    base = empty_trajectory_qp(W, N, gripper_flags=(), n_obstacles=0, dtype=dtype)
    qp = with_gomp_boxes(
        base, jnp.zeros(N, dtype), jnp.ones(N, dtype),
        (jnp.full(N, -10.0, dtype), jnp.full(N, 10.0, dtype)),
        (jnp.full(N, -1.0, dtype), jnp.full(N, 1.0, dtype)),
        (jnp.full(N, -2.0, dtype), jnp.full(N, 2.0, dtype)),
    )
    settings = admm.Settings(check_termination=25)

    def sync(t):
        return float(sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(t)))

    out = {}
    for label, problem in (
        ("sequential_ms", qp),
        ("chunked_ms", as_chunked(qp, args.chunks)),
    ):
        f = jax.jit(lambda q: admm.solve(q, settings))
        t0 = time.time()
        res = f(problem)
        sync(res.x)
        log(f"{label}: compile+first {time.time()-t0:.1f}s "
            f"status={int(res.status)} iters={int(res.iterations)}")
        assert int(res.status) == 0, int(res.status)
        t0 = time.time()
        for _ in range(args.reps):
            res = f(problem)
        sync(res.x)
        out[label] = round((time.time() - t0) / args.reps * 1e3, 1)
        out.setdefault("iterations", int(res.iterations))
    print(json.dumps({
        "metric": "long_horizon_admm_end_to_end_ms",
        "value": out["chunked_ms"],
        "unit": f"ms/solve (W={W} full ADMM, chunked K={args.chunks}; "
                f"sequential scan {out['sequential_ms']} ms)",
        "speedup_vs_sequential": round(
            out["sequential_ms"] / out["chunked_ms"], 2
        ),
        **out,
    }))


if __name__ == "__main__":
    main()
