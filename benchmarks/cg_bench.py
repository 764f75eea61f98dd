"""Settle the indirect (CG) KKT backend: measure it against the direct
factor paths on the one class where an indirect method could plausibly win —
the long-horizon trajectory QP whose factor stream dominates memory traffic
(W·(2N)² blocks vs the matvec's W·N stencil bytes).

Three backends on the SAME W-step QP, full ADMM to OSQP tolerances:
  direct sequential  — scan block-Cholesky factor + scan solves
  direct chunked     — single-device Schur split (as_chunked, K)
  cg                 — Jacobi-PCG on the reduced system, zero factorization

Verdict this feeds (docs/PARITY.md): either CG has a measured niche or it is
labeled "parity fallback, untuned" with the loss factor quoted.

Usage: python benchmarks/cg_bench.py
       [--waypoints 10000] [--chunks 64] [--cg-tol 1e-7] [--cg-max-iter 400]
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
    ap.add_argument("--cg-tol", type=float, default=1e-7)
    ap.add_argument("--cg-max-iter", type=int, default=400)
    ap.add_argument("--skip-sequential", action="store_true",
                    help="skip the slow scan baseline (quote chunked only)")
    args = ap.parse_args()

    import jax

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import dataclasses

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
    direct = admm.Settings(check_termination=25)
    cg = dataclasses.replace(
        direct, kkt_method="cg", cg_tol=args.cg_tol,
        cg_max_iter=args.cg_max_iter,
    )

    def sync(t):
        return float(sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(t)))

    cases = []
    if not args.skip_sequential:
        cases.append(("direct_sequential_ms", qp, direct))
    cases += [
        (f"direct_chunked_k{args.chunks}_ms", as_chunked(qp, args.chunks),
         direct),
        ("cg_ms", qp, cg),
    ]

    out = {}
    for label, problem, settings in cases:
        f = jax.jit(lambda q: admm.solve(q, settings))
        t0 = time.time()
        res = f(problem)
        sync(res.x)
        log(f"{label}: compile+first {time.time()-t0:.1f}s "
            f"status={int(res.status)} iters={int(res.iterations)}")
        out[f"{label}_status"] = int(res.status)
        out[f"{label}_iters"] = int(res.iterations)
        t0 = time.time()
        for _ in range(args.reps):
            res = f(problem)
        sync(res.x)
        out[label] = round((time.time() - t0) / args.reps * 1e3, 1)

    direct_ms = out.get(
        f"direct_chunked_k{args.chunks}_ms", out.get("direct_sequential_ms")
    )
    print(json.dumps({
        "metric": "cg_vs_direct_long_horizon",
        "value": round(out["cg_ms"] / direct_ms, 2),
        "unit": f"cg/direct wall ratio (W={W} full ADMM, f32; >1 = direct wins)",
        **out,
    }))


if __name__ == "__main__":
    main()
