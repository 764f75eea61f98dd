"""Scaling-efficiency harness (SURVEY.md §7 step 7; VERDICT r2 next #1).

Measures, as one JSON line each:

1. ``kkt_cached_solve`` — the per-ADMM-iteration KKT triangular solve with a
   CACHED factor (the quantity that dominates ADMM cost): sequential scan
   vs Schur-complement chunked at K ∈ {2,4,8} on ONE device (vmapped
   chunks).  This isolates the algorithmic redundancy of the separator
   decomposition from distribution effects.
2. ``horizon_admm_iters_per_sec`` — full OSQP-semantics ADMM with
   everything sharded over the mesh horizon axis
   (``parallel/banded.py::solve_banded_sharded``) at K ∈ {1,2,4,8} on the
   virtual CPU mesh, fixed iteration count (tolerances pinned unreachable),
   vs the single-device sequential-scan baseline.
3. ``batch_admm_qps_per_sec`` — batch axis strong scaling: fixed total
   batch over K ∈ {1,2,4,8} devices.
4. ``payload_model`` — the analytic per-iteration collective payload of the
   horizon path (bytes that would cross the interconnect), next to the
   interior bytes each device streams from its memory: the communication:compute
   ratio that governs real-mesh efficiency.

Run on the 8-virtual-device CPU mesh (default; forces the CPU platform).
TWO confounds make raw virtual-mesh throughput curves meaningless as
hardware predictions, so the harness controls for them explicitly:

* the host has few physical cores (reported in the output) — virtual
  devices timeshare them, capping any speedup at the core count;
* XLA:CPU's intra-op threadpool already parallelizes the K=1 baseline
  across all cores, so sharding can only LOSE throughput on one host.

``--one-core`` pins the whole process to a single core
(``os.sched_setaffinity``): every K then gets identical compute, and the
measured curve isolates the pure *sharding overhead* (partitioning,
collectives, padding) — the quantity that, combined with the analytic
payload model (section 4), predicts real-mesh efficiency where the
interior work genuinely divides by K.

Usage: python benchmarks/scaling.py [--quick] [--one-core]
       [--w-horizon 10000]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

# CPU mesh by default — this is the multi-device harness.  Must be set
# before JAX initializes the backend.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

if "--one-core" in sys.argv:
    os.sched_setaffinity(0, {0})

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def emit(name, value, unit, extra=None):
    rec = {"metric": name, "value": round(float(value), 3), "unit": unit}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def sync(tree):
    return float(sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(tree)))


def timeit(fn, *args, reps=5):
    """Min-of-reps wall time (the host runs other work; min is the honest
    estimate of the program's cost on a quiet machine)."""
    out = fn(*args)
    sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        out = fn(*args)
        sync(out)
        best = min(best, time.time() - t0)
    return best


def synthetic_tridiag(W, B, dtype):
    key = jax.random.PRNGKey(7)
    blocks = jax.random.normal(key, (W, B, B), dtype)
    diag = jnp.einsum("tij,tkj->tik", blocks, blocks) + 5.0 * jnp.eye(
        B, dtype=dtype
    )
    lower = 0.2 * jax.random.normal(jax.random.PRNGKey(8), (W - 1, B, B), dtype)
    b = jax.random.normal(jax.random.PRNGKey(9), (W, B), dtype)
    return diag, lower, b


def long_trajectory_qp(W, N, dtype):
    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        with_gomp_boxes,
    )
    from osqp_solver_tpu.parallel.banded import banded_from_trajectory

    base = empty_trajectory_qp(W, N, gripper_flags=(), n_obstacles=0, dtype=dtype)
    qp = with_gomp_boxes(
        base,
        jnp.zeros(N, dtype),
        jnp.ones(N, dtype),
        (jnp.full(N, -10.0, dtype), jnp.full(N, 10.0, dtype)),
        (jnp.full(N, -1.0, dtype), jnp.full(N, 1.0, dtype)),
        (jnp.full(N, -2.0, dtype), jnp.full(N, 2.0, dtype)),
    )
    return banded_from_trajectory(qp)[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--one-core", action="store_true")
    ap.add_argument("--w-horizon", type=int, default=10000)
    ap.add_argument("--w-admm", type=int, default=4096)
    ap.add_argument("--fixed-iters", type=int, default=40)
    args = ap.parse_args()

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from osqp_solver_tpu.ops import admm
    from osqp_solver_tpu.ops.tridiag import (
        block_tridiag_factor,
        block_tridiag_solve,
    )
    from osqp_solver_tpu.parallel.batch import solve_batch_sharded
    from osqp_solver_tpu.parallel.mesh import make_mesh
    from osqp_solver_tpu.parallel.schur import schur_factor, schur_solve_cached

    dtype = jnp.float32
    reps = 3 if args.quick else 10
    n_dev = len(jax.devices())
    cores = len(os.sched_getaffinity(0))
    mode = "one-core (pure sharding overhead)" if args.one_core else "all-cores"
    log(f"devices: {n_dev} virtual on {cores} usable cores [{mode}]")

    # ---- 1. cached-factor KKT solve: sequential vs chunked, ONE device ----
    W5 = 2000 if args.quick else args.w_horizon
    Bb = 12
    diag, lower, b = synthetic_tridiag(W5, Bb, dtype)
    f_seq = jax.jit(block_tridiag_solve)
    fac_seq = jax.jit(block_tridiag_factor)(diag, lower)
    sync(fac_seq)
    t_seq = timeit(f_seq, fac_seq, b, reps=reps)
    extra = {"sequential_ms": round(t_seq * 1e3, 3), "W": W5, "B": Bb}
    for K in (2, 4, 8):
        f_sch = jax.jit(lambda f, b: schur_solve_cached(f, b))
        fac = jax.jit(lambda d, l: schur_factor(d, l, K))(diag, lower)
        sync(fac)
        t_k = timeit(f_sch, fac, b, reps=reps)
        extra[f"schur_K{K}_ms"] = round(t_k * 1e3, 3)
        extra[f"schur_K{K}_vs_seq"] = round(t_seq / t_k, 3)
    emit(
        "kkt_cached_solve_single_device",
        extra["schur_K8_vs_seq"],
        "x sequential (cached-factor solve, vmapped chunks, 1 device)",
        extra,
    )

    # ---- 2. horizon-sharded full ADMM, fixed iterations, K=1..8 -----------
    from osqp_solver_tpu.parallel.banded import solve_banded_sharded

    W2 = 1024 if args.quick else args.w_admm
    N2 = 6
    banded = long_trajectory_qp(W2, N2, dtype)
    F = args.fixed_iters
    # Unreachable tolerances → exactly F iterations on every path; adaptive
    # ρ off so no refactorization noise.  iters/s includes the amortized
    # termination checks (the honest per-iteration cost).
    s_fixed = dataclasses.replace(
        admm.Settings(),
        eps_abs=1e-30, eps_rel=1e-30, max_iter=F, adaptive_rho=False,
    )
    f_base = jax.jit(lambda qp: admm.solve(qp, s_fixed))
    t_base = timeit(f_base, banded, reps=max(2, reps // 2))
    extra2 = {
        "sequential_1dev_iters_per_sec": round(F / t_base, 1),
        "W": W2, "N": N2, "fixed_iters": F,
        "usable_cores": cores, "mode": mode,
    }
    base_ips = F / t_base
    for K in (1, 2, 4, 8):
        mesh = make_mesh(batch=1, horizon=K)
        t_k = timeit(
            lambda qp: solve_banded_sharded(qp, mesh, s_fixed),
            banded,
            reps=max(2, reps // 2),
        )
        ips = F / t_k
        extra2[f"K{K}_iters_per_sec"] = round(ips, 1)
        extra2[f"K{K}_speedup_vs_seq"] = round(ips / base_ips, 3)
    for K in (2, 4, 8):
        extra2[f"K{K}_eff_vs_K1"] = round(
            extra2[f"K{K}_iters_per_sec"]
            / (K * extra2["K1_iters_per_sec"]),
            3,
        )
    emit(
        "horizon_admm_iters_per_sec_K8",
        extra2["K8_iters_per_sec"],
        "ADMM iters/s (horizon-sharded, virtual CPU mesh)",
        extra2,
    )

    # ---- 3. batch-axis strong scaling --------------------------------------
    from benchmarks_common import build_batch  # local helper below

    B3 = 64 if args.quick else 256
    W3, N3 = (24, 3) if args.quick else (50, 6)
    qps = build_batch(B3, W=W3, N=N3, dtype=dtype)
    s3 = admm.Settings()
    extra3 = {"total_batch": B3, "W": W3, "N": N3, "usable_cores": cores,
              "mode": mode}
    base3 = None
    for K in (1, 2, 4, 8):
        mesh = make_mesh(batch=K, horizon=1)
        t_k = timeit(
            lambda q: solve_batch_sharded(q, mesh, s3), qps,
            reps=max(2, reps // 2),
        )
        qps_s = B3 / t_k
        if base3 is None:
            base3 = qps_s
        extra3[f"K{K}_qps_per_sec"] = round(qps_s, 1)
        extra3[f"K{K}_eff_vs_K1"] = round(qps_s / (K * base3), 3)
    emit(
        "batch_admm_qps_per_sec_K8",
        extra3["K8_qps_per_sec"],
        "QPs/s (batch-sharded, virtual CPU mesh)",
        extra3,
    )

    # ---- 4. analytic per-iteration collective payload model --------------
    # Horizon path, per ADMM iteration, per device (parallel/banded.py):
    #   x-update KKT solve: all_gather of (bs, r_right, r_left) = 3·B floats
    #     → each device receives 3·K·B;
    #   A_matvec (z-update): 1 ppermute halo of B floats;
    #   AT_matvec (rhs): 1 halo;  (P_matvec only at termination checks)
    # Per check (every check_termination iters): +2 halos + psum/pmax of
    # ~12 scalars.  NOTHING scales with W (pinned by
    # tests/test_banded.py::test_sharded_communication_is_separator_only).
    B2 = 2 * N2
    bytes_per_iter = (3 * 8 * B2 + 2 * B2) * 4  # K=8, f32
    r_rows = banded.rows_per_wp
    interior_bytes = (
        # factor stream (diag chol + gain) fwd+bwd + U/V corrections
        (4 + 2) * (W2 // 8) * B2 * B2 * 4
        # + A/AT matvec streams
        + 2 * (W2 // 8) * r_rows * B2 * 4
    )
    emit(
        "horizon_payload_model",
        bytes_per_iter,
        "bytes/iteration/device crossing the interconnect at K=8 (analytic)",
        {
            "interior_hbm_bytes_per_iter_per_device": interior_bytes,
            "comm_to_compute_byte_ratio": round(
                bytes_per_iter / interior_bytes, 6
            ),
            "note": (
                "payload independent of W; on a real interconnect it is "
                "not measured yet"
            ),
        },
    )


if __name__ == "__main__":
    main()
