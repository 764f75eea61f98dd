"""Headline benchmark: batched trajectory QPs solved per second — HONEST class.

The headline metric solves the full-GOMP QP class of the reference example
(``/root/reference/examples/solver-example.cpp:37-51``): 100-waypoint 6-DOF
UR5e trajectory QPs carrying two RobotBall linearizations (wrist r=0.15
non-gripper, tool r=0.05 gripper → 3 workspace rows/waypoint with dense 3×6
Jacobian blocks) plus one HorizontalLine obstacle (2 Z-rows/waypoint), the
workspace floor y ≥ −0.4 — not the box-only class (reported as a secondary
metric).  The reference's full 10-segment time-scaling search at W=50 is the
third number.

Needs a GPU: with no accelerator it exits non-zero and prints no result.
Prints ONE JSON line: {"metric", "value", "unit", "device", ...extras}.
All diagnostics, the device among them, go to stderr.

    python bench.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_honest_batch(batch, W, N, dtype):
    import jax
    import jax.numpy as jnp

    from osqp_solver_tpu.gomp.geometry import HorizontalLine
    from osqp_solver_tpu.gomp.trajectory import calc_warm_start_jnp
    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        linearize_workspace,
        with_gomp_boxes,
    )
    from osqp_solver_tpu.models import ur5e

    DT, INF = 0.1, 1e30
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
    base = empty_trajectory_qp(
        W, N, gripper_flags=(False, True), n_obstacles=1, dtype=dtype
    )

    def one(i):
        start = 0.02 * jnp.sin(jnp.arange(N, dtype=dtype) + i)
        end = jnp.asarray([np.pi, 0, 0, 0, 0, 0], dtype) + 0.02 * jnp.cos(
            jnp.arange(N, dtype=dtype) * 1.3 + i
        )
        qp = with_gomp_boxes(base, start, end, pos, vel, acc)
        warm = calc_warm_start_jnp(start, end, W)
        return linearize_workspace(qp, balls, obstacles, con3d, warm)

    # out_axes=-1: the vmapped assembly writes the batch-trailing (lane-major)
    # layout directly — the whole solve then runs with zero relayouts.
    from osqp_solver_tpu.gomp.trajectory_qp_lane import from_trailing

    build = jax.jit(jax.vmap(one, out_axes=-1))
    # The vmapped FK/jacfwd build materializes (B, W, 4, 6, 4) DH-chain
    # temporaries far larger than the QP itself; at long horizons build in
    # batch slices (one-time cost, outside the measured loop) and
    # concatenate on the trailing batch axis.
    slice_b = batch if batch * W <= 256 * 802 else max(128, (256 * 802) // W)
    if slice_b >= batch:
        qp_t = build(jnp.arange(batch, dtype=dtype))
    else:
        parts = [
            build(jnp.arange(i, min(i + slice_b, batch), dtype=dtype))
            for i in range(0, batch, slice_b)
        ]
        qp_t = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=-1), *parts
        )
    return from_trailing(
        qp_t,
        row_layout="waypoint",  # per-waypoint rows: the fused chunk kernel's layout
    )


def build_box_batch(batch, W, N, dtype):
    import jax
    import jax.numpy as jnp

    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        with_gomp_boxes,
    )

    base = empty_trajectory_qp(W, N, gripper_flags=(), n_obstacles=0, dtype=dtype)
    pos = (jnp.full(N, -10.0, dtype), jnp.full(N, 10.0, dtype))
    vel = (jnp.full(N, -1.0, dtype), jnp.full(N, 1.0, dtype))
    acc = (jnp.full(N, -2.0, dtype), jnp.full(N, 2.0, dtype))

    def one(i):
        start = 0.02 * jnp.sin(jnp.arange(N, dtype=dtype) + i)
        end = 1.0 + 0.02 * jnp.cos(jnp.arange(N, dtype=dtype) * 1.3 + i)
        return with_gomp_boxes(base, start, end, pos, vel, acc)

    from osqp_solver_tpu.gomp.trajectory_qp_lane import from_trailing

    return from_trailing(
        jax.vmap(one, out_axes=-1)(jnp.arange(batch, dtype=dtype)),
        row_layout="waypoint",
    )


def solve_settings():
    """Solver settings of the honest and box-only cells (environment
    overrides: OSQP_RHO0, OSQP_CT, OSQP_SCALING, OSQP_ALPHA,
    OSQP_FUSED_CHUNK, OSQP_WARMUP)."""
    from osqp_solver_tpu.ops import admm

    # OSQP-default tolerances (eps_abs = eps_rel = 1e-3, unchanged); initial
    # ρ, Ruiz iteration count, and the termination-check cadence are pure
    # performance knobs.  Exact-count sweeps (check_termination=1 on the
    # CPU harness — f32 iteration counts are platform-independent,
    # BASELINE.md): the honest class converges from ρ0 = 0.04 WITHOUT ρ
    # adaptation in fewer iterations than from the OSQP default ρ = 0.1 with
    # an early adaptation (which extended the tail), and 3 Ruiz iterations
    # equilibrate this class as well as 10.  Adaptation stays ON as a
    # safety net but deferred to iteration 45, past the measured worst
    # case, so no refactor fires on the benchmark class while pathological
    # problems still recover.
    # OSQP_CT: termination cadence — ADMM residuals OSCILLATE around the
    # tolerance, so a coarser cadence executes more iterations; a finer one
    # pays more per-check fixed cost.  Default 2.
    return dataclasses.replace(
        admm.Settings(), rho=float(os.environ.get("OSQP_RHO0", "0.04")),
        check_termination=int(os.environ.get("OSQP_CT", "2")),
        adaptive_rho_interval=45,
        scaling=int(os.environ.get("OSQP_SCALING", "3")),
        alpha=float(os.environ.get("OSQP_ALPHA", "1.6")),
        fused_chunk=os.environ.get("OSQP_FUSED_CHUNK", "auto"),
        # Cold solves of this class never finish before iteration 22
        # (exact-count sweeps) — one unchecked warmup chunk skips the early
        # checks' fixed costs without changing any termination decision.
        termination_warmup=int(os.environ.get("OSQP_WARMUP", "21")),
    )


def batch_solver(settings):
    """The jitted batch solve of the honest and box-only cells.  The smoke
    test calls the same function, so the two share compiled programs
    through the persistent compile cache."""
    import jax

    from osqp_solver_tpu.ops.admm_lane import solve_batched_lane

    return jax.jit(lambda qps: solve_batched_lane(qps, settings))


def main():
    import jax

    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    log(f"device: platform={device['platform']} kind={device['kind']} "
        f"count={device['count']}")
    if dev.platform != "gpu":
        log("FATAL: no GPU found; bench.py measures the accelerator only")
        sys.exit(2)

    dtype = jnp.float32
    BATCH, W, N = 1024, 100, 6
    settings = solve_settings()
    log(f"settings: fused_chunk={settings.fused_chunk} "
        f"ct={settings.check_termination} "
        f"rho0={settings.rho} alpha={settings.alpha} "
        f"warmup={settings.termination_warmup}")
    solve = batch_solver(settings)

    def measure(qps, label, reps=10):
        t0 = time.time()
        res = jax.block_until_ready(solve(qps))
        log(f"[{label}] compile+first run: {time.time() - t0:.2f}s")
        n_opt = int(np.sum(np.asarray(res.status) == 0))
        iters = np.asarray(res.iterations)
        med_iters = int(np.median(iters))
        log(
            f"[{label}] optimal: {n_opt}/{BATCH}  iters p50={med_iters} "
            f"max={int(np.max(iters))}  "
            f"prim_res max={float(np.max(res.prim_res)):.2e}"
        )
        # Steady state: back-to-back solves of the compiled program; each
        # call's host dispatch is included.
        t0 = time.time()
        for _ in range(reps):
            res = solve(qps)
        jax.block_until_ready(res)
        dt = (time.time() - t0) / reps
        log(f"[{label}] steady-state: {dt*1e3:.3f} ms/batch -> {n_opt/dt:.1f} QPs/s")
        return n_opt / dt, med_iters, dt

    t0 = time.time()
    honest = jax.block_until_ready(build_honest_batch(BATCH, W, N, dtype))
    log(f"honest batch build: {time.time() - t0:.1f}s")
    honest_qps, honest_iters, honest_dt = measure(honest, "honest full-GOMP")

    box = build_box_batch(BATCH, W, N, dtype)
    box_qps, box_iters, _ = measure(box, "box-only (secondary)")

    # FLOP accounting for the factor-cached hot loop (per ADMM iteration per
    # problem): banded forward+backward substitution ≈ 2 · (3·B2²·W) flops
    # with B2 = 2N, plus the A/Aᵀ stencil matvecs (~6 flops per nnz).  The
    # loop is a sequential banded recurrence, so this rate is far below any
    # matrix-unit peak by construction.
    B2 = 2 * N
    nnz = (W - 1) * N * 3 + W * N + (W - 1) * N + (W - 2) * N * 2 + W * 3 * N + 2 * W * N
    flops_per_iter = 2 * 3 * B2 * B2 * W + 6 * nnz
    achieved = flops_per_iter * honest_iters * BATCH / honest_dt
    log(f"achieved factor+solve rate: {achieved/1e9:.1f} GFLOP/s")

    # Full search: the reference's complete run(start, end) time-scaling
    # semantics (gomp-solver.h:38-55) at stock solver settings — the
    # in-solver stall detector (Settings.stall_checks, default ON) gives the
    # no-knob rate.  A failure here fails the run.
    from osqp_solver_tpu.ops.status import ExitCode

    fsolver, fstarts, fends = build_full_search(dtype)
    t0f = time.time()
    fout = jax.block_until_ready(fsolver.run_batch_padded(fstarts, fends))
    log(f"[full-search secondary] compile+first: {time.time() - t0f:.1f}s")
    FB = fstarts.shape[0]
    n_opt = int(np.sum(np.asarray(fout[0]) == int(ExitCode.kOptimal)))
    if n_opt != FB:
        log(f"FATAL: full search: {n_opt}/{FB} queries kOptimal")
        sys.exit(1)
    t0f = time.time()
    fouts = [fsolver.run_batch_padded(fstarts, fends) for _ in range(3)]
    jax.block_until_ready(fouts)
    fdt = (time.time() - t0f) / 3
    full_qps = n_opt / fdt
    full_iters_p50 = int(np.median(np.asarray(fout[4])))
    log(
        f"[full-search secondary] optimal {n_opt}/{FB}, "
        f"{fdt*1e3:.3f} ms/batch -> {full_qps:.0f} full queries/s "
        f"at stock settings (stall detection, no max_iter knob)"
    )

    print(
        json.dumps(
            {
                "metric": "honest_trajectory_qps_per_sec_per_chip",
                "value": round(honest_qps, 2),
                "unit": (
                    "QPs/s (100-waypoint 6-DOF UR5e, 2-ball workspace+obstacle "
                    "rows, OSQP 1e-3 accuracy)"
                ),
                "device": device,
                "secondary_box_only_qps_per_sec": round(box_qps, 2),
                "secondary_full_timescaling_queries_per_sec_stock": round(
                    full_qps, 1
                ),
                "full_search_admm_iters_p50": full_iters_p50,
                "median_iterations": honest_iters,
                "factor_solve_gflops": round(achieved / 1e9, 1),
            }
        )
    )


def build_full_search(dtype, batch=1024, waypoints=50, seed=0):
    """The full time-scaling search cell: a ``GOMPSolver`` over the honest
    UR5e keep-outs (2 balls, workspace floor) with 10 segments at W=50, and
    ``batch`` start/end pairs from ``seed``.  Returns ``(solver, starts,
    ends)`` for ``solver.run_batch_padded(starts, ends)``."""
    from osqp_solver_tpu import GOMPSolver, constraints as C
    from osqp_solver_tpu.models import ur5e
    from osqp_solver_tpu.ops import admm

    N, INF = 6, 1e30
    solver = GOMPSolver(
        max_waypoints=waypoints,
        time_step=0.1,
        settings=dataclasses.replace(
            admm.Settings(), rho=0.04, check_termination=3, scaling=3
        ),
        pos_con=C.in_range(N, -2 * np.pi, 2 * np.pi),
        vel_con=C.in_range(N, -np.pi, np.pi),
        acc_con=C.in_range(N, -800 * np.pi / 180, 800 * np.pi / 180),
        con_3d=C.Constraint(
            lower=np.array([-INF, -0.4, -INF]), upper=np.full(3, INF)
        ),
        obstacles=[],
        balls=[
            ur5e.make_ball("back6", 0.15),
            ur5e.make_ball("tool", 0.05, is_gripper=True),
        ],
        segments=10,
        dtype=dtype,
    )
    rng = np.random.default_rng(seed)
    starts = 0.02 * rng.standard_normal((batch, N))
    ends = np.array([np.pi, 0, 0, 0, 0, 0.0])[None] + 0.02 * rng.standard_normal(
        (batch, N)
    )
    return solver, starts, ends


if __name__ == "__main__":
    main()
