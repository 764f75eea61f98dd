"""Smoke test of the main path on an NVIDIA GPU, at full width.

One process drives the card through the entry points a user calls and
checks every result on the host.  CPU references run in this process on
``jax.devices("cpu")``; no second process ever opens the card.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # phase 5 only, on four cards

Phases (one card):
  1. honest class — ``solve_batched_lane`` on 1024 W=100 6-DOF UR5e QPs
     (2 balls, workspace floor, 1 obstacle) with ``bench.py``'s settings,
     through the fused chunk kernel;
  2. box-only class — the same checks, with the same settings (so through
     the fused chunk kernel, at the box-only row count);
  3. fused chunk kernel against the XLA path on the honest batch;
  4. full search — ``GOMPSolver.run_batch_padded`` at W=50, batch 1024,
     through the fused chunk kernel.
Phase 5 (``--four-cards``): ``run_batch_padded_sharded`` on a 4-card batch
mesh and ``solve_horizon_sharded`` of one long-horizon QP on a 4-card
horizon mesh, each against the one-card path.

Exits non-zero, with no result line, when no GPU is found or any check
fails.  The last line of stdout is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

EPS = 1e-3  # OSQP's eps_abs = eps_rel, the bench settings' tolerances
# Host f64 recomputation of a residual from the solver's f32 iterate differs
# from the solver's own f32 value by rounding (~1e-6 of the norms); a 1%
# slack on the OSQP bound absorbs that and nothing else.
RESIDUAL_SLACK = 1.01
# Two points that each meet the 1e-3 tolerances of the same convex QP can
# differ along weakly curved directions by O(sqrt(eps)) — sqrt(2e-3) ≈ 0.045
# for unit curvature — whatever the arithmetic (f32 GPU, f64 CPU, kernel or
# XLA).  Entries are O(1) rad and rad/s.
X_ATOL = 5e-2
# The kernel and the XLA chunk path run the same f32 iterations, to the
# same iteration counts (checked), so they differ only by f32 summation
# order carried through ~30 iterations: 1.5e-3 was read on an H100.  The
# same holds for one batch solved on four cards against one card.
X_SAME_F32_ATOL = 5e-3
N_REF = 32  # problems re-solved on the CPU per class
LONG_W = 802  # the reference example's horizon (solver-example.cpp)


class CheckFailed(Exception):
    pass


T0 = time.time()


def say(*a):
    print(f"[{time.time() - T0:7.1f}s]", *a, flush=True)


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out


def timed(fn, *args, reps=3):
    """(seconds per call, result) after one warm-up call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.time()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return (time.time() - t0) / reps, out


def residual_check(lane, res, cpu):
    """OSQP's unscaled primal/dual residuals of every solution, in f64 on
    the host, against eps_abs = eps_rel = 1e-3.  Returns the worst ratio of
    residual to bound over the batch for each."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True), jax.default_device(cpu):
        qp = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), lane
        )
        x = jnp.asarray(np.asarray(res.x, np.float64).T)
        y = jnp.asarray(np.asarray(res.y, np.float64).T)
        z = jnp.asarray(np.asarray(res.z, np.float64).T)

        @jax.jit
        def ratios(qp, x, y, z):
            inf = lambda v: jnp.max(jnp.abs(v), axis=0)  # noqa: E731
            Ax, Px, ATy = qp.A_matvec(x), qp.P_matvec(x), qp.AT_matvec(y)
            prim = inf(Ax - z) / (EPS + EPS * jnp.maximum(inf(Ax), inf(z)))
            dual = inf(Px + qp.q + ATy) / (
                EPS + EPS * jnp.maximum(jnp.maximum(inf(Px), inf(ATy)), inf(qp.q))
            )
            # z is the box projection, unscaled from the solver's f32
            # iterate: inside [l, u] up to f32 rounding of the scaling.
            out = jnp.maximum(jnp.maximum(qp.l - z, z - qp.u), 0.0)
            in_box = jnp.all(out <= 1e-6 * (1.0 + jnp.abs(z)), axis=0)
            return prim, dual, in_box

        prim, dual, in_box = (np.asarray(v) for v in ratios(qp, x, y, z))
    check(np.all(in_box), "returned z outside [l, u]")
    check(np.all(prim <= RESIDUAL_SLACK), f"primal residual over bound: max ratio {prim.max():.4f}")
    check(np.all(dual <= RESIDUAL_SLACK), f"dual residual over bound: max ratio {dual.max():.4f}")
    return float(prim.max()), float(dual.max())


def cpu_solve(lane, idx, settings, dtype, cpu):
    """The same QPs (batch columns ``idx``), solved on the CPU."""
    import jax
    import jax.numpy as jnp

    from osqp_solver_tpu.ops.admm_lane import solve_batched_lane

    sub = jax.tree_util.tree_map(lambda a: np.asarray(a)[..., idx], lane)
    with jax.enable_x64(dtype == np.float64), jax.default_device(cpu):
        sub = jax.device_put(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), sub), cpu
        )
        res = jax.jit(lambda q: solve_batched_lane(q, settings))(sub)
        return (np.asarray(res.status), np.asarray(res.x),
                np.asarray(res.iterations))


def class_phase(name, lane, settings, cpu):
    """Phases 1-2: solve on the card, check every solution, compare a
    sample with the CPU."""
    import jax

    from bench import batch_solver
    from osqp_solver_tpu.ops.status import ExitCode

    solve = batch_solver(settings)
    t0 = time.time()
    res = jax.block_until_ready(solve(lane))
    compile_s = time.time() - t0
    dt, res = timed(solve, lane)
    B = lane.batch
    status = np.asarray(res.status)
    iters = np.asarray(res.iterations)
    n_opt = int(np.sum(status == ExitCode.kOptimal))
    check(np.all(np.isfinite(np.asarray(res.x))), f"{name}: non-finite x")
    check(n_opt == B, f"{name}: {n_opt}/{B} kOptimal")
    prim, dual = residual_check(lane, res, cpu)

    idx = np.arange(0, B, B // N_REF)[:N_REF]
    st64, x64, _ = cpu_solve(lane, idx, settings, np.float64, cpu)
    st32, _, it32 = cpu_solve(lane, idx, settings, np.float32, cpu)
    check(np.array_equal(st64, status[idx]), f"{name}: statuses differ from CPU f64")
    dx = float(np.max(np.abs(np.asarray(res.x)[idx] - x64)))
    check(dx <= X_ATOL, f"{name}: max |x - x_cpu_f64| = {dx:.3e} > {X_ATOL}")
    say(
        f"[{name}] {n_opt}/{B} kOptimal; f64 residual/bound max: primal "
        f"{prim:.4f} dual {dual:.4f}; iterations p50 {int(np.median(iters))} "
        f"max {int(iters.max())} (sample of {len(idx)}: card p50 "
        f"{int(np.median(iters[idx]))} max {int(iters[idx].max())}, CPU f32 "
        f"p50 {int(np.median(it32))} max {int(it32.max())}); CPU f64 "
        f"statuses equal, max |dx| {dx:.2e}; compile+first {compile_s:.1f} s, "
        f"{dt * 1e3:.3f} ms/batch"
    )
    return res, dt


def kernel_phase(lane, settings, res_kernel, dt_kernel):
    """Phase 3: the same batch through the XLA path."""
    from bench import batch_solver
    from osqp_solver_tpu.ops import backend

    check(backend.admm_chunk(lane, settings) == backend.TRITON,
          "kernel phase: the backend did not select the fused chunk kernel")
    off = dataclasses.replace(settings, fused_chunk="off")
    dt_xla, res_xla = timed(batch_solver(off), lane)
    st_k, st_x = np.asarray(res_kernel.status), np.asarray(res_xla.status)
    check(np.array_equal(st_k, st_x), "kernel phase: statuses differ from XLA")
    it_k, it_x = np.asarray(res_kernel.iterations), np.asarray(res_xla.iterations)
    check(np.array_equal(it_k, it_x),
          f"kernel phase: {int(np.sum(it_k != it_x))} iteration counts differ from XLA")
    dx = float(np.max(np.abs(np.asarray(res_kernel.x) - np.asarray(res_xla.x))))
    check(dx <= X_SAME_F32_ATOL,
          f"kernel phase: max |x_kernel - x_xla| = {dx:.3e} > {X_SAME_F32_ATOL}")
    say(
        f"[kernel vs XLA] statuses and iteration counts identical, max |dx| "
        f"{dx:.2e}; honest batch {dt_kernel * 1e3:.3f} ms (kernel) vs "
        f"{dt_xla * 1e3:.3f} ms (XLA)"
    )


def full_search_phase(cpu):
    """Phase 4: the reference's 10-segment time-scaling search."""
    import jax
    import jax.numpy as jnp

    from bench import build_full_search
    from osqp_solver_tpu.ops.status import ExitCode

    solver, starts, ends = build_full_search(jnp.float32)
    t0 = time.time()
    out = jax.block_until_ready(solver.run_batch_padded(starts, ends))
    compile_s = time.time() - t0
    dt, out = timed(solver.run_batch_padded, starts, ends)
    status, traj, horizon = (np.asarray(v) for v in out[:3])
    B = len(status)
    n_opt = int(np.sum(status == ExitCode.kOptimal))
    check(n_opt == B, f"full search: {n_opt}/{B} kOptimal")
    check(np.all(np.isfinite(traj)), "full search: non-finite trajectory")

    ref_solver, _, _ = build_full_search(jnp.float32)
    with jax.default_device(cpu):
        ref = ref_solver.run_batch_padded(starts[:8], ends[:8])
        ref_status, _, ref_h = (np.asarray(v) for v in ref[:3])
    check(np.array_equal(ref_status, status[:8]), "full search: statuses differ from CPU")
    check(np.array_equal(ref_h, horizon[:8]), "full search: winning horizons differ from CPU")
    iters = np.asarray(out[4])
    say(
        f"[full search] {n_opt}/{B} kOptimal, winning horizon p50 "
        f"{int(np.median(horizon))}, ADMM iterations/query p50 "
        f"{int(np.median(iters))}; 8 queries match the CPU (statuses, "
        f"horizons); compile+first {compile_s:.1f} s, {dt * 1e3:.3f} ms/batch"
    )


def four_card_phase():
    """Phase 5: batch-sharded full search and horizon-sharded ADMM on four
    cards against the one-card paths."""
    import jax
    import jax.numpy as jnp

    from bench import build_full_search
    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        with_gomp_boxes,
    )
    from osqp_solver_tpu.ops import admm
    from osqp_solver_tpu.ops.status import ExitCode
    from osqp_solver_tpu.parallel.horizon import solve_horizon_sharded
    from osqp_solver_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    check(len(devs) == 4, f"--four-cards needs 4 GPUs, found {len(devs)}")

    solver, starts, ends = build_full_search(jnp.float32)
    mesh = make_mesh(batch=4, horizon=1)
    t0 = time.time()
    sh = jax.block_until_ready(solver.run_batch_padded_sharded(starts, ends, mesh))
    compile_s = time.time() - t0
    dt4, sh = timed(lambda: solver.run_batch_padded_sharded(starts, ends, mesh))
    placed = {d for d in sh[1].sharding.device_set}
    check(len(placed) == 4, f"sharded planner placed its output on {len(placed)} device(s)")
    with jax.default_device(devs[0]):
        dt1, one = timed(solver.run_batch_padded, starts, ends)
    st4, st1 = np.asarray(sh[0]), np.asarray(one[0])
    check(np.all(st1 == ExitCode.kOptimal), "one-card full search not all kOptimal")
    check(np.array_equal(st4, st1), "sharded statuses differ from one card")
    check(np.array_equal(np.asarray(sh[2]), np.asarray(one[2])),
          "sharded horizons differ from one card")
    dtraj = float(np.max(np.abs(np.asarray(sh[1]) - np.asarray(one[1]))))
    check(dtraj <= X_SAME_F32_ATOL, f"sharded trajectories differ by {dtraj:.3e}")
    say(
        f"[4-card full search] {int(np.sum(st4 == ExitCode.kOptimal))}/"
        f"{len(st4)} kOptimal, statuses and horizons identical to one card, "
        f"max |dtraj| {dtraj:.2e}; compile+first {compile_s:.1f} s; "
        f"{dt4 * 1e3:.3f} ms/batch on 4 cards vs {dt1 * 1e3:.3f} ms on one"
    )

    W, N, dt = LONG_W, 6, jnp.float32
    qp = with_gomp_boxes(
        empty_trajectory_qp(W, N, dtype=dt),
        jnp.zeros(N, dt), jnp.ones(N, dt),
        (jnp.full(N, -10.0, dt), jnp.full(N, 10.0, dt)),
        (jnp.full(N, -1.0, dt), jnp.full(N, 1.0, dt)),
        (jnp.full(N, -2.0, dt), jnp.full(N, 2.0, dt)),
    )
    settings = admm.Settings()
    hmesh = make_mesh(batch=1, horizon=4)
    check(len(set(hmesh.devices.flat)) == 4, "horizon mesh repeats a device")
    res4 = jax.block_until_ready(solve_horizon_sharded(qp, hmesh, settings))
    with jax.default_device(devs[0]):
        res1 = jax.block_until_ready(jax.jit(lambda q: admm.solve(q, settings))(qp))
    check(int(res4.status) == ExitCode.kOptimal, f"horizon-sharded status {int(res4.status)}")
    check(int(res1.status) == ExitCode.kOptimal, f"one-card status {int(res1.status)}")
    dx = float(np.max(np.abs(np.asarray(res4.x) - np.asarray(res1.x))))
    check(dx <= X_ATOL, f"horizon-sharded x differs by {dx:.3e}")
    say(
        f"[4-card horizon W={W}] kOptimal on both, iterations "
        f"{int(res4.iterations)} (4 cards) vs {int(res1.iterations)} (one), "
        f"max |dx| {dx:.2e}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU found (platform {devs[0].platform!r})", file=sys.stderr)
        return 2
    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    print(card_line(), flush=True)
    say(f"device: {device['kind']} x{device['count']}")

    try:
        if args.four_cards:
            four_card_phase()
        else:
            import jax.numpy as jnp

            import bench

            cpu = jax.devices("cpu")[0]
            settings = bench.solve_settings()
            honest = jax.block_until_ready(
                bench.build_honest_batch(1024, 100, 6, jnp.float32)
            )
            res, dt = class_phase("honest", honest, settings, cpu)
            box = bench.build_box_batch(1024, 100, 6, jnp.float32)
            class_phase("box-only", box, settings, cpu)
            kernel_phase(honest, settings, res, dt)
            full_search_phase(cpu)
    except CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
