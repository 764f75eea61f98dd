"""Cross-PROCESS scaling harness (VERDICT r3 next #3): the virtual-mesh
overhead curves of ``benchmarks/scaling.py``, measured ACROSS real OS
process boundaries over gloo-TCP (the DCN stand-in this host can run).

For each device count K, the SAME fixed-iteration sharded program runs on
(a) one process owning all K virtual devices and (b) the mesh split across
P processes (K/P local devices each), gloo collectives crossing the
boundary.  Boundary efficiency = T(1 process) / T(P processes): what the
separator all_gathers / halo ppermutes / batch statuses pay when they leave
the process.  The 1-process baseline is the plain local path (XLA
in-process collectives, exactly benchmarks/scaling.py's programs); P>1 uses
``jax.distributed`` + gloo.  No core pinning: every process sees the whole
host (XLA:CPU sizes its device thread pool from the affinity set, and
gloo's BLOCKING collectives futex-deadlock when a process has more
collective participants than pool threads — measured), so all layouts get
the same total compute and P-process ones timeshare it, which is part of
the overhead being measured.

Both axes are measured:
* horizon — ONE W-step banded QP, full OSQP-semantics ADMM at exactly F
  iterations (tolerances unreachable), horizon-sharded over the global mesh
  (``parallel/banded.py::solve_banded_sharded``); the Schur separator
  exchange crosses the boundary every iteration.
* batch — B independent QPs batch-sharded (``parallel/batch.py``); no
  solver collectives by construction, so this row pins the fixed costs
  (dispatch fan-out, global while-loop consensus) alone.

Usage:  python benchmarks/scaling_multiprocess.py [--w-horizon 4096]
        [--fixed-iters 40] [--batch 64] [--reps 3] [--layouts 1x8,2x4,4x2]
Emits one JSON line per axis with per-layout seconds + boundary efficiency.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------


def worker(args) -> None:
    # No core pinning: XLA:CPU sizes its device thread pool from the
    # affinity set, and gloo's BLOCKING collectives deadlock when a process
    # has more local devices in a collective than pool threads (measured:
    # 8 devices on a 4-core affinity futex-hangs).  Every process sees the
    # whole host; 1-process and P-process layouts get the same total
    # compute, P-process ones just timeshare it — which is the overhead
    # being measured.
    import jax

    jax.config.update("jax_platforms", "cpu")
    from osqp_solver_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.num_processes == 1:
        # The no-boundary BASELINE is the plain local path (same as
        # benchmarks/scaling.py): XLA's in-process collectives, no gloo.
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.local_devices}"
            ).strip()
    else:
        from osqp_solver_tpu.parallel.multihost import initialize

        initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            local_device_count=args.local_devices,
        )
    import dataclasses

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from benchmarks_common import build_batch
    from osqp_solver_tpu.ops import admm
    from osqp_solver_tpu.parallel.banded import solve_banded_sharded
    from osqp_solver_tpu.parallel.batch import solve_batch_sharded
    from osqp_solver_tpu.parallel.mesh import make_mesh
    from osqp_solver_tpu.parallel.multihost import replicate_to_global

    dtype = jnp.float32
    K = len(jax.devices())
    out: dict = {
        "process": jax.process_index(),
        "num_processes": jax.process_count(),
        "devices": K,
    }

    def timed(fn, tree, reps):
        multihost_utils.sync_global_devices("warm")
        r = fn(tree)  # compile + first run
        jax.block_until_ready(r)
        multihost_utils.sync_global_devices("start")
        t0 = time.time()
        for _ in range(reps):
            r = fn(tree)
        jax.block_until_ready(r)
        multihost_utils.sync_global_devices("stop")
        return (time.time() - t0) / reps

    # ---- horizon axis ------------------------------------------------------
    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        with_gomp_boxes,
    )
    from osqp_solver_tpu.parallel.banded import banded_from_trajectory

    N = 6
    base = empty_trajectory_qp(
        args.w_horizon, N, gripper_flags=(), n_obstacles=0, dtype=dtype
    )
    qp = with_gomp_boxes(
        base, jnp.zeros(N, dtype), jnp.ones(N, dtype),
        (jnp.full(N, -10.0, dtype), jnp.full(N, 10.0, dtype)),
        (jnp.full(N, -1.0, dtype), jnp.full(N, 1.0, dtype)),
        (jnp.full(N, -2.0, dtype), jnp.full(N, 2.0, dtype)),
    )
    banded = banded_from_trajectory(qp)[0]
    s_fixed = dataclasses.replace(
        admm.Settings(),
        eps_abs=1e-30, eps_rel=1e-30, max_iter=args.fixed_iters,
        adaptive_rho=False,
    )
    mesh_h = make_mesh(batch=1, horizon=K)
    banded_g = replicate_to_global(banded, mesh_h)
    out["horizon_s"] = timed(
        lambda q: solve_banded_sharded(q, mesh_h, s_fixed), banded_g,
        args.reps,
    )

    # ---- batch axis (same class as scaling.py section 3 full mode) --------
    qps = build_batch(args.batch, W=50, N=6, dtype=dtype)
    mesh_b = make_mesh(batch=K, horizon=1)
    qps_g = replicate_to_global(qps, mesh_b)
    out["batch_s"] = timed(
        lambda q: solve_batch_sharded(q, mesh_b, admm.Settings()), qps_g,
        args.reps,
    )

    if jax.process_index() == 0:
        pathlib.Path(args.out).write_text(json.dumps(out))
    multihost_utils.sync_global_devices("done")


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def launch(layout: str, args) -> dict:
    P, L = (int(v) for v in layout.split("x"))
    port = _free_port()
    outp = f"/tmp/scaling_mp_{layout}.json"
    procs = []
    for pid in range(P):
        env = {
            "PATH": "/usr/bin:/bin:/usr/local/bin",
            "PYTHONPATH": str(REPO),
            "HOME": "/root",
        }
        procs.append(subprocess.Popen(
            [
                sys.executable, __file__, "--worker",
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(P),
                "--process-id", str(pid),
                "--local-devices", str(L),
                "--out", outp,
                "--w-horizon", str(args.w_horizon),
                "--fixed-iters", str(args.fixed_iters),
                "--batch", str(args.batch),
                "--reps", str(args.reps),
            ],
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL if args.quiet else None,
        ))
    try:
        rc = [p.wait(timeout=1800) for p in procs]
    except subprocess.TimeoutExpired:
        # A deadlocked layout (e.g. 2x4 on a 4-core host — see --layouts
        # help) must not leak frozen workers: kill the whole set so a
        # retry/re-run doesn't contend with orphans, and surface the same
        # RuntimeError the caller already handles.
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise RuntimeError((layout, "timeout — workers killed"))
    if any(r != 0 for r in rc):
        raise RuntimeError((layout, rc))
    return json.loads(pathlib.Path(outp).read_text())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=8)
    ap.add_argument("--out", default="/tmp/scaling_mp.json")
    ap.add_argument("--w-horizon", type=int, default=4096)
    ap.add_argument("--fixed-iters", type=int, default=40)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument(
        "--layouts", default="1x2,2x1,1x4,2x2,1x8,4x2",
        help="comma list of PxL (processes x local devices); 2x4 is "
             "excluded by default — 4 gloo participants per process "
             "deadlock on this 4-core host (blocking collectives vs "
             "core-sized thread pool)",
    )
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return

    results = {}
    for layout in args.layouts.split(","):
        t0 = time.time()
        try:
            results[layout] = launch(layout, args)
        except RuntimeError as e:
            # XLA:CPU aborts flakily under memory pressure right after a
            # big layout exits (same class as the known compile-SEGFAULT
            # quirk, CLAUDE.md) — one clean retry.
            log(f"{layout}: worker failure {e}; retrying once")
            time.sleep(5)
            results[layout] = launch(layout, args)
        log(f"{layout}: horizon {results[layout]['horizon_s']*1e3:.0f} ms, "
            f"batch {results[layout]['batch_s']*1e3:.0f} ms "
            f"[{time.time()-t0:.0f}s total]")

    for axis in ("horizon", "batch"):
        extra = {
            "w_horizon": args.w_horizon, "fixed_iters": args.fixed_iters,
            "batch": args.batch, "cores_total": os.cpu_count(),
        }
        effs = []
        for layout, r in results.items():
            P, L = (int(v) for v in layout.split("x"))
            K = P * L
            extra[f"{layout}_s"] = round(r[f"{axis}_s"], 4)
            single = results.get(f"1x{K}")
            if P > 1 and single is not None:
                eff = single[f"{axis}_s"] / r[f"{axis}_s"]
                extra[f"{layout}_boundary_eff"] = round(eff, 3)
                effs.append(eff)
        print(json.dumps({
            "metric": f"multiprocess_{axis}_boundary_efficiency",
            "value": round(min(effs), 3) if effs else None,
            "unit": "T(1 process)/T(P processes), same K devices, same "
                    "total cores (gloo-TCP boundary; 1.0 = free)",
            **extra,
        }))


if __name__ == "__main__":
    main()
