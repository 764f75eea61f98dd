"""Multi-process execution path (DCN analogue): 2 processes × 4 devices.

The only north-star axis with zero artifacts through round 2 was "2+ hosts"
(SURVEY.md §2.3 comm backend, §6; VERDICT r2 next #2).  This harness spawns
two REAL OS processes (each a 4-device virtual CPU host, gloo collectives
over TCP standing in for DCN) and runs both sharded solver paths on the
global 8-device mesh:

* batch-sharded ADMM (``parallel/batch.py``) — 8 problems, one per device,
  split across the process boundary;
* horizon-sharded ADMM (``parallel/banded.py``) — ONE long-horizon QP whose
  Schur separator ``all_gather`` and ``ppermute`` halos cross processes;
* the PLANNER fleet (``GOMPSolver.run_batch_lane_sharded``, round 5) — 8
  full SCP planning queries whose batch axis spans the two processes,
  result equal to the single-device path to 1e-8.

Each worker self-checks against its local single-device reference solve and
writes a JSON verdict; the parent asserts both verdicts.  Worker body:
``osqp_solver_tpu/parallel/multihost.py``.
"""
import json
import pathlib
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.multiprocess
def test_two_process_batch_and_horizon(tmp_path):
    port = _free_port()
    procs, outs = [], []
    for pid in (0, 1):
        out = tmp_path / f"w{pid}.json"
        outs.append(out)
        env = {
            # Clean slate: a minimal environment; workers force the CPU
            # platform themselves.
            "PATH": "/usr/bin:/bin:/usr/local/bin",
            "PYTHONPATH": str(REPO),
            "HOME": "/root",
        }
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "osqp_solver_tpu.parallel.multihost",
                    "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2",
                    "--process-id", str(pid),
                    "--local-devices", "4",
                    "--out", str(out),
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-3000:]}"
    for pid, out in enumerate(outs):
        report = json.loads(out.read_text())
        assert report["num_processes"] == 2, report
        assert report["global_devices"] == 8, report
        assert report["local_devices"] == 4, report
        assert report["ok"], f"worker {pid} self-check failed: {report}"
