"""benchmarks/factor_share.py: the factorization count of a full search."""
import importlib.util
import os

from osqp_solver_tpu.gomp.trajectory_qp_lane import LaneTrajectoryQP
from osqp_solver_tpu.ops import admm_lane

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "factor_share", os.path.join(REPO, "benchmarks", "factor_share.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_count_factorizations_and_restore():
    """Every solve factors at set-up, so a full search has at least as many
    factorizations as solves; the counting wrappers are removed after."""
    factor, solve = LaneTrajectoryQP.kkt_factor, admm_lane.solve_batched_lane
    out = _load().count(batch=2, waypoints=12)
    assert out["solves"] >= 1
    assert out["factorizations"] >= out["solves"]
    assert out["scp_rounds_p50"] >= 1
    assert LaneTrajectoryQP.kkt_factor is factor
    assert admm_lane.solve_batched_lane is solve
