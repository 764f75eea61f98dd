"""In-solver stall detection (``Settings.stall_checks``, VERDICT r4 next #2).

A problem whose residual metric max(prim/eps_prim, dual/eps_dual) fails to
improve by ``stall_rtol`` over ``stall_checks`` consecutive termination
checks gives up early THROUGH THE max_iter LADDER — same statuses the
4000-iteration grind would produce (kOptimalInaccurate /
k*InfeasibleInaccurate / kMaxIterations), fewer wasted iterations.  The
native oracle implements the identical rule, so agreement is pinned
exact-count, not just status-for-status.  Planner-level impact (the
default-settings full search recovering the ``max_iter=300`` row with no
knob) is pinned in ``test_planner.py::test_run_padded_stall_default_no_knob``.

Reference anchor: the reference runs OSQP at stock settings and treats any
non-(optimal|unknown) code as give-up (``/root/reference/src/gomp-solver.h:46-51,
72-76``) — stall detection changes WHEN a hopeless solve gives up, never how
the caller sees it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops import admm, admm_lane
from osqp_solver_tpu.ops.admm import Settings, solve
from osqp_solver_tpu.ops.qp import dense_qp
from osqp_solver_tpu.ops.status import ExitCode
from osqp_solver_tpu.utils import oracle

pytestmark = pytest.mark.quick

INF = 1e30


def _plateau_qp():
    """Conflicting equality systems A₀x = b and A₀x = b + 0.05: the primal
    residual floors at the conflict size and never improves.  With the
    infeasibility certificates disabled (eps_*_inf = INF never passes the
    ``norm_dy > eps`` gate) the plateau is the only give-up signal."""
    rng = np.random.default_rng(3)
    n, m = 20, 15
    M = rng.normal(size=(n, n))
    P = M @ M.T / n + 0.1 * np.eye(n)
    q = rng.normal(size=n)
    A0 = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    A = np.vstack([A0, A0])
    l = np.concatenate([b, b + 0.05])
    return P, q, A, l, l.copy()


def test_stall_exits_early_through_max_iter_ladder():
    """Stall ON (default): the plateau exits orders of magnitude before
    max_iter with a max_iter-ladder status; stall OFF: the same problem
    grinds out all 4000 iterations to the same status."""
    qp = dense_qp(*_plateau_qp())
    s = Settings(check_termination=5, eps_prim_inf=INF, eps_dual_inf=INF)
    res = solve(qp, s)
    assert int(res.iterations) < s.max_iter / 4, int(res.iterations)
    assert int(res.status) in (
        ExitCode.kMaxIterations,
        ExitCode.kOptimalInaccurate,
        ExitCode.kPrimalInfeasibleInaccurate,
        ExitCode.kDualInfeasibleInaccurate,
    )
    res_off = solve(qp, dataclasses.replace(s, stall_checks=0))
    assert int(res_off.iterations) == s.max_iter
    assert int(res_off.status) == int(res.status)


def test_stall_does_not_touch_converging_solves():
    """A feasible well-behaved QP solves identically with the detector on
    and off (the window re-arms on every ≥5% improvement)."""
    rng = np.random.default_rng(11)
    n, m = 16, 24
    M = rng.normal(size=(n, n))
    P = M @ M.T / n + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    x0 = rng.normal(size=n)
    l = A @ x0 - 1.0
    u = A @ x0 + 1.0
    qp = dense_qp(P, q, A, l, u)
    on = solve(qp, Settings())
    off = solve(qp, Settings(stall_checks=0))
    assert int(on.status) == int(off.status) == ExitCode.kOptimal
    assert int(on.iterations) == int(off.iterations)
    np.testing.assert_array_equal(np.asarray(on.x), np.asarray(off.x))


@pytest.mark.skipif(not oracle.available(), reason="native oracle unavailable")
def test_stall_oracle_exact_count_agreement():
    """The native oracle implements the identical stall rule: on the pure
    plateau (certificates disabled) both give up at the SAME check with the
    SAME status — exact-count agreement, and both far below max_iter."""
    P, q, A, l, u = _plateau_qp()
    qp = dense_qp(P, q, A, l, u)
    s = Settings(
        check_termination=5, scaling=0, adaptive_rho_interval=5,
        eps_prim_inf=INF, eps_dual_inf=INF,
    )
    rj = solve(qp, s)
    rc = oracle.solve(
        P, q, A, l, u, max_iter=s.max_iter, check_every=5,
        eps_prim_inf=INF, eps_dual_inf=INF,
        stall_checks=s.stall_checks, stall_rtol=s.stall_rtol,
    )
    assert int(rj.status) == rc.status
    assert int(rj.iterations) == rc.iterations
    assert rc.iterations < s.max_iter / 4


@pytest.mark.skipif(not oracle.available(), reason="native oracle unavailable")
def test_stall_oracle_agrees_across_window_sweep():
    """Status-for-status oracle agreement holds across stall windows (the
    sweep analogue of the max_iter sweeps in
    ``test_infeasibility_inaccurate.py``)."""
    P, q, A, l, u = _plateau_qp()
    qp = dense_qp(P, q, A, l, u)
    for sc in (4, 8, 16):
        s = Settings(
            check_termination=5, scaling=0, adaptive_rho_interval=5,
            eps_prim_inf=INF, eps_dual_inf=INF, stall_checks=sc,
        )
        rj = solve(qp, s)
        rc = oracle.solve(
            P, q, A, l, u, max_iter=s.max_iter, check_every=5,
            eps_prim_inf=INF, eps_dual_inf=INF,
            stall_checks=sc, stall_rtol=s.stall_rtol,
        )
        assert (int(rj.status), int(rj.iterations)) == (
            rc.status, rc.iterations,
        ), f"stall_checks={sc}"


def test_stall_lane_matches_vmapped():
    """The lane driver's stall path (shared ``_stall_update`` via
    ``_termination_decide``) freezes each problem at the same check as the
    vmapped reference path: unreachable tolerances force every problem onto
    a plateau; both paths stall, and iteration counts/statuses agree
    per-problem."""
    from tests.test_admm_lane import build_batch  # trajectory-QP batch

    qps = build_batch(honest=False)
    s = Settings(eps_abs=1e-14, eps_rel=1e-14, check_termination=5)
    ref = admm.solve_batched(qps, s)
    lane = admm_lane.solve_batched_lane(qps, s)
    np.testing.assert_array_equal(
        np.asarray(lane.status), np.asarray(ref.status)
    )
    np.testing.assert_array_equal(
        np.asarray(lane.iterations), np.asarray(ref.iterations)
    )
    assert int(np.max(np.asarray(ref.iterations))) < s.max_iter


def test_stall_update_window_semantics():
    """Unit semantics of the window: no-improvement checks accumulate,
    a ≥rtol improvement re-arms, ρ-adaptation resets force a fresh window."""
    s = Settings(stall_checks=3, stall_rtol=0.05)
    B = 2
    st = admm_lane.LaneADMMState(
        x=None, z=None, y=None, dx=None, dy=None,
        rho_bar=jnp.ones(B), rho_vec=None, factor=None,
        iterations=jnp.zeros(B, jnp.int32),
        status=jnp.full(B, ExitCode.kUnknown, jnp.int32),
        done=jnp.zeros(B, bool),
        prim_res=jnp.full(B, jnp.inf), dual_res=jnp.full(B, jnp.inf),
        stall_ref=jnp.full(B, jnp.inf), stall_k=jnp.zeros(B, jnp.int32),
    )
    ones = jnp.ones(B)
    # first check arms the window (metric 1.0 < inf)
    st, stalled = admm._stall_update(st, ones, ones, ones, ones, s)
    assert not bool(jnp.any(stalled)) and list(np.asarray(st.stall_k)) == [0, 0]
    # problem 0 stagnates (same metric), problem 1 improves 50%
    m1 = jnp.array([1.0, 0.5])
    for k in (1, 2):
        st, stalled = admm._stall_update(st, m1, m1, ones, ones, s)
        assert list(np.asarray(st.stall_k)) == [k, 0]
        m1 = m1 * jnp.array([1.0, 0.9])  # p1 keeps improving ≥5%
    st, stalled = admm._stall_update(
        st, jnp.array([1.0, 1e9]), jnp.array([1.0, 1e9]), ones, ones, s
    )
    assert list(np.asarray(stalled)) == [True, False]
    # ρ-adaptation re-arms problem 0's window
    st2 = admm._stall_reset(st, jnp.array([True, False]), s)
    assert float(st2.stall_ref[0]) == np.inf and int(st2.stall_k[0]) == 0


def test_invalid_stream_settings_fail_fast():
    """A typo'd factor_round value raises a clear ValueError naming the
    setting, not a KeyError deep inside _round_factor."""
    from tests.test_admm_lane import build_batch

    qps = build_batch(honest=False)
    for val in ("fp8", "F16"):
        s = dataclasses.replace(Settings(), factor_round=val)
        with pytest.raises(ValueError, match="factor_round"):
            admm_lane.solve_batched_lane(qps, s)


def test_stall_floor_protects_aggressive_cadences():
    """The patience floor (review round 5): the effective window spans at
    least ``stall_min_iters`` iterations regardless of the check cadence,
    and exactly ``stall_checks`` checks at cadences where that is already
    enough — so ct=1 users keep 36 iterations of patience while every
    published ct>=3 measurement is unchanged."""
    from osqp_solver_tpu.ops.admm import stall_checks_needed

    mk = lambda ct, sc=12, smi=36: dataclasses.replace(
        Settings(), check_termination=ct, stall_checks=sc, stall_min_iters=smi
    )
    assert stall_checks_needed(mk(1)) == 36   # 36 iterations
    assert stall_checks_needed(mk(2)) == 18   # 36 iterations
    assert stall_checks_needed(mk(3)) == 12   # exactly the fleet setting
    assert stall_checks_needed(mk(5)) == 12   # 60 iterations
    assert stall_checks_needed(mk(25)) == 12  # OSQP default: 300 iterations
    # a sweep-style smaller stall_checks still respects the floor
    assert stall_checks_needed(mk(5, sc=4)) == 8
    # and the oracle bridge applies the identical transform
    from osqp_solver_tpu.utils.oracle import _stall_checks_eff

    for ct in (1, 2, 3, 5, 25):
        assert _stall_checks_eff(12, 36, ct) == stall_checks_needed(mk(ct))
    assert _stall_checks_eff(0, 36, 1) == 0  # disabled stays disabled
