"""OSQP "inaccurate infeasibility" exit statuses (VERDICT r2 next #6).

At ``max_iter`` OSQP re-evaluates termination with 10×-relaxed tolerances
(termination.c approximate mode) and can return
``kPrimalInfeasibleInaccurate``/``kDualInfeasibleInaccurate`` — part of the
``OsqpExitCode`` surface the reference consumes
(``/root/reference/src/utils.h:11``).  These tests pin that the statuses are
*reachable* in the JAX core (end-to-end, on deterministic f64 CPU problems
whose certificate quality at the cut-off sits between ε and 10ε), that the
decision ladder is correct at the lane-driver level, and that the native C++
oracle agrees status-for-status across the whole max_iter sweep.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops import admm_lane
from osqp_solver_tpu.ops.admm import Settings, solve
from osqp_solver_tpu.ops.qp import dense_qp
from osqp_solver_tpu.ops.status import ExitCode
from osqp_solver_tpu.utils import oracle

INF = 1e30

pytestmark = pytest.mark.quick


def _near_primal_infeasible():
    """Conflicting equality systems A₀x = b and A₀x = b + 0.05: primal
    infeasible, but the certificate direction δy converges gradually (the
    strict certificate fires at iteration ~35 under check_termination=5)."""
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


def _near_dual_infeasible():
    """Unbounded QP: P singular (rank n−2), q descending along a recession
    direction the constraint cone leaves open.  The dual certificate δx
    converges slowly enough to have an inaccurate window."""
    rng = np.random.default_rng(5)
    n, m = 12, 8
    B = rng.normal(size=(n, n - 2))
    P = B @ B.T
    q = rng.normal(size=n)
    d = np.linalg.svd(P)[0][:, -1]
    if q @ d > 0:
        d = -d
    A = rng.normal(size=(m, n))
    Ad = A @ d
    l = A @ rng.normal(size=n) - 1.0
    u = l + 2.0
    u = np.where(Ad > 0, INF, u)
    l = np.where(Ad < 0, -INF, l)
    return P, q, A, l, u


def test_primal_infeasible_inaccurate_reachable():
    """Cut off before the strict certificate: the 10×-relaxed certificate
    holds at max_iter → kPrimalInfeasibleInaccurate; run longer → strict."""
    qp = dense_qp(*_near_primal_infeasible())
    s = Settings(max_iter=30, check_termination=5)
    res = solve(qp, s)
    assert int(res.status) == ExitCode.kPrimalInfeasibleInaccurate
    res_full = solve(qp, Settings(check_termination=5))
    assert int(res_full.status) == ExitCode.kPrimalInfeasible


def test_dual_infeasible_inaccurate_reachable():
    qp = dense_qp(*_near_dual_infeasible())
    s = Settings(max_iter=90, check_termination=5)
    res = solve(qp, s)
    assert int(res.status) == ExitCode.kDualInfeasibleInaccurate
    res_full = solve(qp, Settings(check_termination=5))
    assert int(res_full.status) == ExitCode.kDualInfeasible


@pytest.mark.skipif(not oracle.available(), reason="native oracle unavailable")
def test_oracle_agrees_primal_sweep():
    """Status-for-status agreement with the native oracle across the whole
    cut-off sweep (same trajectory: scaling off, matched ρ-adapt interval)."""
    P, q, A, l, u = _near_primal_infeasible()
    qp = dense_qp(P, q, A, l, u)
    for mi in range(5, 60, 5):
        s = Settings(
            max_iter=mi, check_termination=5, scaling=0,
            adaptive_rho_interval=5,
        )
        rj = solve(qp, s)
        rc = oracle.solve(P, q, A, l, u, max_iter=mi, check_every=5)
        assert int(rj.status) == rc.status, f"max_iter={mi}"
    statuses = {
        oracle.solve(P, q, A, l, u, max_iter=mi, check_every=5).status
        for mi in range(5, 60, 5)
    }
    assert ExitCode.kPrimalInfeasibleInaccurate in statuses


@pytest.mark.skipif(not oracle.available(), reason="native oracle unavailable")
def test_oracle_agrees_dual_sweep():
    P, q, A, l, u = _near_dual_infeasible()
    qp = dense_qp(P, q, A, l, u)
    for mi in range(5, 60, 5):
        s = Settings(
            max_iter=mi, check_termination=5, scaling=0,
            adaptive_rho_interval=5,
        )
        rj = solve(qp, s)
        rc = oracle.solve(P, q, A, l, u, max_iter=mi, check_every=5)
        assert int(rj.status) == rc.status, f"max_iter={mi}"
    statuses = {
        oracle.solve(P, q, A, l, u, max_iter=mi, check_every=5).status
        for mi in range(5, 60, 5)
    }
    assert ExitCode.kDualInfeasibleInaccurate in statuses


def _lane_state(B):
    zeros = jnp.zeros((1, B))
    return admm_lane.LaneADMMState(
        x=zeros, z=zeros, y=zeros, dx=zeros, dy=zeros,
        rho_bar=jnp.ones(B), rho_vec=jnp.ones((1, B)), factor=None,
        iterations=jnp.full(B, Settings().max_iter, jnp.int32),
        status=jnp.full(B, ExitCode.kUnknown, jnp.int32),
        done=jnp.zeros(B, bool),
        prim_res=jnp.full(B, jnp.inf), dual_res=jnp.full(B, jnp.inf),
    )


def test_lane_decide_ladder_at_max_iter():
    """The lane/fused decision ladder (shared by the jnp and Pallas
    termination paths) emits the inaccurate statuses in OSQP priority order:
    solved-inaccurate beats infeasible-inaccurate beats kMaxIterations."""
    s = Settings()
    eps = s.eps_prim_inf  # == eps_dual_inf == 1e-4
    B = 4
    z, one = np.zeros(B), np.ones(B)
    big = np.full(B, 1.0)

    # per-problem design (ratios relative to eps):
    #  b0: primal cert at 5ε (strict fails, relaxed passes) → kPrimalInfInacc
    #  b1: dual cert at 5ε → kDualInfInacc
    #  b2: solved_inacc AND relaxed primal cert → kOptimalInaccurate (priority)
    #  b3: nothing → kMaxIterations
    prim_res = np.array([1.0, 1.0, 5e-3, 1.0])
    dual_res = np.array([1.0, 1.0, 5e-3, 1.0])
    norm_dy = np.array([1.0, 0.0, 1.0, 0.0])
    At_dy_max = np.array([5 * eps, 0.0, 5 * eps, 0.0])
    support = np.array([-1.0, 0.0, -1.0, 0.0])
    norm_dx = np.array([0.0, 1.0, 0.0, 0.0])
    P_dx_max = np.array([0.0, 5 * eps, 0.0, 0.0])
    q_dot_dx = np.array([0.0, -1.0, 0.0, 0.0])

    tq = admm_lane.TermQuantities(
        prim_res=jnp.asarray(prim_res), dual_res=jnp.asarray(dual_res),
        prim_norm=jnp.zeros(B), dual_norm=jnp.zeros(B),
        norm_dy=jnp.asarray(norm_dy), norm_dx=jnp.asarray(norm_dx),
        At_dy_max=jnp.asarray(At_dy_max), support=jnp.asarray(support),
        loose_dy_pos_max=jnp.zeros(B), loose_dy_neg_max=jnp.zeros(B),
        P_dx_max=jnp.asarray(P_dx_max),
        A_dx_max=jnp.zeros(B), A_dx_min=jnp.zeros(B),
        q_dot_dx=jnp.asarray(q_dot_dx),
        blew_up=jnp.zeros(B, bool),
    )
    st, _ = admm_lane._termination_decide(_lane_state(B), tq, s)
    np.testing.assert_array_equal(
        np.asarray(st.status),
        [
            ExitCode.kPrimalInfeasibleInaccurate,
            ExitCode.kDualInfeasibleInaccurate,
            ExitCode.kOptimalInaccurate,
            ExitCode.kMaxIterations,
        ],
    )
    assert bool(np.all(np.asarray(st.done)))
