"""ADMM core correctness tests.

The reference never unit-tests its solver layer (SURVEY.md §4) — we do.
Ground truth is solver-independent: KKT optimality conditions checked
directly at OSQP-default tolerances, plus analytic solutions for equality
QPs.  Accuracy target mirrors OSQP defaults eps_abs = eps_rel = 1e-3
(``/root/reference/src/osqp-wrapper.h:26-27``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops import admm
from osqp_solver_tpu.ops.admm import Settings, solve
from osqp_solver_tpu.ops.qp import DenseQP, dense_qp
from osqp_solver_tpu.ops.status import ExitCode

INF = 1e30


def random_qp(key, n=20, m=30, dtype=jnp.float64):
    """Random strongly-convex box-constrained QP that is always feasible."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    M = jax.random.normal(k1, (n, n), dtype)
    P = M @ M.T / n + 0.1 * jnp.eye(n, dtype=dtype)
    q = jax.random.normal(k2, (n,), dtype)
    A = jax.random.normal(k3, (m, n), dtype)
    x0 = jax.random.normal(k4, (n,), dtype)  # a strictly feasible point
    margin = jnp.abs(jax.random.normal(k5, (m,), dtype)) + 0.1
    Ax0 = A @ x0
    return dense_qp(P, q, A, Ax0 - margin, Ax0 + margin)


def check_kkt(qp: DenseQP, res, eps=5e-3):
    """Verify primal feasibility, stationarity, and complementary slackness."""
    x, y = np.asarray(res.x), np.asarray(res.y)
    P, q, A = np.asarray(qp.P), np.asarray(qp.q), np.asarray(qp.A)
    l, u = np.asarray(qp.l), np.asarray(qp.u)
    Ax = A @ x
    scale_p = max(1.0, np.abs(Ax).max())
    scale_d = max(1.0, np.abs(P @ x).max(), np.abs(q).max())
    assert np.all(Ax >= l - eps * scale_p), "primal lower bound violated"
    assert np.all(Ax <= u + eps * scale_p), "primal upper bound violated"
    np.testing.assert_allclose(P @ x + q + A.T @ y, 0, atol=eps * scale_d * 10)
    # complementary slackness: y⁺ only on active upper, y⁻ only on active lower
    ypos, yneg = np.maximum(y, 0), np.minimum(y, 0)
    assert np.all(np.abs(ypos * (u - Ax)) <= 10 * eps * scale_p * (1 + np.abs(y)))
    assert np.all(np.abs(yneg * (Ax - l)) <= 10 * eps * scale_p * (1 + np.abs(y)))


def test_box_qp_analytic():
    """min ½‖x‖² − 1ᵀx s.t. −0.5 ≤ x ≤ 0.5 → x* = 0.5·1."""
    n = 8
    qp = dense_qp(
        np.eye(n), -np.ones(n), np.eye(n), -0.5 * np.ones(n), 0.5 * np.ones(n)
    )
    res = solve(qp)
    assert int(res.status) == ExitCode.kOptimal
    np.testing.assert_allclose(np.asarray(res.x), 0.5, atol=5e-3)


def test_equality_qp_analytic():
    """Equality-constrained QP against the direct KKT solution."""
    rng = np.random.default_rng(0)
    n, p = 12, 4
    M = rng.normal(size=(n, n))
    P = M @ M.T + 0.5 * np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(p, n))
    b = rng.normal(size=p)
    KKT = np.block([[P, A.T], [A, np.zeros((p, p))]])
    sol = np.linalg.solve(KKT, np.concatenate([-q, b]))
    x_star = sol[:n]

    res = solve(dense_qp(P, q, A, b, b))
    assert int(res.status) == ExitCode.kOptimal
    np.testing.assert_allclose(np.asarray(res.x), x_star, atol=5e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_qp_kkt(seed):
    qp = random_qp(jax.random.PRNGKey(seed))
    res = solve(qp)
    assert int(res.status) == ExitCode.kOptimal
    check_kkt(qp, res)


def test_infinite_bounds_rows():
    """Rows with ±INF bounds (the reference's dummy rows,
    constraint-builder.h:112-116) must not perturb the solution."""
    n = 6
    P = np.eye(n)
    q = -np.arange(1.0, n + 1)
    A = np.vstack([np.eye(n), np.random.default_rng(1).normal(size=(4, n))])
    l = np.concatenate([-np.ones(n), -INF * np.ones(4)])
    u = np.concatenate([np.ones(n), INF * np.ones(4)])
    res = solve(dense_qp(P, q, A, l, u))
    assert int(res.status) == ExitCode.kOptimal
    np.testing.assert_allclose(
        np.asarray(res.x), np.clip(np.arange(1.0, n + 1), -1, 1), atol=5e-3
    )


def test_primal_infeasible():
    """x ≥ 1 and x ≤ −1 simultaneously → kPrimalInfeasible certificate."""
    A = np.array([[1.0], [1.0]])
    l = np.array([1.0, -INF])
    u = np.array([INF, -1.0])
    res = solve(dense_qp(np.eye(1), np.zeros(1), A, l, u))
    assert int(res.status) == ExitCode.kPrimalInfeasible


def test_dual_infeasible():
    """min −x s.t. x ≥ 0 is unbounded → kDualInfeasible certificate."""
    res = solve(
        dense_qp(np.zeros((1, 1)), -np.ones(1), np.eye(1), np.zeros(1), INF * np.ones(1))
    )
    assert int(res.status) == ExitCode.kDualInfeasible


def test_warm_start_reduces_iterations():
    qp = random_qp(jax.random.PRNGKey(7))
    cold = solve(qp)
    warm = solve(qp, warm_x=cold.x, warm_y=cold.y)
    assert int(warm.status) == ExitCode.kOptimal
    assert int(warm.iterations) <= int(cold.iterations)
    # Warm-started from the solution: should converge at the first check.
    assert int(warm.iterations) <= Settings().check_termination


def test_vmap_batch_masked_convergence():
    """Batched solve via vmap: per-problem status/iterations, all optimal."""
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    qps = jax.vmap(lambda k: random_qp(k, n=10, m=14))(keys)
    res = jax.jit(jax.vmap(lambda qp: solve(qp)))(qps)
    assert res.x.shape == (8, 10)
    assert np.all(np.asarray(res.status) == ExitCode.kOptimal)
    # different problems converge at different iteration counts
    iters = np.asarray(res.iterations)
    assert iters.min() >= 1
    for i in range(8):
        one = jax.tree_util.tree_map(lambda a: a[i], qps)
        check_kkt(one, jax.tree_util.tree_map(lambda a: a[i], res))


def test_jit_eager_equivalence():
    """Determinism check (SURVEY.md §5: replaces race-detection tooling)."""
    qp = random_qp(jax.random.PRNGKey(11), n=8, m=10)
    eager = solve(qp)
    jitted = jax.jit(lambda qp: solve(qp))(qp)
    np.testing.assert_allclose(np.asarray(eager.x), np.asarray(jitted.x), rtol=1e-9)
    assert int(eager.iterations) == int(jitted.iterations)


def test_float32_solves_to_osqp_tolerance():
    """f32 (accelerator dtype) still meets OSQP 1e-3-level accuracy on small
    well-conditioned problems."""
    qp = random_qp(jax.random.PRNGKey(5), n=16, m=24, dtype=jnp.float32)
    res = solve(qp)
    assert int(res.status) in (ExitCode.kOptimal, ExitCode.kOptimalInaccurate)
    check_kkt(qp, res, eps=1e-2)


def test_no_scaling_path():
    qp = random_qp(jax.random.PRNGKey(9), n=8, m=12)
    res = solve(qp, Settings(scaling=0))
    assert int(res.status) == ExitCode.kOptimal
    check_kkt(qp, res)


def test_objective_value():
    n = 4
    qp = dense_qp(np.eye(n), np.zeros(n), np.eye(n), np.ones(n), 2 * np.ones(n))
    res = solve(qp)
    # x* = 1 (closest feasible to unconstrained optimum 0), obj = n/2.
    assert float(res.obj_val) == pytest.approx(n / 2, rel=1e-2)


def test_nonconvex_detected():
    """A negative-definite P diverges; the solver flags kNonConvex instead of
    raising (failure detection, SURVEY.md §5)."""
    P = np.array([[-4.0]])
    res = solve(dense_qp(P, np.zeros(1), np.eye(1), -np.ones(1), np.ones(1)))
    assert int(res.status) == ExitCode.kNonConvex


def test_kkt_iterative_refinement_f32():
    """kkt_refine=1 tightens f32 solve accuracy (same status, residuals no
    worse)."""
    qp = random_qp(jax.random.PRNGKey(13), n=24, m=36, dtype=jnp.float32)
    base = solve(qp, Settings())
    refined = solve(qp, Settings(kkt_refine=1))
    assert int(refined.status) == ExitCode.kOptimal
    assert float(refined.prim_res) <= float(base.prim_res) * 2 + 1e-6
    check_kkt(qp, refined, eps=1e-2)


def test_polish_tightens_residuals():
    """Settings(polish=True): active-set polishing drives residuals far
    below the ADMM stopping tolerance (OSQP polish semantics)."""
    qp = random_qp(jax.random.PRNGKey(17), n=16, m=24)
    rough = solve(qp)
    polished = solve(qp, Settings(polish=True))
    assert int(polished.status) == ExitCode.kOptimal
    assert float(polished.prim_res) <= float(rough.prim_res)
    assert float(polished.dual_res) <= float(rough.dual_res)
    # typically orders of magnitude tighter
    assert float(polished.prim_res) < 1e-5
    assert float(polished.dual_res) < 1e-5
    check_kkt(qp, polished, eps=1e-4)


def test_auto_refine_policy():
    """Long-horizon f32 auto-refinement thresholds (VERDICT r1 next #4)."""
    import dataclasses

    import jax.numpy as jnp

    from osqp_solver_tpu.ops import admm

    # With exact f32 accumulation pinned in the factor/solve path, W=802
    # needs NO refinement (CPU f32 exact counts); the policy only
    # adds a safety step beyond the verified range.
    assert admm.refine_steps_for_horizon(100, jnp.float32) == 0
    assert admm.refine_steps_for_horizon(802, jnp.float32) == 0
    assert admm.refine_steps_for_horizon(2048, jnp.float32) == 1
    assert admm.refine_steps_for_horizon(2048, jnp.float64) == 0
    s = admm.Settings()
    assert admm.with_auto_refine(s, 2048, jnp.float32).kkt_refine == 1
    # never lowers an explicit user choice
    s3 = dataclasses.replace(s, kkt_refine=3)
    assert admm.with_auto_refine(s3, 802, jnp.float32).kkt_refine == 3


def test_solve_batched_matches_vmapped_solve():
    """solve_batched (scalar-guarded adaptive-ρ refactor, VERDICT r1 next #5)
    is numerically equivalent to vmap(solve): same statuses, same per-problem
    ρ endpoints (each problem follows its own residual ratios), same x."""
    import numpy as np

    keys = jax.random.split(jax.random.PRNGKey(42), 6)
    # Mixed difficulty: scale some problems badly so ρ adapts for a subset.
    def one(key, scale):
        qp = random_qp(key, n=12, m=18)
        return qp.replace(P=qp.P * scale, q=qp.q * scale)

    scales = jnp.asarray([1.0, 1e3, 1.0, 1e-3, 1.0, 30.0])
    qps = jax.vmap(one)(keys, scales)
    s = Settings(scaling=0)  # unscaled → adaptation actually triggers

    res_v = jax.vmap(lambda qp: solve(qp, s))(qps)
    res_b = admm.solve_batched(qps, s)

    np.testing.assert_array_equal(np.asarray(res_v.status), np.asarray(res_b.status))
    np.testing.assert_array_equal(
        np.asarray(res_v.iterations), np.asarray(res_b.iterations)
    )
    np.testing.assert_allclose(np.asarray(res_v.rho), np.asarray(res_b.rho))
    np.testing.assert_allclose(
        np.asarray(res_v.x), np.asarray(res_b.x), atol=1e-9
    )
    # the mixed batch must actually have exercised per-problem adaptation
    assert len(set(np.asarray(res_b.rho).tolist())) > 1

pytestmark = pytest.mark.quick  # fast tier: see CLAUDE.md
