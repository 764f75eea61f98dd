"""Dense reduced-KKT path (``DenseQP.kkt_factor``/``kkt_solve``: XLA's
Cholesky and triangular solves) against ``numpy.linalg``, single problems
and vmapped batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops.qp import DenseQP


def random_qp(key, n, m):
    k1, k2, k3 = jax.random.split(key, 3)
    G = jax.random.normal(k1, (n, n), jnp.float64)
    P = G @ G.T / n + 0.5 * jnp.eye(n)
    A = jax.random.normal(k2, (m, n), jnp.float64)
    q = jax.random.normal(k3, (n,), jnp.float64)
    return DenseQP(P=P, q=q, A=A, l=-jnp.ones(m), u=jnp.ones(m))


def kkt_matrix(qp, rho, sigma):
    P, A = np.asarray(qp.P), np.asarray(qp.A)
    return P + sigma * np.eye(P.shape[0]) + A.T @ (np.asarray(rho)[:, None] * A)


def _batch(seed, n, batch):
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    qps = jax.vmap(lambda k: random_qp(k, n, n + 3))(keys)
    rho = jnp.exp(jax.random.normal(jax.random.PRNGKey(seed + 1), (batch, n + 3)))
    return qps, rho


@pytest.mark.parametrize("n,batch", [(8, 3), (24, 5), (64, 2)])
def test_factor_matches_numpy(n, batch):
    qps, rho = _batch(0, n, batch)
    L = jax.vmap(lambda q, r: q.kkt_factor(r, 1e-6))(qps, rho)
    for b in range(batch):
        one = jax.tree_util.tree_map(lambda a: a[b], qps)
        np.testing.assert_allclose(
            np.asarray(L[b]), np.linalg.cholesky(kkt_matrix(one, rho[b], 1e-6)),
            rtol=1e-10, atol=1e-12,
        )


@pytest.mark.parametrize("n,batch", [(8, 3), (24, 5), (64, 2)])
def test_solve_matches_numpy(n, batch):
    qps, rho = _batch(1, n, batch)
    rhs = jax.random.normal(jax.random.PRNGKey(2), (batch, n), jnp.float64)
    x = jax.vmap(lambda q, r, b: q.kkt_solve(q.kkt_factor(r, 1e-6), b))(
        qps, rho, rhs
    )
    for b in range(batch):
        one = jax.tree_util.tree_map(lambda a: a[b], qps)
        want = np.linalg.solve(kkt_matrix(one, rho[b], 1e-6), np.asarray(rhs[b]))
        np.testing.assert_allclose(np.asarray(x[b]), want, rtol=1e-9, atol=1e-11)


def test_unbatched_entry_points():
    qp = random_qp(jax.random.PRNGKey(5), 16, 20)
    rho = jnp.full((20,), 0.1)
    rhs = jax.random.normal(jax.random.PRNGKey(6), (16,), jnp.float64)
    M = kkt_matrix(qp, rho, 1e-6)
    L = qp.kkt_factor(rho, 1e-6)
    np.testing.assert_allclose(np.asarray(L), np.linalg.cholesky(M), rtol=1e-10)
    x = qp.kkt_solve(L, rhs)
    np.testing.assert_allclose(M @ np.asarray(x), np.asarray(rhs), rtol=1e-9, atol=1e-10)


def test_odd_size_f32_batch():
    """n not a power of two, f32, jitted: the solve stays finite and
    accurate to f32 (products pinned to full precision)."""
    qps, rho = _batch(7, 13, 5)
    qps = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), qps)
    rho = rho.astype(jnp.float32)
    rhs = jax.random.normal(jax.random.PRNGKey(8), (5, 13), jnp.float32)
    x = jax.jit(jax.vmap(lambda q, r, b: q.kkt_solve(q.kkt_factor(r, 1e-6), b)))(
        qps, rho, rhs
    )
    assert np.all(np.isfinite(np.asarray(x)))
    for b in range(5):
        one = jax.tree_util.tree_map(lambda a: a[b], qps)
        M = kkt_matrix(one, rho[b], 1e-6)
        np.testing.assert_allclose(M @ np.asarray(x[b]), np.asarray(rhs[b]), rtol=2e-3, atol=2e-3)


def test_dense_solve_end_to_end_matches_kkt_conditions():
    """The dense ADMM solve that runs on these factors reaches the OSQP
    tolerances (the path the dense random-QP class takes on every
    platform)."""
    from osqp_solver_tpu.ops.admm import Settings, solve
    from osqp_solver_tpu.ops.status import ExitCode

    qp = random_qp(jax.random.PRNGKey(9), 12, 15)
    res = solve(qp, Settings())
    assert int(res.status) == ExitCode.kOptimal
    Ax = np.asarray(qp.A) @ np.asarray(res.x)
    assert np.all(Ax >= -1 - 1e-2) and np.all(Ax <= 1 + 1e-2)
