"""Batched block-tridiagonal factor/solve (the XLA path every platform runs:
``vmap`` of the ``lax.scan`` recurrences in ``ops/tridiag.py``) against
dense ``numpy.linalg`` on the assembled matrix.

The block-Cholesky factor of a block-tridiagonal SPD matrix is exactly the
dense Cholesky factor: its diagonal blocks are ``chol`` and its sub-diagonal
blocks are ``gain``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops.tridiag import (
    block_tridiag_factor,
    block_tridiag_matvec,
    block_tridiag_solve,
    block_tridiag_to_dense,
)

from test_tridiag import random_spd_tridiag


def _batch(seed, W, B2, BATCH):
    keys = jax.random.split(jax.random.PRNGKey(seed), BATCH)
    return jax.vmap(lambda k: random_spd_tridiag(k, W, B2))(keys)


def _dense(diags, lowers):
    return [
        np.asarray(block_tridiag_to_dense(d, l)) for d, l in zip(diags, lowers)
    ]


@pytest.mark.parametrize("W,B2,BATCH", [(5, 4, 3), (16, 12, 7), (1, 4, 2)])
def test_batched_solve_matches_dense(W, B2, BATCH):
    diags, lowers = _batch(0, W, B2, BATCH)
    rhs = jax.random.normal(jax.random.PRNGKey(1), (BATCH, W, B2), jnp.float64)
    factors = jax.vmap(block_tridiag_factor)(diags, lowers)
    got = np.asarray(jax.vmap(block_tridiag_solve)(factors, rhs))
    for b, M in enumerate(_dense(diags, lowers)):
        want = np.linalg.solve(M, np.asarray(rhs[b]).reshape(-1))
        np.testing.assert_allclose(got[b].reshape(-1), want, rtol=1e-10, atol=1e-12)


def test_batched_solve_large_batch():
    """A batch above one warp's width (130) and a batch of one."""
    W, B2 = 4, 4
    for BATCH in (130, 1):
        diags, lowers = _batch(5, W, B2, BATCH)
        rhs = jax.random.normal(jax.random.PRNGKey(6), (BATCH, W, B2), jnp.float64)
        factors = jax.vmap(block_tridiag_factor)(diags, lowers)
        got = np.asarray(jax.vmap(block_tridiag_solve)(factors, rhs))
        Ms = _dense(diags, lowers)
        want = np.stack(
            [np.linalg.solve(M, np.asarray(r).reshape(-1)) for M, r in zip(Ms, rhs)]
        )
        np.testing.assert_allclose(got.reshape(BATCH, -1), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("W,B2,BATCH", [(6, 4, 3), (10, 12, 5), (1, 4, 2)])
def test_batched_factor_matches_dense_cholesky(W, B2, BATCH):
    diags, lowers = _batch(2, W, B2, BATCH)
    f = jax.vmap(block_tridiag_factor)(diags, lowers)
    for b, M in enumerate(_dense(diags, lowers)):
        L = np.linalg.cholesky(M)
        for t in range(W):
            blk = slice(t * B2, (t + 1) * B2)
            np.testing.assert_allclose(
                np.asarray(f.chol[b, t]), L[blk, blk], rtol=1e-10, atol=1e-12
            )
            if t + 1 < W:
                nxt = slice((t + 1) * B2, (t + 2) * B2)
                np.testing.assert_allclose(
                    np.asarray(f.gain[b, t]), L[nxt, blk], rtol=1e-10, atol=1e-12
                )


def test_factor_then_solve_round_trip():
    """Batched factor + solve solve the original system in f32."""
    W, B2, BATCH = 7, 6, 4
    diags, lowers = _batch(3, W, B2, BATCH)
    diags, lowers = diags.astype(jnp.float32), lowers.astype(jnp.float32)
    rhs = jax.random.normal(jax.random.PRNGKey(4), (BATCH, W, B2), jnp.float32)
    factors = jax.vmap(block_tridiag_factor)(diags, lowers)
    x = jax.vmap(block_tridiag_solve)(factors, rhs)
    for b in range(BATCH):
        resid = block_tridiag_matvec(diags[b], lowers[b], x[b]) - rhs[b]
        assert float(jnp.max(jnp.abs(resid))) < 1e-3


def test_lane_container_kkt_solve_matches_dense():
    """The lane container's factor/solve (batch-last, relayout around the
    vmapped scans) solves the dense reduced KKT system of each problem."""
    from test_admm_fused import build_wp_batch

    lane = build_wp_batch(honest=True, batch=3)
    rng = np.random.default_rng(0)
    rho = jnp.asarray(np.exp(rng.normal(size=(lane.m, 3))))
    rhs = jnp.asarray(rng.normal(size=(lane.n, 3)))
    sigma = 1e-6
    x = np.asarray(lane.kkt_solve(lane.kkt_factor(rho, sigma), rhs))
    n = lane.n
    for b in range(3):
        one = jax.tree_util.tree_map(lambda a: a[..., b : b + 1], lane)
        A = np.asarray(
            jax.vmap(one.A_matvec, in_axes=1, out_axes=1)(jnp.eye(n)[:, :, None])
        )[..., 0]
        P = np.asarray(
            jax.vmap(one.P_matvec, in_axes=1, out_axes=1)(jnp.eye(n)[:, :, None])
        )[..., 0]
        K = P + sigma * np.eye(n) + A.T @ (np.asarray(rho[:, b])[:, None] * A)
        want = np.linalg.solve(K, np.asarray(rhs[:, b]))
        np.testing.assert_allclose(x[:, b], want, rtol=1e-8, atol=1e-10)
