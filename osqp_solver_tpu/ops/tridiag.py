"""Symmetric block-tridiagonal factorization and solves.

The JAX-native replacement for qdldl's sequential sparse LDLᵀ (SURVEY.md
§2.2): the trajectory QP's reduced KKT matrix ``P + σI + Aᵀdiag(ρ)A`` is
block-tridiagonal along the time horizon (dynamics/acceleration rows couple
only waypoints ``t, t+1``; workspace rows touch a single waypoint —
``constraint-builder.h:203-219, 72-88, 276-280``), so we store it as

* ``diag``:  ``(W, B, B)`` diagonal blocks (``B = 2*N_DIM``)
* ``lower``: ``(W-1, B, B)`` sub-diagonal blocks, ``M[t+1, t]``

and factor with a block-Cholesky scan (block Thomas algorithm).  All blocks
are dense little matrices → ``vmap`` over problem batches turns every step
into batched small-matrix ops.  The fused ADMM chunk kernel
(:mod:`osqp_solver_tpu.ops.admm_fused`) applies the same factor in-kernel.

The multi-device horizon split (Schur-complement reduction over a mesh axis)
builds on this factorization in :mod:`osqp_solver_tpu.parallel.schur`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

# Accelerator f32 matmuls may default to reduced precision (bf16 passes,
# TF32); the factor recurrence accumulates that error over W steps and
# loses positive definiteness for long horizons.  These are tiny
# latency-bound matrices — exact f32 costs nothing.
_HI = jax.lax.Precision.HIGHEST


class BlockTridiagFactor(NamedTuple):
    """Cholesky factor of a block-tridiagonal SPD matrix:
    ``M = C Cᵀ`` with block-bidiagonal ``C`` (diag blocks ``chol``, sub-diag
    blocks ``gain``)."""

    chol: jnp.ndarray  # (W, B, B) lower-triangular diagonal blocks C_t
    gain: jnp.ndarray  # (W-1, B, B) G_t = L_t C_t^{-T}


def block_tridiag_matvec(diag, lower, x):
    """``y = M x`` for ``x`` of shape ``(W, B)``."""
    y = jnp.einsum("tij,tj->ti", diag, x, precision=_HI)
    if lower.shape[0]:
        y = y.at[1:].add(jnp.einsum("tij,tj->ti", lower, x[:-1], precision=_HI))
        y = y.at[:-1].add(jnp.einsum("tji,tj->ti", lower, x[1:], precision=_HI))
    return y


def block_tridiag_factor(diag, lower) -> BlockTridiagFactor:
    """Blocked Cholesky via ``lax.scan`` over the horizon.

    ``C_0 = chol(D_0)``; ``G_t = L_t C_t^{-T}``;
    ``C_{t+1} = chol(D_{t+1} − G_t G_tᵀ)``.
    """
    W, B, _ = diag.shape
    c0 = jnp.linalg.cholesky(diag[0])

    def step(c_prev, inputs):
        L_t, D_next = inputs
        # G_t = L_t C_t^{-T}  ⟺  solve C_t Xᵀ = L_tᵀ.
        g_t = solve_triangular(c_prev, L_t.T, lower=True, trans=0).T
        c_next = jnp.linalg.cholesky(
            D_next - jnp.matmul(g_t, g_t.T, precision=_HI)
        )
        return c_next, (c_next, g_t)

    if W == 1:
        return BlockTridiagFactor(chol=c0[None], gain=lower)
    _, (chols, gains) = jax.lax.scan(step, c0, (lower, diag[1:]))
    return BlockTridiagFactor(
        chol=jnp.concatenate([c0[None], chols]), gain=gains
    )


def block_tridiag_solve(factor: BlockTridiagFactor, b):
    """Solve ``M x = b`` with ``b`` of shape ``(W, B)`` using the cached
    factor: forward substitution scan then backward substitution scan."""
    chol, gain = factor
    W, B, _ = chol.shape

    w0 = solve_triangular(chol[0], b[0], lower=True)
    if W == 1:
        return solve_triangular(chol[0].T, w0, lower=False)[None]

    def fwd(w_prev, inputs):
        c_t, g_t, b_t = inputs
        w_t = solve_triangular(
            c_t, b_t - jnp.matmul(g_t, w_prev, precision=_HI), lower=True
        )
        return w_t, w_t

    _, ws = jax.lax.scan(fwd, w0, (chol[1:], gain, b[1:]))
    ws = jnp.concatenate([w0[None], ws])

    x_last = solve_triangular(chol[-1].T, ws[-1], lower=False)

    def bwd(x_next, inputs):
        c_t, g_t, w_t = inputs
        x_t = solve_triangular(
            c_t.T, w_t - jnp.matmul(g_t.T, x_next, precision=_HI), lower=False
        )
        return x_t, x_t

    _, xs = jax.lax.scan(
        bwd, x_last, (chol[:-1], gain, ws[:-1]), reverse=True
    )
    return jnp.concatenate([xs, x_last[None]])


def block_tridiag_to_dense(diag, lower):
    """Materialize the dense ``(W*B, W*B)`` matrix (tests only)."""
    W, B, _ = diag.shape
    M = jnp.zeros((W * B, W * B), dtype=diag.dtype)
    for t in range(W):
        M = M.at[t * B : (t + 1) * B, t * B : (t + 1) * B].set(diag[t])
    for t in range(W - 1):
        M = M.at[(t + 1) * B : (t + 2) * B, t * B : (t + 1) * B].set(lower[t])
        M = M.at[t * B : (t + 1) * B, (t + 1) * B : (t + 2) * B].set(lower[t].T)
    return M
