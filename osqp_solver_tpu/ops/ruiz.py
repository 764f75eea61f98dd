"""Modified Ruiz equilibration with cost normalization.

JAX-native implementation of OSQP's problem scaling (OSQP ``scaling.c``
semantics; the reference leaves ``settings.scaling`` at its default of 10
iterations, ``/root/reference/src/osqp-wrapper.h:26-27``).  The scaled problem
is ``P̄ = c·D P D``, ``q̄ = c·D q``, ``Ā = E A D``, ``l̄ = E l``, ``ū = E u``;
unscaling: ``x = D x̄``, ``y = E ȳ / c``.

Everything is a fixed-count Python loop over jnp ops → unrolls into one XLA
program at setup; norms come from the QP operator protocol so the same code
equilibrates dense and block-banded problems.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

MIN_SCALING = 1e-4  # OSQP MIN_SCALING
MAX_SCALING = 1e4  # OSQP MAX_SCALING


class Scaling(NamedTuple):
    D: jnp.ndarray  # (n,) primal scaling
    E: jnp.ndarray  # (m,) dual / constraint scaling
    c: jnp.ndarray  # scalar cost scaling
    Dinv: jnp.ndarray
    Einv: jnp.ndarray
    cinv: jnp.ndarray


def _limit(norms):
    """OSQP ``limit_scaling``: zeros→1 (leave unscaled), clip to MAX."""
    norms = jnp.where(norms < MIN_SCALING, 1.0, norms)
    return jnp.minimum(norms, MAX_SCALING)


def identity_scaling(n: int, m: int, dtype=jnp.float32) -> Scaling:
    one = jnp.ones((), dtype)
    return Scaling(
        D=jnp.ones(n, dtype), E=jnp.ones(m, dtype), c=one,
        Dinv=jnp.ones(n, dtype), Einv=jnp.ones(m, dtype), cinv=one,
    )


def ruiz_equilibrate(qp, iters: int = 10):
    """Return ``(scaled_qp, Scaling)``.

    Each iteration: column inf-norms of the symmetric KKT block
    ``[[P, Aᵀ], [A, 0]]`` give ``δ = 1/sqrt(norm)`` updates for D and E, then
    the cost is normalized by ``γ = 1/max(mean(colnorm(P)), ‖q‖∞)``.
    """
    import jax

    dtype = qp.q.dtype
    n = qp.q.shape[-1]
    m = qp.l.shape[-1]
    D = jnp.ones(n, dtype)
    E = jnp.ones(m, dtype)
    c = jnp.ones((), dtype)

    # Collective-aware scalar reductions for horizon-sharded containers
    # (parallel.banded.ShardedBandedQP): per-row/col norms stay local (the
    # container's absmax methods handle halos); only the cost-normalization
    # scalars reduce globally, with padded state slots masked out of the mean.
    axis = getattr(qp, "collective_axis", None)
    mask = getattr(qp, "n_valid_mask", None) if axis else None

    def g_mean(v):
        if mask is not None:
            s = jnp.sum(jnp.where(mask, v, 0.0))
            cnt = jnp.sum(mask.astype(v.dtype))
        else:
            s, cnt = jnp.sum(v), jnp.asarray(v.size, v.dtype)
        if axis:
            s = jax.lax.psum(s, axis)
            cnt = jax.lax.psum(cnt, axis)
        return s / cnt

    def g_absmax(v):
        r = jnp.max(jnp.abs(v))
        return jax.lax.pmax(r, axis) if axis else r

    scaled = qp
    for _ in range(iters):
        # Column norms of the scaled KKT matrix.
        cols_x = jnp.maximum(scaled.P_col_absmax(), scaled.A_col_absmax())
        rows_a = scaled.A_row_absmax()
        delta_d = 1.0 / jnp.sqrt(_limit(cols_x))
        delta_e = 1.0 / jnp.sqrt(_limit(rows_a)) if m else E
        D = D * delta_d
        E = E * delta_e
        scaled = qp.scale_data(D, E, c)

        # Cost normalization (OSQP scaling.c: gamma on mean P colnorm vs ‖q‖∞).
        p_cols = _limit(scaled.P_col_absmax())
        gamma = 1.0 / _limit(
            jnp.maximum(g_mean(p_cols), g_absmax(scaled.q))
        )
        c = c * gamma
        scaled = qp.scale_data(D, E, c)

    scaling = Scaling(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E, cinv=1.0 / c)
    return scaled, scaling
