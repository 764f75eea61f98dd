"""Termination and certificate quantities of the lane driver (XLA
reductions, ``admm_lane._termination_quantities``) against dense f64
residuals computed with ``numpy`` in the unscaled problem space."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu.ops import admm
from osqp_solver_tpu.ops.admm import INF_THRESHOLD
from osqp_solver_tpu.ops.admm_lane import (
    _iteration,
    _termination_quantities,
    init_state_lane,
    ruiz_equilibrate_lane,
)

from test_admm_fused import build_wp_batch


def _dense_ops(lane, b):
    one = jax.tree_util.tree_map(lambda a: a[..., b : b + 1], lane)
    eye = jnp.eye(lane.n)[:, :, None]
    A = np.asarray(jax.vmap(one.A_matvec, in_axes=1, out_axes=1)(eye))[..., 0]
    P = np.asarray(jax.vmap(one.P_matvec, in_axes=1, out_axes=1)(eye))[..., 0]
    return A, P


@pytest.mark.parametrize("honest", [True, False])
def test_quantities_match_dense_residuals(honest):
    settings = dataclasses.replace(admm.Settings(), check_termination=3)
    lane = build_wp_batch(honest=honest, batch=4)
    scaled, scaling = ruiz_equilibrate_lane(lane, settings.scaling)
    st = init_state_lane(scaled, settings)
    factor = st.factor
    for _ in range(5):  # non-trivial iterate and deltas
        st = _iteration(scaled, st.replace(factor=None), factor, settings)
    tq = _termination_quantities(lane, scaled, scaling, st)

    x = np.asarray(scaling.D * st.x)
    z = np.asarray(scaling.Einv * st.z)
    y = np.asarray(scaling.cinv * scaling.E * st.y)
    dx = np.asarray(scaling.D * st.dx)
    dy = np.asarray(scaling.cinv * scaling.E * st.dy)
    q, l, u = (np.asarray(v) for v in (lane.q, lane.l, lane.u))
    inf = np.inf
    for b in range(lane.batch):
        A, P = _dense_ops(lane, b)
        xb, zb, yb, dxb, dyb = x[:, b], z[:, b], y[:, b], dx[:, b], dy[:, b]
        qb, lb, ub = q[:, b], l[:, b], u[:, b]
        loose_u, loose_l = ub >= INF_THRESHOLD, lb <= -INF_THRESHOLD
        Adx = A @ dxb
        want = dict(
            prim_res=np.max(np.abs(A @ xb - zb)),
            dual_res=np.max(np.abs(P @ xb + qb + A.T @ yb)),
            prim_norm=max(np.max(np.abs(A @ xb)), np.max(np.abs(zb))),
            dual_norm=max(
                np.max(np.abs(P @ xb)), np.max(np.abs(A.T @ yb)),
                np.max(np.abs(qb)),
            ),
            norm_dy=np.max(np.abs(dyb)),
            norm_dx=np.max(np.abs(dxb)),
            At_dy_max=np.max(np.abs(A.T @ dyb)),
            support=np.sum(
                np.where(loose_u, 0.0, ub * np.maximum(dyb, 0))
                + np.where(loose_l, 0.0, lb * np.minimum(dyb, 0))
            ),
            P_dx_max=np.max(np.abs(P @ dxb)),
            A_dx_max=np.max(np.where(loose_u, -inf, Adx)),
            A_dx_min=np.min(np.where(loose_l, inf, Adx)),
            q_dot_dx=qb @ dxb,
        )
        for name, w in want.items():
            np.testing.assert_allclose(
                np.asarray(getattr(tq, name))[b], w, rtol=1e-9, atol=1e-11,
                err_msg=f"{name} problem {b}",
            )
        assert not bool(np.asarray(tq.blew_up)[b])
