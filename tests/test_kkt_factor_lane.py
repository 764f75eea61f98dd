"""KKT assembly and factorization of the lane container (XLA: the
``kkt_blocks`` stencil assembly, then the vmapped block-Cholesky scan), the
factor the fused chunk kernel reads, against dense ``numpy`` on the honest
UR5e class (two balls with workspace rows, one line obstacle)."""
import jax
import jax.numpy as jnp
import numpy as np

from osqp_solver_tpu.ops import admm
from osqp_solver_tpu.ops.admm import _rho_vec
from osqp_solver_tpu.ops.admm_fused import _coef_layout, build_coef_pack
from osqp_solver_tpu.ops.admm_lane import ruiz_equilibrate_lane
from osqp_solver_tpu.ops.tridiag import block_tridiag_to_dense


def _honest_lane_batch(B=4, W=7, N=6, dtype=jnp.float64, seed=0):
    from osqp_solver_tpu import RobotBall
    from osqp_solver_tpu.gomp.geometry import HorizontalLine
    from osqp_solver_tpu.gomp.trajectory import calc_warm_start_jnp
    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        linearize_workspace,
        with_gomp_boxes,
    )
    from osqp_solver_tpu.gomp.trajectory_qp_lane import from_trailing
    from osqp_solver_tpu.models import ur5e

    INF = 1e30
    balls = (
        RobotBall(fk=ur5e.forward_kinematics_6_back,
                  jacobian=ur5e.joint_jacobian_6_back, radius=0.15,
                  is_gripper=False),
        RobotBall(fk=ur5e.forward_kinematics,
                  jacobian=ur5e.joint_jacobian, radius=0.05, is_gripper=True),
    )
    obstacles = [HorizontalLine.create((0.0, 1.0), (0.35, 0.0, 0.15))]
    con3d = (jnp.asarray([-INF, -0.4, -INF], dtype),
             jnp.asarray([INF, INF, INF], dtype))
    pos = (jnp.full(N, -2 * np.pi, dtype), jnp.full(N, 2 * np.pi, dtype))
    vel = (jnp.full(N, -0.3, dtype), jnp.full(N, 0.3, dtype))
    acc = (jnp.full(N, -1.4, dtype), jnp.full(N, 1.4, dtype))
    base = empty_trajectory_qp(
        W, N, gripper_flags=(False, True), n_obstacles=1, dtype=dtype
    )

    def one(i):
        start = 0.02 * jnp.sin(jnp.arange(N, dtype=dtype) + i + seed)
        end = jnp.asarray([np.pi, 0, 0, 0, 0, 0], dtype) + 0.02 * jnp.cos(
            jnp.arange(N, dtype=dtype) * 1.3 + i
        )
        qp = with_gomp_boxes(base, start, end, pos, vel, acc)
        warm = calc_warm_start_jnp(start, end, W)
        return linearize_workspace(qp, balls, obstacles, con3d, warm)

    return from_trailing(
        jax.vmap(one, out_axes=-1)(jnp.arange(B, dtype=dtype)),
        row_layout="waypoint",
    )


def _dense_kkt(scaled, rho_vec, sigma, b):
    diag, lower = scaled.kkt_blocks(rho_vec, sigma)
    return np.asarray(block_tridiag_to_dense(diag[..., b], lower[..., b]))


def test_factor_matches_dense_cholesky():
    settings = admm.Settings()
    lane = _honest_lane_batch()
    scaled, _ = ruiz_equilibrate_lane(lane, settings.scaling)
    rho_bar = jnp.full((lane.batch,), settings.rho, scaled.q.dtype)
    rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
    f = scaled.kkt_factor(rho_vec, settings.sigma)
    B2 = 2 * lane.n_dim
    for b in range(lane.batch):
        L = np.linalg.cholesky(_dense_kkt(scaled, rho_vec, settings.sigma, b))
        for t in range(lane.waypoints):
            s = slice(t * B2, (t + 1) * B2)
            np.testing.assert_allclose(
                np.asarray(f.chol[t, :, :, b]), L[s, s], rtol=1e-9, atol=1e-12
            )
            if t + 1 < lane.waypoints:
                s1 = slice((t + 1) * B2, (t + 2) * B2)
                np.testing.assert_allclose(
                    np.asarray(f.gain[t, :, :, b]), L[s1, s],
                    rtol=1e-9, atol=1e-12,
                )


def test_coef_pack_layout():
    """Every row of the kernel's stencil pack holds the container
    coefficient it names; rows a waypoint lacks are zero."""
    lane = _honest_lane_batch(W=5)
    coef = np.asarray(build_coef_pack(lane))
    off, ball_coefs, CR, CRp = _coef_layout(lane)
    W, N = lane.waypoints, lane.n_dim
    assert coef.shape == (W, CRp, lane.batch)
    dyn, acc = np.asarray(lane.dyn_coef), np.asarray(lane.acc_coef)
    for k, name in enumerate(("c0", "c1", "c2")):
        np.testing.assert_array_equal(coef[: W - 1, off[name] : off[name] + N], dyn[:, :, k])
        np.testing.assert_array_equal(coef[W - 1, off[name] : off[name] + N], 0.0)
    for k, name in enumerate(("a0", "a1")):
        np.testing.assert_array_equal(coef[: W - 2, off[name] : off[name] + N], acc[:, :, k])
        np.testing.assert_array_equal(coef[W - 2 :, off[name] : off[name] + N], 0.0)
    np.testing.assert_array_equal(coef[:, off["pos"] : off["pos"] + N], np.asarray(lane.pos_coef))
    ws_c, obs_c = ball_coefs[1]  # the gripper ball has workspace rows
    np.testing.assert_array_equal(
        coef[:, ws_c : ws_c + 3 * N], np.asarray(lane.ws_jac[1]).reshape(W, 3 * N, -1)
    )
    np.testing.assert_array_equal(
        coef[:, obs_c : obs_c + N], np.asarray(lane.obs_jac[1, 0])
    )
    np.testing.assert_array_equal(coef[:, CR:], 0.0)


def test_f32_factor_reconstructs_kkt():
    """The f32 factor at a longer horizon, with equality rows (ρ×1e3) in the
    mix: C·Cᵀ reproduces the assembled KKT matrix to f32 accuracy (every
    product in assembly and factor is pinned to full precision)."""
    settings = admm.Settings()
    lane = _honest_lane_batch(B=2, W=40, dtype=jnp.float32)
    scaled, _ = ruiz_equilibrate_lane(lane, settings.scaling)
    rho_bar = jnp.full((lane.batch,), settings.rho, scaled.q.dtype)
    rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
    f = scaled.kkt_factor(rho_vec, settings.sigma)
    for b in range(lane.batch):
        K = _dense_kkt(scaled, rho_vec, settings.sigma, b).astype(np.float64)
        C = block_tridiag_to_dense(
            jnp.asarray(f.chol[..., b], jnp.float64),
            jnp.asarray(f.gain[..., b], jnp.float64),
        )
        C = np.tril(np.asarray(C))  # block-bidiagonal lower factor
        err = np.max(np.abs(C @ C.T - K)) / np.max(np.abs(K))
        assert err < 1e-5, err
