"""GOMP planner end-to-end tests (SCP + horizon shrinking).

The reference has no planner tests (its example binary is the de-facto
integration test, SURVEY.md §4); these cover the planner semantics with
controlled kinematics and small UR5e problems.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from osqp_solver_tpu import RobotBall, constraints as C
from osqp_solver_tpu.gomp.geometry import HorizontalLine
from osqp_solver_tpu.gomp.planner import GOMPSolver
from osqp_solver_tpu.models import ur5e
from osqp_solver_tpu.ops.status import ExitCode

# Mid tier: solver+planner integration paths the quick tier skips
# (pyproject `mid` marker; see CLAUDE.md).
pytestmark = pytest.mark.mid

N = 3


def identity_ball(radius=0.05, gripper=True):
    return RobotBall(
        fk=lambda s: s,
        jacobian=lambda s: jnp.eye(3, dtype=s.dtype),
        radius=radius,
        is_gripper=gripper,
    )


def make_solver(obstacles=(), waypoints=12, con3d=None, **kw):
    return GOMPSolver(
        max_waypoints=waypoints,
        time_step=0.1,
        pos_con=C.in_range(N, -10, 10),
        vel_con=C.in_range(N, -20, 20),
        acc_con=C.in_range(N, -40, 40),
        con_3d=con3d or C.in_range(3, -10, 10),
        obstacles=list(obstacles),
        balls=[identity_ball()],
        **kw,
    )


def test_straight_line_no_obstacles():
    solver = make_solver()
    start = np.zeros(N)
    end = np.array([1.0, 0.5, -0.25])
    res = solver.run(start, end)
    assert res.status == ExitCode.kOptimal
    W = res.trajectory.size // (2 * N)
    q = res.trajectory[: W * N].reshape(W, N)
    np.testing.assert_allclose(q[0], start, atol=1e-2)
    # end pinned at waypoint W-3 (the reference quirk, gomp-solver.h:133)
    np.testing.assert_allclose(q[W - 3], end, atol=1e-2)
    # dynamics hold: v_t = (q_{t+1} - q_t), unscaled by dt
    v = res.trajectory[W * N :].reshape(W, N)
    dq = (q[1:] - q[:-1]) / solver.time_step
    np.testing.assert_allclose(v[:-1], dq, atol=0.2)
    # horizon shrinking happened: the returned trajectory is the shortest
    # feasible one (W < max_waypoints).
    assert W <= solver.max_waypoints
    assert len(res.stats) >= 1


def test_obstacle_avoidance_scp_converges():
    """SCP loop must converge to a trajectory that clears the line obstacle
    under the exact (identity) FK check."""
    line = HorizontalLine.create([1.0, 0.0], [0.0, 0.0, 0.5], False)
    solver = make_solver(obstacles=[line], waypoints=10)
    start = np.array([0.0, 1.0, 0.2])
    end = np.array([0.5, -1.0, 0.2])
    res = solver.run(start, end)
    assert res.status == ExitCode.kOptimal
    W = res.trajectory.size // (2 * N)
    q = jnp.asarray(res.trajectory[: W * N].reshape(W, N))
    coll = np.asarray(line.has_collision(q, 0.05))
    above = np.asarray(line.is_above(q, 0.05))
    assert np.all(~coll | above)


def test_infeasible_horizon_falls_back():
    """With a workspace box the exact check can never accept, the planner
    should return kUnknown and the warm-start trajectory (graceful
    degradation, gomp-solver.h:46-51)."""
    # Gripper must stay inside a box that excludes the pinned start point.
    solver = make_solver(con3d=C.in_range(3, 5.0, 6.0), waypoints=8)
    res = solver.run(np.zeros(N), np.ones(N))
    assert res.status == ExitCode.kUnknown


def test_ur5e_small_plan():
    """Small UR5e plan (BASELINE config 3 shape): real kinematics, workspace
    floor constraint, 2 balls like the example app (solver-example.cpp:37-41)."""
    balls = [
        RobotBall(
            fk=ur5e.forward_kinematics_6_back,
            jacobian=ur5e.joint_jacobian_6_back,
            radius=0.15,
            is_gripper=False,
        ),
        RobotBall(
            fk=ur5e.forward_kinematics,
            jacobian=ur5e.joint_jacobian,
            radius=0.05,
            is_gripper=True,
        ),
    ]
    solver = GOMPSolver(
        max_waypoints=22,
        time_step=0.1,
        pos_con=C.in_range(6, -2 * np.pi, 2 * np.pi),
        vel_con=C.in_range(6, -np.pi, np.pi),
        acc_con=C.in_range(6, -np.pi * 800 / 180, np.pi * 800 / 180),
        con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], None),
        obstacles=[],
        balls=balls,
        segments=2,
    )
    # The example's base sweep 0 → π (solver-example.cpp:70): the naive path
    # dips the gripper to y ≈ -0.82; SCP must bend joints to hold y >= -0.4.
    start = np.zeros(6)
    end = np.array([np.pi, 0.0, 0.0, 0.0, 0.0, 0.0])
    res = solver.run(start, end)
    assert res.status == ExitCode.kOptimal
    W = res.trajectory.size // 12
    q = res.trajectory[: W * 6].reshape(W, 6)
    np.testing.assert_allclose(q[0], start, atol=1e-2)
    np.testing.assert_allclose(q[W - 3], end, atol=1e-2)
    # Workspace floor: gripper y >= -0.4 (± radius/ERROR slack) via exact FK.
    pts = np.stack([np.asarray(ur5e.forward_kinematics(jnp.asarray(qi))) for qi in q])
    assert np.all(pts[:, 1] + 0.05 >= -0.4 - 2e-3)


def test_run_horizon_public():
    """The fixed-horizon entry point (public in the reference,
    gomp-solver.h:57) works standalone with a caller-provided warm start."""
    solver = make_solver(waypoints=8)
    from osqp_solver_tpu.gomp.trajectory import calc_warm_start

    warm = calc_warm_start(np.zeros(N), np.ones(N), 8)
    code, sol, stats = solver.run_horizon(np.zeros(N), np.ones(N), 8, warm)
    assert code == ExitCode.kOptimal
    assert sol.shape == (2 * 8 * N,)
    assert stats.scp_iterations >= 1


def test_run_batch_fixed_horizon():
    """Batched on-device SCP planner: many (start, end) queries in one
    compiled program, masked per-problem convergence."""
    line = HorizontalLine.create([1.0, 0.0], [0.0, 0.0, 0.5], False)
    solver = make_solver(obstacles=[line], waypoints=8)
    B = 6
    starts = np.tile(np.array([0.0, 1.0, 0.2]), (B, 1))
    ends = np.tile(np.array([0.5, -1.0, 0.2]), (B, 1)) + 0.01 * np.arange(B)[:, None]
    statuses, trajs, iters = solver.run_batch(starts, ends, waypoints=8)
    assert trajs.shape == (B, 2 * 8 * N)
    assert np.all(np.asarray(statuses) == ExitCode.kOptimal)
    # per-problem clearance under exact FK
    for b in range(B):
        q = jnp.asarray(np.asarray(trajs[b][: 8 * N]).reshape(8, N))
        coll = np.asarray(line.has_collision(q, 0.05))
        above = np.asarray(line.is_above(q, 0.05))
        assert np.all(~coll | above)
    # velocities are dt-unscaled like the single-problem path
    q0 = np.asarray(trajs[0][: 8 * N]).reshape(8, N)
    v0 = np.asarray(trajs[0][8 * N :]).reshape(8, N)
    np.testing.assert_allclose(
        v0[:-1], (q0[1:] - q0[:-1]) / solver.time_step, atol=0.3
    )


def test_run_batch_lane_matches_run_batch():
    """The lane-major batched planner (fused-driver path) agrees with the
    vmapped session path: same statuses, SCP rounds, and trajectories to
    solver tolerance, including exact-FK clearance."""
    line = HorizontalLine.create([1.0, 0.0], [0.0, 0.0, 0.5], False)
    solver = make_solver(obstacles=[line], waypoints=8)
    B = 6
    starts = np.tile(np.array([0.0, 1.0, 0.2]), (B, 1))
    ends = np.tile(np.array([0.5, -1.0, 0.2]), (B, 1)) + 0.01 * np.arange(B)[:, None]
    st_v, tr_v, it_v = solver.run_batch(starts, ends, waypoints=8)
    st_l, tr_l, it_l = solver.run_batch_lane(starts, ends, waypoints=8)
    assert np.all(np.asarray(st_l) == np.asarray(st_v))
    assert np.all(np.asarray(st_l) == ExitCode.kOptimal)
    # The paths differ numerically (the lane loop re-equilibrates each SCP
    # round; the session path freezes setup scaling), so SCP round counts
    # may differ slightly and trajectories agree to solver tolerance.
    assert np.max(np.abs(np.asarray(it_l) - np.asarray(it_v))) <= 2
    np.testing.assert_allclose(
        np.asarray(tr_l), np.asarray(tr_v), atol=2e-2
    )
    for b in range(B):
        q = jnp.asarray(np.asarray(tr_l[b][: 8 * N]).reshape(8, N))
        coll = np.asarray(line.has_collision(q, 0.05))
        above = np.asarray(line.is_above(q, 0.05))
        assert np.all(~coll | above)


def test_horizon_shrink_warm_slicing_quirk():
    """Pin the reference's warm-start slicing at horizon shrink
    (gomp-solver.h:43-44): the new warm start is the first two w·N slices of
    the previous solution — when the previous horizon was longer, the
    second slice is leftover *positions*, not velocities."""
    solver = make_solver(waypoints=10, segments=2)
    start = np.zeros(N)
    end = np.array([1.0, 0.0, 0.0])
    # Monkeypatch run_horizon to capture the warm starts it receives.
    captured = []
    returned = []
    orig = solver.run_horizon

    def spy(s, e, w, warm):
        captured.append((w, np.asarray(warm).copy()))
        out = orig(s, e, w, warm)
        returned.append(np.asarray(out[1]).copy())
        return out

    solver.run_horizon = spy
    res = solver.run(start, end)
    assert res.status == ExitCode.kOptimal
    assert [w for w, _ in captured] == [10, 5]
    # warm(W=5) = prev_solution[:5N] ++ prev_solution[5N:10N] — i.e. the
    # first 2·5·N entries of the W=10 solution, whose second half is
    # leftover POSITIONS of the longer horizon (the reference quirk).
    np.testing.assert_allclose(captured[1][1], returned[0][: 2 * 5 * N])


def test_masked_builders_match_exact():
    """Pad-to-max builders (with_horizon_mask + with_gomp_boxes_masked +
    masked linearize_workspace) reproduce the exact builders' dense QP for
    every active prefix (VERDICT r1 next #8)."""
    import jax
    import numpy as np

    from osqp_solver_tpu.gomp.trajectory_qp import (
        empty_trajectory_qp,
        linearize_workspace,
        with_gomp_boxes,
        with_gomp_boxes_masked,
        with_horizon_mask,
    )
    from osqp_solver_tpu.models.robot import RobotBall

    W_max, N = 12, 2
    ball = RobotBall(
        fk=lambda s: jnp.array([s[0], s[1], s[0] + s[1]]),
        jacobian=lambda s: jnp.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
        radius=0.05,
        is_gripper=True,
    )
    con3d = (jnp.full(3, -4.0), jnp.full(3, 4.0))
    boxes = (
        (jnp.full(N, -5.0), jnp.full(N, 5.0)),
        (jnp.full(N, -1.0), jnp.full(N, 1.0)),
        (jnp.full(N, -2.0), jnp.full(N, 2.0)),
    )
    start, end = jnp.zeros(N), jnp.ones(N)
    warm_full = jnp.concatenate(
        [jnp.linspace(0, 1, W_max * N), jnp.zeros(W_max * N)]
    )

    for wa in (5, 8, 12):
        exact = empty_trajectory_qp(wa, N, (True,), 0)
        exact = with_gomp_boxes(exact, start, end, *boxes)
        warm_wa = jnp.concatenate(
            [warm_full[: wa * N], jnp.zeros(wa * N)]
        )
        exact = linearize_workspace(exact, [ball], [], con3d, warm_wa)
        P_e, q_e, A_e, l_e, u_e = (np.asarray(a) for a in exact.to_dense())

        padded = empty_trajectory_qp(W_max, N, (True,), 0)
        padded = with_horizon_mask(padded, wa)
        padded = with_gomp_boxes_masked(padded, start, end, *boxes, wa)
        warm_pad = jnp.concatenate(
            [warm_full[: W_max * N],
             jnp.zeros(W_max * N)]
        )
        padded = linearize_workspace(
            padded, [ball], [], con3d, warm_pad, w_active=wa
        )
        P_p, q_p, A_p, l_p, u_p = (np.asarray(a) for a in padded.to_dense())

        # Active sub-blocks must match exactly.  Variable order is
        # [q(0..wa) ... q(W) v(0..wa) ... v(W)] in the padded problem.
        qcols = np.arange(wa * N)
        vcols = W_max * N + np.arange(wa * N)
        cols = np.concatenate([qcols, vcols])
        np.testing.assert_allclose(P_p[np.ix_(cols, cols)], P_e, atol=1e-14)
        # padded P has no cross terms into inactive vars
        other = np.setdiff1d(np.arange(2 * W_max * N), cols)
        assert np.all(P_p[np.ix_(cols, other)] == 0)

        # Rows: map the exact compact rows into the padded compact rows.
        # Both use the same family order; compare via nonzero-bound rows.
        def live(l, u):
            return (l > -1e29) | (u < 1e29)

        live_e = live(l_e, u_e)
        live_p = live(l_p, u_p)
        assert live_e.sum() == live_p.sum()
        A_e_live = A_e[live_e]
        A_p_live = A_p[live_p][:, cols]
        np.testing.assert_allclose(A_p_live, A_e_live, atol=1e-14)
        np.testing.assert_allclose(l_p[live_p], l_e[live_e], atol=1e-14)
        np.testing.assert_allclose(u_p[live_p], u_e[live_e], atol=1e-14)
        # no live constraint may touch inactive variables
        assert np.all(A_p[live_p][:, other] == 0)


def test_run_padded_matches_run():
    """The pad-to-max time-scaling loop returns the same plan as the exact
    per-horizon loop."""
    solver = make_solver(waypoints=12)
    start = np.zeros(solver.n_dim)
    end = np.full(solver.n_dim, 0.8)
    res_exact = solver.run(start, end)
    res_padded = solver.run_padded(start, end)
    assert res_padded.status == res_exact.status
    assert res_padded.trajectory.shape == res_exact.trajectory.shape
    np.testing.assert_allclose(
        res_padded.trajectory, res_exact.trajectory, atol=1e-6
    )
    assert [s.waypoints for s in res_padded.stats] == [
        s.waypoints for s in res_exact.stats
    ]


def test_run_batch_padded_matches_run_padded():
    """The batched FULL time-scaling planner (run_batch_padded — the
    reference's flagship run(start,end) semantics vmapped over queries,
    VERDICT r3 next #1) agrees query-for-query with the per-query padded
    loop: same statuses, same winning horizons, trajectories to solver
    tolerance (lane driver vs session path numerics)."""
    line = HorizontalLine.create([1.0, 0.0], [0.0, 0.0, 0.5], False)
    solver = make_solver(obstacles=[line], waypoints=12, segments=3)
    B = 4
    starts = np.tile(np.array([0.0, 1.0, 0.2]), (B, 1))
    ends = np.tile(np.array([0.5, -1.0, 0.2]), (B, 1)) + 0.02 * np.arange(B)[
        :, None
    ]
    statuses, trajs, horizons, rounds, admm_iters = solver.run_batch_padded(
        starts, ends
    )
    W, N_ = solver.max_waypoints, solver.n_dim
    assert trajs.shape == (B, 2 * W * N_)
    for b in range(B):
        ref = solver.run_padded(starts[b], ends[b])
        assert int(statuses[b]) == int(ref.status), b
        w_ref = ref.trajectory.size // (2 * N_)
        assert int(horizons[b]) == w_ref, b
        # compact the padded batch output to the winning-horizon layout
        q = np.asarray(trajs[b][: W * N_])[: w_ref * N_]
        v = np.asarray(trajs[b][W * N_ :])[: w_ref * N_]
        got = np.concatenate([q, v])
        np.testing.assert_allclose(got, ref.trajectory, atol=2e-2)
        assert int(rounds[b]) >= len(ref.stats)  # ≥1 SCP round per segment


def test_run_batch_padded_masked_survival():
    """Queries that can never pass the exact-FK check (infeasible workspace
    box) end kUnknown at the full-horizon warm start while feasible queries
    in the SAME batch still descend to their shortest horizon — the masked
    per-query survival of the segment countdown."""
    solver = make_solver(waypoints=12, segments=3)
    feas_start = np.zeros(N)
    feas_end = np.full(N, 0.8)
    # con3d excludes the identity-FK start point for the infeasible query;
    # build a separate solver? No — same solver, make the query infeasible
    # via an unreachable position instead: start outside pos bounds is not
    # expressible, so use an end that the velocity/acc budget cannot reach
    # in 4 waypoints but CAN at 12 — the short segments go kUnknown and the
    # planner must keep the longest feasible horizon.
    far_end = np.full(N, 9.5)
    starts = np.stack([feas_start, feas_start])
    ends = np.stack([feas_end, far_end])
    statuses, trajs, horizons, _, _ = solver.run_batch_padded(starts, ends)
    ref0 = solver.run_padded(feas_start, feas_end)
    ref1 = solver.run_padded(feas_start, far_end)
    assert int(statuses[0]) == int(ref0.status)
    assert int(statuses[1]) == int(ref1.status)
    assert int(horizons[0]) == ref0.trajectory.size // (2 * N)
    assert int(horizons[1]) == ref1.trajectory.size // (2 * N)
    # the two queries must genuinely differ in their winning horizon for
    # this test to exercise masked survival
    assert int(horizons[0]) != int(horizons[1]) or int(statuses[0]) != int(
        statuses[1]
    )


def test_sphere_obstacle_avoidance():
    """A SphereObstacle (beyond-reference geometry, duck-typed protocol)
    placed on the straight-line path: the SCP plan must route around it —
    exact-FK keep-out distance ≥ R + r_ball − ERROR at every waypoint —
    while the obstacle-free straight line would violate it."""
    from osqp_solver_tpu.gomp.geometry import SphereObstacle

    center = np.array([0.25, 0.0, 0.2])
    R, r_ball = 0.3, 0.05
    sphere = SphereObstacle.create(center, radius=R, margin=0.2)
    solver = make_solver(obstacles=[sphere], waypoints=10)
    start = np.array([0.0, 1.0, 0.2])
    end = np.array([0.5, -1.0, 0.2])
    res = solver.run(start, end)
    assert res.status == ExitCode.kOptimal
    W = res.trajectory.size // (2 * N)
    q = res.trajectory[: W * N].reshape(W, N)
    d = np.linalg.norm(q - center, axis=-1)
    assert np.all(d >= R + r_ball - 1.5e-3), d.min()
    # the unconstrained straight line genuinely crosses the keep-out
    lin = np.linspace(start, end, W)
    assert np.any(np.linalg.norm(lin - center, axis=-1) < R + r_ball - 1e-3)


def test_sphere_tunneling_scp_detours():
    """VERDICT r4 next #4 (end-to-end): a coarse trajectory whose waypoints
    all CLEAR the sphere but whose segment passes through it (tunneling) is
    rejected by the exact-FK check, and the SCP — fed the segment-normal
    rows from SphereObstacle.linearize_rows — detours it until waypoints
    AND segments clear."""
    from osqp_solver_tpu.gomp.geometry import SphereObstacle

    center = np.array([0.5, 0.0, 0.0])
    R, r_ball = 0.1, 0.05
    sphere = SphereObstacle.create(center, radius=R, margin=0.1)
    solver = make_solver(obstacles=[sphere], waypoints=6, segments=1)
    start = np.array([0.0, 0.02, 0.0])
    end = np.array([1.0, -0.02, 0.0])
    # The effective straight path start → end-pinned-at-W-3 (the reference
    # quirk) has 3 hops: its waypoints all CLEAR the sphere while the
    # middle segment passes through it — pure tunneling.
    lin = np.linspace(start, end, 4)
    assert np.all(np.linalg.norm(lin - center, axis=-1) > R + r_ball)
    assert np.any(np.asarray(sphere.violates(jnp.asarray(lin), r_ball)))

    res = solver.run(start, end)
    assert res.status == ExitCode.kOptimal
    W = res.trajectory.size // (2 * N)
    q = res.trajectory[: W * N].reshape(W, N)
    v = np.asarray(sphere.violates(jnp.asarray(q), r_ball))
    assert not np.any(v), q
    # and the detour is real: the plan's segment closest-approach distance
    # clears the keep-out where the straight line's did not
    _, seg_d, _ = sphere.segment_closest(jnp.asarray(q))
    assert float(np.min(np.asarray(seg_d))) >= R + r_ball - 1.5e-3


def test_sphere_obstacle_batched_planner():
    """SphereObstacle through the batched lane planner path (the fused
    hot path builds obstacle rows via the same protocol)."""
    from osqp_solver_tpu.gomp.geometry import SphereObstacle

    center = np.array([0.25, 0.0, 0.2])
    sphere = SphereObstacle.create(center, radius=0.3, margin=0.2)
    solver = make_solver(obstacles=[sphere], waypoints=10)
    B = 3
    starts = np.tile(np.array([0.0, 1.0, 0.2]), (B, 1))
    ends = np.tile(np.array([0.5, -1.0, 0.2]), (B, 1)) + 0.01 * np.arange(
        B
    )[:, None]
    statuses, trajs, iters = solver.run_batch_lane(
        starts, ends, waypoints=10
    )
    W = 10
    assert np.all(np.asarray(statuses) == int(ExitCode.kOptimal))
    q = np.asarray(trajs)[:, : W * N].reshape(B, W, N)
    d = np.linalg.norm(q - center, axis=-1)
    assert np.all(d >= 0.3 + 0.05 - 1.5e-3), d.min()


def test_run_batch_padded_max_iter_cap_parity():
    """The fleet `max_iter=300` recommendation (BASELINE.md round-4): on
    the full time-scaling search, the OSQP-default cap (4000) burns ~91%
    of all iterations in one marginal segment that neither converges nor
    certifies infeasible — capping it must change NOTHING about the search
    outcome (statuses, winning horizons, trajectories bit-identical),
    only truncate that segment's grind.  Pinned on the reference-example
    UR5e class where the marginal segment (wa=15) was measured."""
    import dataclasses

    from osqp_solver_tpu.ops.admm import Settings

    N6, W, INF = 6, 50, 1e30
    balls = [
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    ]
    rng = np.random.default_rng(0)
    start = 0.02 * rng.standard_normal(N6)
    end = np.zeros(N6)
    end[0] = np.pi
    results = {}
    for mi in (4000, 300):
        # stall_checks=0: this test pins the max_iter KNOB against the raw
        # OSQP give-up semantics; the default stall detector would remove
        # the grind on its own (see test_run_padded_stall_default_no_knob).
        settings = dataclasses.replace(
            Settings(), rho=0.04, check_termination=3, scaling=3, max_iter=mi,
            stall_checks=0,
        )
        solver = GOMPSolver(
            max_waypoints=W,
            time_step=0.1,
            settings=settings,
            pos_con=C.in_range(N6, -2 * np.pi, 2 * np.pi),
            vel_con=C.in_range(N6, -np.pi, np.pi),
            acc_con=C.in_range(N6, -800 * np.pi / 180, 800 * np.pi / 180),
            con_3d=C.Constraint(
                lower=np.array([-INF, -0.4, -INF]), upper=np.full(3, INF)
            ),
            obstacles=[],
            balls=balls,
            segments=10,
            dtype=jnp.float32,
        )
        results[mi] = solver.run_padded(start, end)
    a, b = results[4000], results[300]
    assert a.status == b.status == ExitCode.kOptimal
    assert a.trajectory.size == b.trajectory.size  # same winning horizon
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    # the cap must actually have bitten (else this test pins nothing)
    it_a = sum(s.admm_iterations for s in a.stats)
    it_b = sum(s.admm_iterations for s in b.stats)
    assert it_a > 2000 and it_b < it_a / 4, (it_a, it_b)


def test_run_padded_stall_default_no_knob():
    """VERDICT r4 next #2: the DEFAULT-settings full search must get the
    capped row's cost with no knob.  The in-solver stall detector
    (Settings.stall_checks, on by default) cuts the marginal segment's
    never-certifying plateau where the old remedy needed an explicit
    ``max_iter=300``: same statuses/horizons/trajectories bit-for-bit as
    the raw-OSQP run, total iterations at or below the capped row's
    (measured on this class: 4392 raw → 690 capped → 375 stalled)."""
    import dataclasses

    from osqp_solver_tpu.ops.admm import Settings

    N6, W, INF = 6, 50, 1e30
    balls = [
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    ]
    rng = np.random.default_rng(0)
    start = 0.02 * rng.standard_normal(N6)
    end = np.zeros(N6)
    end[0] = np.pi

    def run(**over):
        settings = dataclasses.replace(
            Settings(), rho=0.04, check_termination=3, scaling=3, **over
        )
        solver = GOMPSolver(
            max_waypoints=W,
            time_step=0.1,
            settings=settings,
            pos_con=C.in_range(N6, -2 * np.pi, 2 * np.pi),
            vel_con=C.in_range(N6, -np.pi, np.pi),
            acc_con=C.in_range(N6, -800 * np.pi / 180, 800 * np.pi / 180),
            con_3d=C.Constraint(
                lower=np.array([-INF, -0.4, -INF]), upper=np.full(3, INF)
            ),
            obstacles=[],
            balls=balls,
            segments=10,
            dtype=jnp.float32,
        )
        return solver.run_padded(start, end)

    raw = run(stall_checks=0)  # OSQP give-up semantics: grinds to 4000
    cap = run(stall_checks=0, max_iter=300)  # the round-4 knob
    stalled = run()  # defaults: stall detector on, no knob
    assert raw.status == cap.status == stalled.status == ExitCode.kOptimal
    np.testing.assert_array_equal(raw.trajectory, stalled.trajectory)
    np.testing.assert_array_equal(cap.trajectory, stalled.trajectory)
    it_raw = sum(s.admm_iterations for s in raw.stats)
    it_cap = sum(s.admm_iterations for s in cap.stats)
    it_stall = sum(s.admm_iterations for s in stalled.stats)
    assert it_raw > 2000, it_raw  # the grind exists without the detector
    # the VERDICT bar is 1.5x of the capped row; measured it BEATS the cap
    assert it_stall <= 1.5 * it_cap, (it_stall, it_cap)
    assert it_stall < it_raw / 4, (it_stall, it_raw)


def test_batch_paths_preserve_optimal_inaccurate():
    """VERDICT r4 next #3: all planner paths share run_horizon's status
    ladder — an accepted solve that only certified the 10×-relaxed
    tolerance reports kOptimalInaccurate from the batched paths too,
    instead of being silently promoted to kOptimal."""
    from osqp_solver_tpu.ops.admm import Settings

    # max_iter=16 cuts this query exactly in its inaccurate window
    # (solved at 20, 10×-relaxed from 16; stall never fires that early).
    s = Settings(max_iter=16, check_termination=1, stall_checks=0)
    start = np.zeros(N)
    end = np.array([1.0, 0.5, -0.25])
    W = 12
    solver = make_solver(waypoints=W, settings=s)
    warm = np.concatenate(
        [np.linspace(start, end, W).ravel(), np.zeros(W * N)]
    )
    code, _, _ = solver.run_horizon(start, end, W, warm)
    assert code == ExitCode.kOptimalInaccurate  # the ladder's source path

    starts = np.stack([start, start])
    ends = np.stack([end, end * 0.5])
    st_b, _, _ = solver.run_batch(starts, ends, W)
    st_l, _, _ = solver.run_batch_lane(starts, ends, W)
    assert int(np.asarray(st_b)[0]) == ExitCode.kOptimalInaccurate
    np.testing.assert_array_equal(np.asarray(st_b), np.asarray(st_l))
    # and at full iterations the same queries report clean kOptimal
    solver_full = make_solver(waypoints=W)
    st_f, _, _ = solver_full.run_batch(starts, ends, W)
    assert all(int(c) == ExitCode.kOptimal for c in np.asarray(st_f))


def test_run_batch_padded_warm_duals_same_outcomes():
    """`warm_duals=True` (beyond-reference: duals carried across segments)
    is accuracy-neutral — statuses and winning horizons match the
    primal-only reference semantics.  Measured a NEGATIVE on the UR5e
    class (p50 iterations 699 -> 742: stale duals from the previous
    horizon's geometry mis-warm the shifted active set; BASELINE.md
    round-4) — kept opt-in as the in-tree record."""
    solver = make_solver(waypoints=12, segments=3)
    B = 4
    starts = np.tile(np.array([0.0, 1.0, 0.2]), (B, 1))
    ends = np.tile(np.array([0.5, -1.0, 0.2]), (B, 1)) + 0.02 * np.arange(B)[
        :, None
    ]
    st0, _, hz0, _, _ = solver.run_batch_padded(starts, ends)
    st1, _, hz1, _, _ = solver.run_batch_padded(
        starts, ends, warm_duals=True
    )
    np.testing.assert_array_equal(np.asarray(st0), np.asarray(st1))
    np.testing.assert_array_equal(np.asarray(hz0), np.asarray(hz1))


def test_ur5e_soa_balls_match_matrix_balls():
    """The planner run with SoA-evaluator balls (ur5e.make_ball — the planner
    hot path: batched FK + geometric Jacobian in linearize_workspace AND the
    exact-FK check) produces the same plan as the matrix-FK balls."""
    balls_soa = [
        ur5e.make_ball("back6", 0.15),
        ur5e.make_ball("tool", 0.05, is_gripper=True),
    ]
    balls_mat = [
        RobotBall(fk=ur5e.forward_kinematics_6_back,
                  jacobian=ur5e.joint_jacobian_6_back, radius=0.15),
        RobotBall(fk=ur5e.forward_kinematics, jacobian=ur5e.joint_jacobian,
                  radius=0.05, is_gripper=True),
    ]
    start = np.zeros(6)
    end = np.array([np.pi, 0.0, 0.0, 0.0, 0.0, 0.0])
    results = []
    for balls in (balls_soa, balls_mat):
        solver = GOMPSolver(
            max_waypoints=22,
            time_step=0.1,
            pos_con=C.in_range(6, -2 * np.pi, 2 * np.pi),
            vel_con=C.in_range(6, -np.pi, np.pi),
            acc_con=C.in_range(6, -np.pi * 800 / 180, np.pi * 800 / 180),
            con_3d=C.in_range(3, [-C.INF, -0.4, -C.INF], None),
            obstacles=[],
            balls=balls,
            segments=1,
        )
        results.append(solver.run(start, end))
    assert results[0].status == results[1].status == ExitCode.kOptimal
    np.testing.assert_allclose(
        results[0].trajectory, results[1].trajectory, rtol=0, atol=1e-9
    )
