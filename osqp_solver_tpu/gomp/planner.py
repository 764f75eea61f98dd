"""GOMP planner: SCP loop + time-scaling horizon shrinking.

JAX-native re-design of ``GOMPSolver`` (the reference's ``src/gomp-solver.h``,
203 LoC).  Orchestration stays on the host (horizon lengths change shapes per
segment — SURVEY.md §3.1), but every step of the hot path is one jitted
device program per horizon length:

    solve (warm-started ADMM) → exact-FK feasibility check →
    SCP re-linearization → values-only session update

The device programs are cached per horizon length; the batched planner
(:meth:`GOMPSolver.run_batch`) vmaps the same programs over many
(start, end) queries at a fixed horizon.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.robot import RobotBall
from ..ops import session as ops_session
from ..ops import admm as admm_mod
from ..ops.admm import Settings
from ..ops.status import ExitCode
from .constraints import Constraint, scaled
from .geometry import ERROR, HorizontalLine
from .trajectory import calc_warm_start_jnp
from .trajectory_qp import (
    empty_trajectory_qp,
    linearize_workspace,
    pinned_movable_mask,
    with_gomp_boxes,
)

MAX_ITERATIONS = 100  # SCP re-linearization cap (gomp-solver.h:10)
SEGMENTS = 10  # time-scaling steps (gomp-solver.h:11)


class SegmentStats(NamedTuple):
    waypoints: int
    scp_iterations: int
    admm_iterations: int
    status: int


class PlanResult(NamedTuple):
    status: ExitCode
    trajectory: np.ndarray  # (2*W*N,) positions then velocities (unscaled)
    stats: List[SegmentStats]


class GOMPSolver:
    """Mirror of ``GOMPSolver<N_DIM>`` (``gomp-solver.h:14-91``).

    ``vel_con``/``acc_con`` are pre-scaled by ``dt`` and ``dt²`` at
    construction (``gomp-solver.h:29-30``) so dynamics rows stay
    unit-coefficient; the returned trajectory's velocity half is divided by
    ``dt`` (``gomp-solver.h:53``).
    """

    def __init__(
        self,
        max_waypoints: int,
        time_step: float,
        pos_con: Constraint,
        vel_con: Constraint,
        acc_con: Constraint,
        con_3d: Constraint,
        obstacles: Sequence,  # HorizontalLine | SphereObstacle (duck-typed)
        balls: Sequence[RobotBall],
        gripper_ik=None,  # stored-but-unused in the reference (gomp-solver.h:34,103)
        settings: Settings = Settings(),
        max_scp_iterations: int = MAX_ITERATIONS,
        segments: int = SEGMENTS,
        dtype=jnp.float64,
    ):
        assert max_waypoints >= 4  # gomp-solver.h:35
        self.max_waypoints = int(max_waypoints)
        self.time_step = float(time_step)
        self.n_dim = pos_con.n
        self.pos_con = pos_con
        self.vel_con = scaled(vel_con, self.time_step)
        self.acc_con = scaled(acc_con, self.time_step**2)
        self.con_3d = con_3d
        self.obstacles = list(obstacles)
        self.balls = tuple(balls)
        self.gripper_ik = gripper_ik
        self.settings = settings
        self.max_scp_iterations = int(max_scp_iterations)
        self.segments = int(segments)
        self.dtype = dtype
        self._compiled: Dict[int, Tuple] = {}

    # ------------------------------------------------------------------ jit

    def _programs(self, waypoints: int):
        """Build (setup_fn, step_fn) jitted for this horizon length."""
        if waypoints in self._compiled:
            return self._compiled[waypoints]
        W, N = waypoints, self.n_dim
        balls, obstacles, con3d = self.balls, self.obstacles, (
            jnp.asarray(self.con_3d.lower, self.dtype),
            jnp.asarray(self.con_3d.upper, self.dtype),
        )
        # Long-horizon f32 conditioning: engage iterative refinement
        # automatically (admm.refine_steps_for_horizon policy).
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)

        def build_qp(start, end, warm):
            qp = empty_trajectory_qp(
                W, N, [b.is_gripper for b in balls], len(obstacles), self.dtype
            )
            qp = with_gomp_boxes(
                qp,
                start,
                end,
                (jnp.asarray(self.pos_con.lower, self.dtype), jnp.asarray(self.pos_con.upper, self.dtype)),
                (jnp.asarray(self.vel_con.lower, self.dtype), jnp.asarray(self.vel_con.upper, self.dtype)),
                (jnp.asarray(self.acc_con.lower, self.dtype), jnp.asarray(self.acc_con.upper, self.dtype)),
            )
            return linearize_workspace(
                qp, balls, obstacles, con3d, warm,
                movable=pinned_movable_mask(W),
            )

        # Exact nonlinear-FK feasibility (``gomp-solver.h:141-199``):
        # gripper within the 3-D box ± radius ± ERROR; all balls clear of
        # every obstacle wherever a collision is flagged.  SoA-aware
        # (RobotBall.fk_jac_batched) — shared with the batched paths.
        is_solution_ok = self._is_solution_ok_fn(W)

        @jax.jit
        def setup_fn(start, end, warm):
            qp = build_qp(start, end, warm)
            return ops_session.setup(qp, settings, warm_x=warm)

        @jax.jit
        def step_fn(sess):
            sess, res = ops_session.solve(sess, settings)
            ok = is_solution_ok(res.x)
            new_qp = linearize_workspace(
                sess.base, balls, obstacles, con3d, res.x,
                movable=pinned_movable_mask(W),
            )
            sess = ops_session.update(sess, new_qp)
            return sess, res.x, res.status, ok, res.iterations

        self._compiled[waypoints] = (setup_fn, step_fn)
        return self._compiled[waypoints]

    # ---------------------------------------------------------------- inner

    def run_horizon(
        self, start, end, waypoints: int, warm_start
    ) -> Tuple[ExitCode, jnp.ndarray, SegmentStats]:
        """One fixed-horizon SCP solve (``gomp-solver.h:57-91``): solve, check
        exact-FK feasibility, re-linearize + update, repeat ≤ 100×."""
        assert waypoints >= 4
        setup_fn, step_fn = self._programs(waypoints)
        start = jnp.asarray(start, self.dtype)
        end = jnp.asarray(end, self.dtype)
        warm = jnp.asarray(warm_start, self.dtype)
        sess = setup_fn(start, end, warm)

        last_solution = warm
        total_admm = 0
        for i in range(self.max_scp_iterations):
            sess, x, status, ok, iters = step_fn(sess)
            status = int(status)
            total_admm += int(iters)
            last_solution = x
            if status not in (int(ExitCode.kOptimal), int(ExitCode.kOptimalInaccurate)):
                # No solution at this horizon (gomp-solver.h:72-76).
                return (
                    ExitCode.kUnknown,
                    last_solution,
                    SegmentStats(waypoints, i + 1, total_admm, status),
                )
            if bool(ok):
                # Propagate kOptimalInaccurate rather than promoting it: the
                # reference treats anything but kOptimal as failure
                # (gomp-solver.h:72-76), so a 10x-relaxed-tolerance solve must
                # stay distinguishable for the caller.
                return (
                    ExitCode.kOptimal
                    if status == int(ExitCode.kOptimal)
                    else ExitCode.kOptimalInaccurate,
                    last_solution,
                    SegmentStats(waypoints, i + 1, total_admm, status),
                )
        return (
            ExitCode.kUnknown,
            last_solution,
            SegmentStats(waypoints, self.max_scp_iterations, total_admm, -1),
        )

    # ------------------------------------------------------------- padded

    def _padded_programs(self):
        """ONE jitted (setup, step) pair at ``W_max`` with the active horizon
        length a *traced* argument — the whole 10-segment time-scaling loop
        (``gomp-solver.h:38-55``) runs with zero per-horizon recompiles
        (VERDICT r1 next #8; pad-to-max discipline in
        ``trajectory_qp.with_horizon_mask``)."""
        key = ("padded",)
        if key in self._compiled:
            return self._compiled[key]
        from .trajectory_qp import with_gomp_boxes_masked, with_horizon_mask

        W, N = self.max_waypoints, self.n_dim
        balls, obstacles = self.balls, self.obstacles
        con3d = (
            jnp.asarray(self.con_3d.lower, self.dtype),
            jnp.asarray(self.con_3d.upper, self.dtype),
        )
        boxes = tuple(
            (jnp.asarray(c.lower, self.dtype), jnp.asarray(c.upper, self.dtype))
            for c in (self.pos_con, self.vel_con, self.acc_con)
        )
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)

        def build_qp(start, end, warm, wa):
            qp = empty_trajectory_qp(
                W, N, [b.is_gripper for b in balls], len(obstacles), self.dtype
            )
            qp = with_horizon_mask(qp, wa)
            qp = with_gomp_boxes_masked(qp, start, end, *boxes, wa)
            return linearize_workspace(
                qp, balls, obstacles, con3d, warm, w_active=wa,
                movable=pinned_movable_mask(W, wa),
            )

        # Masked-horizon exact-FK feasibility — shared with
        # run_batch_padded (W here is the padded W_max).
        is_solution_ok = self._is_solution_ok_masked_fn(W)

        @jax.jit
        def setup_fn(start, end, warm, wa):
            qp = build_qp(start, end, warm, wa)
            return ops_session.setup(qp, settings, warm_x=warm)

        @jax.jit
        def step_fn(sess, wa):
            sess, res = ops_session.solve(sess, settings)
            ok = is_solution_ok(res.x, wa)
            new_qp = linearize_workspace(
                sess.base, balls, obstacles, con3d, res.x, w_active=wa,
                movable=pinned_movable_mask(W, wa),
            )
            sess = ops_session.update(sess, new_qp, settings=settings)
            return sess, res.x, res.status, ok, res.iterations

        self._compiled[key] = (setup_fn, step_fn)
        return self._compiled[key]

    def run_horizon_padded(
        self, start, end, w_active: int, warm_start
    ) -> Tuple[ExitCode, jnp.ndarray, SegmentStats]:
        """One SCP solve at a traced horizon inside the W_max program.
        ``warm_start`` is in padded reference layout (2·W_max·N,)."""
        assert 4 <= w_active <= self.max_waypoints
        setup_fn, step_fn = self._padded_programs()
        start = jnp.asarray(start, self.dtype)
        end = jnp.asarray(end, self.dtype)
        warm = jnp.asarray(warm_start, self.dtype)
        wa = jnp.asarray(w_active, jnp.int32)
        sess = setup_fn(start, end, warm, wa)

        last_solution = warm
        total_admm = 0
        for i in range(self.max_scp_iterations):
            sess, x, status, ok, iters = step_fn(sess, wa)
            status = int(status)
            total_admm += int(iters)
            last_solution = x
            if status not in (
                int(ExitCode.kOptimal), int(ExitCode.kOptimalInaccurate)
            ):
                return (
                    ExitCode.kUnknown,
                    last_solution,
                    SegmentStats(w_active, i + 1, total_admm, status),
                )
            if bool(ok):
                return (
                    ExitCode.kOptimal
                    if status == int(ExitCode.kOptimal)
                    else ExitCode.kOptimalInaccurate,
                    last_solution,
                    SegmentStats(w_active, i + 1, total_admm, status),
                )
        return (
            ExitCode.kUnknown,
            last_solution,
            SegmentStats(w_active, self.max_scp_iterations, total_admm, -1),
        )

    def _slice_warm_padded(self, sol_padded, w_prev: int, w_new: int):
        """The reference's warm-start slicing quirk (``gomp-solver.h:43-44``)
        applied in padded layout: slice the first two ``w_new·N`` windows of
        the previous COMPACT solution (when the previous horizon was longer
        the second window is leftover positions), then re-pad."""
        W, N = self.max_waypoints, self.n_dim
        sol = np.asarray(sol_padded)
        q, v = sol[: W * N], sol[W * N :]
        compact = np.concatenate([q[: w_prev * N], v[: w_prev * N]])
        wn = w_new * N
        out_q = np.zeros(W * N, sol.dtype)
        out_v = np.zeros(W * N, sol.dtype)
        out_q[:wn] = compact[:wn]
        out_v[:wn] = compact[wn : 2 * wn]
        return np.concatenate([out_q, out_v])

    def run_padded(self, start_pos, end_pos) -> PlanResult:
        """Time-scaling outer loop with the pad-to-max single program: same
        semantics as :meth:`run` (including warm-start slicing quirks), but
        every segment reuses ONE compiled (setup, step) pair, so wall-clock
        is dominated by solving, not per-horizon compiles."""
        W, N = self.max_waypoints, self.n_dim
        start = jnp.asarray(start_pos, self.dtype)
        end = jnp.asarray(end_pos, self.dtype)
        from .trajectory import calc_warm_start_masked

        last_code = ExitCode.kUnknown
        last_solution = np.asarray(calc_warm_start_masked(start, end, W, W))
        last_w = W
        stats: List[SegmentStats] = []

        for i in range(self.segments, 0, -1):
            waypoints = self.max_waypoints * i // self.segments
            if waypoints < 4:
                break
            warm = self._slice_warm_padded(last_solution, last_w, waypoints)
            code, solution, seg_stats = self.run_horizon_padded(
                start, end, waypoints, warm
            )
            stats.append(seg_stats)
            if code not in (ExitCode.kOptimal, ExitCode.kUnknown):
                break
            if code == ExitCode.kOptimal:
                last_code = ExitCode.kOptimal
                last_solution = np.asarray(solution)
                last_w = waypoints

        # Compact the padded solution to the winning horizon's layout and
        # unscale velocities (gomp-solver.h:53).
        sol = np.asarray(last_solution)
        q, v = sol[: W * N], sol[W * N :]
        out = np.concatenate([q[: last_w * N], v[: last_w * N]])
        out[last_w * N :] /= self.time_step
        return PlanResult(status=last_code, trajectory=out, stats=stats)

    # ---------------------------------------------------------------- outer

    def run(self, start_pos, end_pos) -> PlanResult:
        """Time-scaling outer loop (``gomp-solver.h:38-55``): shrink the
        horizon ``segments → 1``, warm-starting each segment from the
        previous solution; keep the shortest feasible trajectory."""
        N = self.n_dim
        start = jnp.asarray(start_pos, self.dtype)
        end = jnp.asarray(end_pos, self.dtype)
        last_solution = calc_warm_start_jnp(start, end, self.max_waypoints)
        last_code = ExitCode.kUnknown
        stats: List[SegmentStats] = []

        for i in range(self.segments, 0, -1):
            waypoints = self.max_waypoints * i // self.segments
            if waypoints < 4:
                break
            # Reference warm-start slicing (gomp-solver.h:43-44): the first
            # two wN-slices of the previous solution — when the previous
            # horizon was longer, the "velocity" half is actually leftover
            # positions.  Quirk replicated deliberately.
            wn = waypoints * N
            warm = jnp.concatenate([last_solution[:wn], last_solution[wn : 2 * wn]])
            code, solution, seg_stats = self.run_horizon(start, end, waypoints, warm)
            stats.append(seg_stats)
            if code not in (ExitCode.kOptimal, ExitCode.kUnknown):
                break
            if code == ExitCode.kOptimal:
                last_code = ExitCode.kOptimal
                last_solution = solution

        sol = np.asarray(last_solution).copy()
        half = sol.size // 2
        sol[half:] /= self.time_step  # unscale velocities (gomp-solver.h:53)
        return PlanResult(status=last_code, trajectory=sol, stats=stats)

    # ---------------------------------------------------------------- batch

    def run_batch(self, starts, ends, waypoints: int, max_scp: Optional[int] = None,
                  obstacles=None):
        """Batched fixed-horizon planner: one device program runs the whole
        SCP loop (solve → exact-FK check → re-linearize → update) for a batch
        of (start, end) queries with masked per-problem convergence — the
        production-scale path (thousands of trajectory queries per chip,
        SURVEY.md §2.3).

        ``obstacles``: optional per-query obstacles (leaves with a leading
        ``(B,)`` axis, ``geometry.stack_obstacles``) — see
        :meth:`run_batch_lane`.

        Returns ``(statuses, trajectories, scp_iters)`` with velocities
        unscaled by dt; statuses are per-problem ``ExitCode`` ints with
        :meth:`run_horizon`'s ladder — ``kOptimal`` (exact-FK check passed
        at full tolerance), ``kOptimalInaccurate`` (passed, but the solve
        only certified the 10×-relaxed tolerance), else ``kUnknown``.
        """
        import jax

        W, N = int(waypoints), self.n_dim
        assert W >= 4
        max_scp = self.max_scp_iterations if max_scp is None else int(max_scp)
        balls = self.balls
        con3d = (
            jnp.asarray(self.con_3d.lower, self.dtype),
            jnp.asarray(self.con_3d.upper, self.dtype),
        )
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)

        starts = jnp.asarray(starts, self.dtype)
        ends = jnp.asarray(ends, self.dtype)
        obs, per_query = self._obstacles_arg(obstacles, starts.shape[0])
        obs_ax = 0 if per_query else None
        is_ok1 = self._is_solution_ok_fn(W, per_query_obs=True)

        def plan_one(start, end, obstacles):
            warm = calc_warm_start_jnp(start, end, W)
            sess = self._build_session(
                start, end, warm, W, settings, obstacles=obstacles
            )

            def cond(carry):
                sess, x, status, ok, k = carry
                running = (~ok) & (
                    (status == ExitCode.kOptimal)
                    | (status == ExitCode.kUnknown)
                    | (status == ExitCode.kOptimalInaccurate)
                )
                return running & (k < max_scp)

            def body(carry):
                sess, x, status, ok, k = carry
                sess, res = ops_session.solve(sess, settings)
                ok = is_ok1(res.x, obstacles)
                new_qp = linearize_workspace(
                    sess.base, balls, obstacles, con3d, res.x,
                    movable=pinned_movable_mask(W),
                )
                sess = ops_session.update(sess, new_qp, settings=settings)
                return (sess, res.x, res.status, ok, k + 1)

            init = (
                sess,
                warm,
                jnp.full((), ExitCode.kUnknown, jnp.int32),
                jnp.zeros((), bool),
                jnp.zeros((), jnp.int32),
            )
            sess, x, status, ok, k = jax.lax.while_loop(cond, body, init)
            # Same status ladder as run_horizon (planner.py:177-187): an
            # accepted solve that only reached the 10×-relaxed tolerance
            # stays distinguishable as kOptimalInaccurate.
            final_status = jnp.where(
                ok,
                jnp.where(
                    status == ExitCode.kOptimalInaccurate,
                    jnp.int32(ExitCode.kOptimalInaccurate),
                    jnp.int32(ExitCode.kOptimal),
                ),
                jnp.int32(ExitCode.kUnknown),
            ).astype(jnp.int32)
            half = W * N
            x = jnp.concatenate([x[:half], x[half:] / self.time_step])
            return final_status, x, k

        key = ("batch", W, max_scp, per_query)
        if key not in self._compiled:
            self._compiled[key] = jax.jit(
                jax.vmap(plan_one, in_axes=(0, 0, obs_ax))
            )
        return self._compiled[key](starts, ends, obs)

    def run_batch_lane(
        self, starts, ends, waypoints: int, max_scp: Optional[int] = None,
        obstacles=None,
    ):
        """Batched fixed-horizon planner on the lane-major fused driver.

        Same contract and semantics as :meth:`run_batch` (SCP loop of
        solve → exact-FK check → re-linearize, ``gomp-solver.h:57-91``), but
        the whole batch is solved **together** each SCP round by
        :func:`~osqp_solver_tpu.ops.admm_lane.solve_batched_lane` (the
        fused ADMM chunk kernel where ``ops/backend.py`` selects it).  Per-problem SCP convergence is
        masked: finished problems keep their accepted solution/status while
        the batch keeps iterating (re-solves of frozen problems are
        discarded — the batch is done when every problem is).

        ``obstacles``: optional PER-QUERY obstacles — a sequence matching
        the constructor's obstacle count whose pytree leaves carry a
        leading ``(B,)`` per-problem axis (``geometry.stack_obstacles``):
        every query is planned against its OWN obstacle poses inside the
        same compiled program (leaf values are traced — moving an obstacle
        never recompiles).  ``None`` → the constructor's obstacles, shared
        by the whole batch.

        Returns ``(statuses, trajectories, scp_iters)`` exactly like
        :meth:`run_batch` (same status ladder, inaccurate acceptances
        included).
        """
        W = int(waypoints)
        assert W >= 4
        max_scp = self.max_scp_iterations if max_scp is None else int(max_scp)
        starts = jnp.asarray(starts, self.dtype)
        obs, per_query = self._obstacles_arg(obstacles, starts.shape[0])
        key = ("batch_lane", W, max_scp, per_query)
        if key not in self._compiled:
            self._compiled[key] = jax.jit(
                self._plan_batch_lane_program(W, max_scp, per_query)
            )
        return self._compiled[key](
            starts, jnp.asarray(ends, self.dtype), obs
        )

    def run_batch_lane_sharded(
        self, starts, ends, waypoints: int, mesh,
        axis: Optional[str] = None, max_scp: Optional[int] = None,
        obstacles=None,
    ):
        """:meth:`run_batch_lane` scaled out over ``mesh[axis]`` — the
        planner-layer DP scale-out (SURVEY.md §2.3: one solver per problem,
        ``gomp-solver.h:61-64``, sharded over chips/hosts).  The batch axis
        of ``starts``/``ends`` splits across the mesh with ``shard_map``;
        each device runs the SAME masked-SCP program on its shard with its
        own while-loop (zero collectives inside the solve, so scaling is
        near-linear like :func:`parallel.batch.solve_batch_sharded`).
        Per-query ``obstacles`` (see :meth:`run_batch_lane`) shard with the
        queries; constructor obstacles replicate.

        The batch size must divide by the axis size.  Returns exactly what
        :meth:`run_batch_lane` returns.
        """
        from jax.sharding import PartitionSpec
        from ..parallel.mesh import BATCH_AXIS

        axis = BATCH_AXIS if axis is None else axis
        W = int(waypoints)
        assert W >= 4
        max_scp = self.max_scp_iterations if max_scp is None else int(max_scp)
        starts = jnp.asarray(starts, self.dtype)
        obs, per_query = self._obstacles_arg(obstacles, starts.shape[0])
        key = ("batch_lane_sharded", W, max_scp, mesh, axis, per_query)
        if key not in self._compiled:
            spec = PartitionSpec(axis)
            obs_spec = spec if per_query else PartitionSpec()
            fn = jax.shard_map(
                self._plan_batch_lane_program(W, max_scp, per_query),
                mesh=mesh,
                in_specs=(spec, spec, obs_spec),
                out_specs=(spec, spec, spec),
                check_vma=False,
            )
            self._compiled[key] = jax.jit(fn)
        return self._compiled[key](
            starts, jnp.asarray(ends, self.dtype), obs
        )

    def _obstacles_arg(self, obstacles, B: int):
        """Resolve the optional per-query ``obstacles`` argument of the
        batched planner paths: ``None`` → the constructor's obstacles
        (shared by every query, traced like any other program input);
        otherwise a sequence matching the constructor's obstacle count
        whose pytree leaves carry a leading ``(B,)`` per-problem axis
        (build with :func:`~osqp_solver_tpu.gomp.geometry.stack_obstacles`).
        Returns ``(obstacle_list, per_query: bool)``."""
        if obstacles is None:
            return list(self.obstacles), False
        obstacles = list(obstacles)
        if len(obstacles) != len(self.obstacles):
            raise ValueError(
                "per-query obstacles must match the constructor's obstacle "
                f"count ({len(self.obstacles)}; the obstacle-row layout is "
                f"static) — got {len(obstacles)}"
            )
        for o in obstacles:
            for leaf in jax.tree_util.tree_leaves(o):
                if jnp.ndim(leaf) < 1 or jnp.shape(leaf)[0] != B:
                    raise ValueError(
                        "per-query obstacle leaves need a leading batch "
                        f"axis of size {B} (geometry.stack_obstacles); got "
                        f"a leaf of shape {jnp.shape(leaf)}"
                    )
        return obstacles, True

    def _plan_batch_lane_program(
        self, W: int, max_scp: int, per_query_obs: bool = False
    ):
        """Build the traceable batched fixed-horizon program behind
        :meth:`run_batch_lane` — shared by the single-device ``jit`` and
        the ``shard_map`` wrapper (each device traces it per shard).

        The program takes ``(starts, ends, obstacles)``; with
        ``per_query_obs`` each obstacle pytree carries a leading ``(B,)``
        per-problem axis on every leaf (``geometry.stack_obstacles``) and is
        vmapped alongside the queries — one compiled program plans a fleet
        where EVERY query has its own obstacle poses (traced values: moving
        an obstacle never recompiles)."""
        from ..ops.admm_lane import solve_batched_lane
        from .trajectory_qp_lane import from_trailing

        N = self.n_dim
        balls = self.balls
        n_obs = len(self.obstacles)
        con3d = (
            jnp.asarray(self.con_3d.lower, self.dtype),
            jnp.asarray(self.con_3d.upper, self.dtype),
        )
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)
        boxes = tuple(
            (jnp.asarray(c.lower, self.dtype), jnp.asarray(c.upper, self.dtype))
            for c in (self.pos_con, self.vel_con, self.acc_con)
        )
        is_ok1 = self._is_solution_ok_fn(W, per_query_obs=True)
        obs_ax = 0 if per_query_obs else None

        def build_one(start, end, obstacles):
            warm = calc_warm_start_jnp(start, end, W)
            qp = empty_trajectory_qp(
                W, N, [b.is_gripper for b in balls], n_obs, self.dtype
            )
            qp = with_gomp_boxes(qp, start, end, *boxes)
            return linearize_workspace(
                qp, balls, obstacles, con3d, warm,
                movable=pinned_movable_mask(W),
            ), warm

        def plan_batch(starts, ends, obstacles):
            # Trailing-batch container: assembly writes lane layout directly.
            qp_t, x = jax.vmap(
                build_one, in_axes=(0, 0, obs_ax), out_axes=-1
            )(starts, ends, obstacles)
            B = starts.shape[0]
            # Dual vectors live in the LANE row space (padded waypoint-major
            # rows), not the TrajectoryQP row space.
            m = from_trailing(qp_t, row_layout="waypoint").l.shape[0]
            lin_b = jax.vmap(
                lambda qp, xi, obs: linearize_workspace(
                    qp, balls, obs, con3d, xi,
                    movable=pinned_movable_mask(W),
                ),
                in_axes=(-1, -1, obs_ax),
                out_axes=-1,
            )
            ok_b = jax.vmap(is_ok1, in_axes=(-1, obs_ax))

            status0 = jnp.full((B,), ExitCode.kUnknown, jnp.int32)
            done0 = jnp.zeros((B,), bool)
            k0 = jnp.zeros((B,), jnp.int32)
            # Dual warm start carried across SCP rounds (the session path's
            # warm_y, osqp-wrapper.h Solve()-to-Solve() carry): without it
            # the re-linearization can limit-cycle between two
            # linearization points that both fail the exact-FK check.
            y0 = jnp.zeros((m, B), qp_t.q.dtype)

            def cond(carry):
                _, _, _, _, _, done, k = carry
                return jnp.any(~done) & (jnp.max(k) < max_scp)

            def body(carry):
                qp_t, x, y, status, ok, done, k = carry
                lane = from_trailing(qp_t, row_layout="waypoint")
                res = solve_batched_lane(
                    lane, settings, warm_x=x.T, warm_y=y.T
                )
                xs = jnp.where(done, x, res.x.T)
                y = jnp.where(done, y, res.y.T)
                status = jnp.where(done, status, res.status).astype(jnp.int32)
                ok = jnp.where(done, ok, ok_b(xs, obstacles))
                solvable = (status == ExitCode.kOptimal) | (
                    status == ExitCode.kOptimalInaccurate
                )
                k = k + jnp.where(done, 0, 1).astype(jnp.int32)
                done = done | ok | ~solvable
                qp_t = lin_b(qp_t, xs, obstacles)
                return qp_t, xs, y, status, ok, done, k

            _, x, _, status, ok, _, k = jax.lax.while_loop(
                cond, body, (qp_t, x, y0, status0, done0, done0, k0)
            )
            # run_horizon's status ladder (planner.py:177-187): inaccurate
            # acceptances stay visible instead of being promoted.
            final_status = jnp.where(
                ok,
                jnp.where(
                    status == ExitCode.kOptimalInaccurate,
                    jnp.int32(ExitCode.kOptimalInaccurate),
                    jnp.int32(ExitCode.kOptimal),
                ),
                jnp.int32(ExitCode.kUnknown),
            ).astype(jnp.int32)
            half = W * N
            x = jnp.concatenate([x[:half], x[half:] / self.time_step], axis=0)
            return final_status, x.T, k

        return plan_batch

    def run_batch_padded(self, starts, ends, max_scp: Optional[int] = None,
                         warm_duals: bool = False, obstacles=None):
        """Batched FULL time-scaling planner — the reference's flagship
        ``run(start, end)`` semantics (``gomp-solver.h:38-55``: 10-segment
        horizon-shrinking search, warm-start slicing quirk included) vmapped
        over (start, end) queries inside ONE compiled device program.

        Per segment the whole batch runs one masked SCP loop on the
        lane-major fused driver at the segment's traced horizon ``wa``
        inside the ``W_max``-padded containers; per-query survival is
        masked — a query keeps its best feasible solution (``kOptimal`` at
        the shortest feasible horizon so far) while the batch descends
        segments, stops descending on a ``kOptimalInaccurate`` segment
        (the reference breaks on any code other than optimal/unknown),
        and keeps descending through infeasible segments (``kUnknown``).

        Returns ``(statuses, trajectories, horizons, scp_rounds,
        admm_iters)``: statuses ``(B,)`` ExitCode ints (kOptimal iff some
        segment passed the exact-FK check); trajectories ``(B, 2·W_max·N)``
        in PADDED layout — positions ``[0, w·N)`` of the first half and
        velocities ``[0, w·N)`` of the second half are live, where ``w``
        is the per-query winning horizon in ``horizons`` — with velocities
        dt-unscaled (``gomp-solver.h:53``); ``scp_rounds``/``admm_iters``
        ``(B,)`` total SCP re-linearizations / ADMM iterations across all
        segments (the cost telemetry of the full search).

        ``obstacles``: optional PER-QUERY obstacles — a sequence matching
        the constructor's obstacle count whose pytree leaves carry a
        leading ``(B,)`` per-problem axis (``geometry.stack_obstacles``):
        a fleet where every query has its own keep-out poses, inside the
        same compiled program (traced values — moving an obstacle never
        recompiles).  ``None`` → the constructor's obstacles for the
        whole batch.

        ``warm_duals=True`` goes beyond the reference (which warm-starts
        primal-only across segments — ``SetPrimalWarmStart``,
        ``osqp-wrapper.h:45-47``): each segment's first solve starts from
        the previous segment's final duals.  The padded layout keeps row
        meanings fixed across horizons (rows beyond the new ``wa`` are
        free rows whose optimal dual is 0, so stale values there decay),
        so the dual container is directly reusable.  Accuracy-neutral —
        termination still checks true KKT residuals — but iterate paths
        (and thus trajectories, within tolerance) differ from the
        reference semantics, so it is opt-in.
        """
        max_scp = self.max_scp_iterations if max_scp is None else int(max_scp)
        starts = jnp.asarray(starts, self.dtype)
        obs, per_query = self._obstacles_arg(obstacles, starts.shape[0])
        key = ("batch_padded", max_scp, bool(warm_duals), per_query)
        if key not in self._compiled:
            self._compiled[key] = jax.jit(
                self._plan_batch_padded_program(
                    max_scp, bool(warm_duals), per_query
                )
            )
        return self._compiled[key](
            starts, jnp.asarray(ends, self.dtype), obs
        )

    def run_batch_padded_sharded(
        self, starts, ends, mesh, axis: Optional[str] = None,
        max_scp: Optional[int] = None, warm_duals: bool = False,
        obstacles=None,
    ):
        """:meth:`run_batch_padded` — the flagship FULL time-scaling search —
        scaled out over ``mesh[axis]`` (VERDICT r4 next #1).  The query
        batch shards across the mesh with ``shard_map``; each device runs
        the whole 10-segment descent for its shard inside its own masked
        while-loops.  No collectives are emitted inside the program (the
        queries are independent — the reference's one-solver-per-problem
        pattern, ``gomp-solver.h:61-64``), so throughput scales with the
        device count like the solver-layer
        :func:`parallel.batch.solve_batch_sharded`.

        The batch size must divide by the axis size.  Returns exactly what
        :meth:`run_batch_padded` returns; per-query results are
        bit-comparable to the single-device path (pinned by
        ``tests/test_planner_sharded.py``).
        """
        from jax.sharding import PartitionSpec
        from ..parallel.mesh import BATCH_AXIS

        axis = BATCH_AXIS if axis is None else axis
        max_scp = self.max_scp_iterations if max_scp is None else int(max_scp)
        starts = jnp.asarray(starts, self.dtype)
        obs, per_query = self._obstacles_arg(obstacles, starts.shape[0])
        key = (
            "batch_padded_sharded", max_scp, bool(warm_duals), mesh, axis,
            per_query,
        )
        if key not in self._compiled:
            spec = PartitionSpec(axis)
            obs_spec = spec if per_query else PartitionSpec()
            fn = jax.shard_map(
                self._plan_batch_padded_program(
                    max_scp, bool(warm_duals), per_query
                ),
                mesh=mesh,
                in_specs=(spec, spec, obs_spec),
                out_specs=(spec,) * 5,
                check_vma=False,
            )
            self._compiled[key] = jax.jit(fn)
        return self._compiled[key](
            starts, jnp.asarray(ends, self.dtype), obs
        )

    def _plan_batch_padded_program(
        self, max_scp: int, warm_duals: bool, per_query_obs: bool = False
    ):
        """Build the traceable full-search program behind
        :meth:`run_batch_padded` — shared by the single-device ``jit`` and
        the ``shard_map`` scale-out.  Takes ``(starts, ends, obstacles)``;
        with ``per_query_obs`` every obstacle pytree carries a leading
        ``(B,)`` per-problem axis (``geometry.stack_obstacles``) and each
        query runs the whole time-scaling descent against its OWN obstacle
        poses."""
        from ..ops.admm_lane import solve_batched_lane
        from .trajectory import calc_warm_start_masked
        from .trajectory_qp import with_gomp_boxes_masked, with_horizon_mask
        from .trajectory_qp_lane import from_trailing

        W, N = self.max_waypoints, self.n_dim
        balls = self.balls
        n_obs = len(self.obstacles)
        con3d = (
            jnp.asarray(self.con_3d.lower, self.dtype),
            jnp.asarray(self.con_3d.upper, self.dtype),
        )
        settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)
        boxes = tuple(
            (jnp.asarray(c.lower, self.dtype), jnp.asarray(c.upper, self.dtype))
            for c in (self.pos_con, self.vel_con, self.acc_con)
        )
        is_ok1 = self._is_solution_ok_masked_fn(W, per_query_obs=True)
        obs_ax = 0 if per_query_obs else None
        segments = self.segments
        WN = W * N

        def build_one(start, end, warm, wa, obstacles):
            qp = empty_trajectory_qp(
                W, N, [b.is_gripper for b in balls], n_obs, self.dtype
            )
            qp = with_horizon_mask(qp, wa)
            qp = with_gomp_boxes_masked(qp, start, end, *boxes, wa)
            return linearize_workspace(
                qp, balls, obstacles, con3d, warm, w_active=wa,
                movable=pinned_movable_mask(W, wa),
            )

        def slice_warm_one(sol, w_prev, wa):
            """Reference warm-slicing quirk (``gomp-solver.h:43-44``) with
            traced ``w_prev``/``wa`` in padded layout: the first two
            ``wa·N`` windows of the previous COMPACT solution."""
            q, v = sol[:WN], sol[WN:]
            pn = w_prev * N
            wn = wa * N
            j = jnp.arange(WN)

            def compact_at(idx):
                from_q = idx < pn
                qi = jnp.clip(idx, 0, WN - 1)
                vi = jnp.clip(idx - pn, 0, WN - 1)
                return jnp.where(from_q, q[qi], v[vi])

            out_q = jnp.where(j < wn, compact_at(j), 0.0)
            out_v = jnp.where(j < wn, compact_at(wn + j), 0.0)
            return jnp.concatenate([out_q, out_v])

        def plan_batch(starts, ends, obstacles):
            B = starts.shape[0]
            warm0 = jax.vmap(
                lambda s, e: calc_warm_start_masked(s, e, W, W)
            )(starts, ends)  # (B, 2WN)
            last_sol = warm0
            last_w = jnp.full((B,), W, jnp.int32)
            last_code = jnp.full((B,), ExitCode.kUnknown, jnp.int32)
            alive = jnp.ones((B,), bool)
            total_scp = jnp.zeros((B,), jnp.int32)

            lin_b = jax.vmap(
                lambda qp, xi, wa, obs: linearize_workspace(
                    qp, balls, obs, con3d, xi, w_active=wa,
                    movable=pinned_movable_mask(W, wa),
                ),
                in_axes=(-1, -1, None, obs_ax),
                out_axes=-1,
            )
            ok_b = jax.vmap(is_ok1, in_axes=(-1, None, obs_ax))

            def scp_segment(warm, run_mask, wa, y0):
                """One masked SCP loop at traced horizon ``wa`` — the
                batched ``run_horizon_padded``.  Returns (x (2WN, B),
                y (m, B), ok, solver_status, rounds, admm_iters)."""
                qp_t = jax.vmap(
                    build_one, in_axes=(0, 0, 0, None, obs_ax), out_axes=-1
                )(starts, ends, warm, wa, obstacles)
                x0 = warm.T  # (2WN, B)
                status0 = jnp.full((B,), ExitCode.kUnknown, jnp.int32)
                ok0 = jnp.zeros((B,), bool)
                done0 = ~run_mask
                k0 = jnp.zeros((B,), jnp.int32)

                def cond(carry):
                    done, k = carry[5], carry[6]
                    return jnp.any(~done) & (jnp.max(k) < max_scp)

                def body(carry):
                    qp_t, x, y, status, ok, done, k, it = carry
                    lane = from_trailing(qp_t, row_layout="waypoint")
                    res = solve_batched_lane(
                        lane, settings, warm_x=x.T, warm_y=y.T
                    )
                    xs = jnp.where(done, x, res.x.T)
                    y = jnp.where(done, y, res.y.T)
                    status = jnp.where(done, status, res.status).astype(
                        jnp.int32
                    )
                    it = it + jnp.where(done, 0, res.iterations).astype(
                        jnp.int32
                    )
                    ok = jnp.where(done, ok, ok_b(xs, wa, obstacles))
                    solvable = (status == ExitCode.kOptimal) | (
                        status == ExitCode.kOptimalInaccurate
                    )
                    k = k + jnp.where(done, 0, 1).astype(jnp.int32)
                    done = done | ok | ~solvable
                    qp_t = lin_b(qp_t, xs, wa, obstacles)
                    return qp_t, xs, y, status, ok, done, k, it

                _, x, y, status, ok, _, k, it = jax.lax.while_loop(
                    cond, body,
                    (qp_t, x0, y0, status0, ok0, done0, k0, k0),
                )
                return x, y, ok, status, k, it

            def seg_body(i, carry):
                (last_sol, last_w, last_code, alive, total_scp, total_it,
                 last_y) = carry
                seg = segments - i
                wa = jnp.asarray(W * seg // segments, jnp.int32)
                run_mask = alive & (wa >= 4)
                warm = jax.vmap(slice_warm_one, in_axes=(0, 0, None))(
                    last_sol, last_w, wa
                )
                y0 = last_y if warm_duals else jnp.zeros_like(last_y)
                x, y, ok, status, k, it = scp_segment(warm, run_mask, wa, y0)
                total_scp = total_scp + jnp.where(run_mask, k, 0)
                total_it = total_it + jnp.where(run_mask, it, 0)
                # Segment outcome (run_horizon semantics): kOptimal /
                # kOptimalInaccurate only when the exact-FK check passed;
                # anything else degrades to kUnknown.
                accepted = run_mask & ok
                improved = accepted & (status == ExitCode.kOptimal)
                inaccurate = accepted & (
                    status == ExitCode.kOptimalInaccurate
                )
                # Outer-loop break (gomp-solver.h:46-47): only a code other
                # than kOptimal/kUnknown stops the descent.
                alive = alive & ~inaccurate
                last_code = jnp.where(
                    improved, jnp.int32(ExitCode.kOptimal), last_code
                )
                last_sol = jnp.where(improved[:, None], x.T, last_sol)
                last_w = jnp.where(improved, wa, last_w)
                return (last_sol, last_w, last_code, alive, total_scp,
                        total_it, y)

            # Dual container shape, shape-only (no compute): the lane's
            # padded row count at any horizon (static across segments).
            m = jax.eval_shape(
                lambda s, e, w, obs: from_trailing(
                    jax.vmap(build_one, in_axes=(0, 0, 0, None, obs_ax),
                             out_axes=-1)(s, e, w, jnp.int32(W), obs),
                    row_layout="waypoint",
                ).l,
                starts, ends, warm0, obstacles,
            ).shape[0]
            y_init = jnp.zeros((m, B), starts.dtype)

            (last_sol, last_w, last_code, alive, total_scp, total_it, _) = (
                jax.lax.fori_loop(
                    0, segments, seg_body,
                    (last_sol, last_w, last_code, alive, total_scp,
                     jnp.zeros((B,), jnp.int32), y_init),
                )
            )
            # Unscale the live velocity window (gomp-solver.h:53); the
            # padded tail is zeros either way.
            q, v = last_sol[:, :WN], last_sol[:, WN:]
            out = jnp.concatenate([q, v / self.time_step], axis=1)
            return last_code, out, last_w, total_scp, total_it

        return plan_batch

    def _is_solution_ok_masked_fn(self, W, per_query_obs: bool = False):
        """Masked-horizon exact-FK feasibility (``gomp-solver.h:141-199``)
        with the SoA ball evaluator where available: ``is_ok(x, wa)`` — or
        ``is_ok(x, wa, obstacles)`` when ``per_query_obs`` (the batched
        per-query-obstacle planner paths)."""
        N = self.n_dim
        con3d = (
            jnp.asarray(self.con_3d.lower, self.dtype),
            jnp.asarray(self.con_3d.upper, self.dtype),
        )

        def is_ok_core(x, wa, obstacles):
            act = jnp.arange(W) < wa
            q = x[: W * N].reshape(W, N)
            ok = jnp.array(True)
            for ball in self.balls:
                if getattr(ball, "fk_jac_batched", None) is not None:
                    pts = jnp.asarray(ball.fk_jac_batched(q)[0], self.dtype)
                else:
                    pts = jax.vmap(
                        lambda s: jnp.asarray(ball.fk(s), self.dtype)
                    )(q)
                r = ball.radius
                if ball.is_gripper:
                    ok &= jnp.all(jnp.where(
                        act[:, None], con3d[0][None, :] - ERROR <= pts - r,
                        True,
                    ))
                    ok &= jnp.all(jnp.where(
                        act[:, None], pts + r <= con3d[1][None, :] + ERROR,
                        True,
                    ))
                for line in obstacles:
                    ok &= jnp.all(
                        jnp.where(act, ~line.violates(pts, r), True)
                    )
            return ok

        if per_query_obs:
            return is_ok_core
        return lambda x, wa: is_ok_core(x, wa, self.obstacles)

    def _build_session(self, start, end, warm, W, settings=None, obstacles=None):
        """Traceable session construction for one problem at horizon W.

        ``obstacles``: per-problem obstacle pytrees already sliced to this
        problem (the batched paths' vmap); ``None`` → the constructor's."""
        if obstacles is None:
            obstacles = self.obstacles
        if settings is None:
            settings = admm_mod.with_auto_refine(self.settings, W, self.dtype)
        N = self.n_dim
        qp = empty_trajectory_qp(
            W, N, [b.is_gripper for b in self.balls], len(self.obstacles), self.dtype
        )
        qp = with_gomp_boxes(
            qp,
            start,
            end,
            (jnp.asarray(self.pos_con.lower, self.dtype), jnp.asarray(self.pos_con.upper, self.dtype)),
            (jnp.asarray(self.vel_con.lower, self.dtype), jnp.asarray(self.vel_con.upper, self.dtype)),
            (jnp.asarray(self.acc_con.lower, self.dtype), jnp.asarray(self.acc_con.upper, self.dtype)),
        )
        con3d = (
            jnp.asarray(self.con_3d.lower, self.dtype),
            jnp.asarray(self.con_3d.upper, self.dtype),
        )
        qp = linearize_workspace(
            qp, self.balls, obstacles, con3d, warm,
            movable=pinned_movable_mask(W),
        )
        return ops_session.setup(qp, settings, warm_x=warm)

    def _is_solution_ok_fn(self, W, per_query_obs: bool = False):
        N = self.n_dim
        con3d = (
            jnp.asarray(self.con_3d.lower, self.dtype),
            jnp.asarray(self.con_3d.upper, self.dtype),
        )

        def is_ok_core(x, obstacles):
            q = x[: W * N].reshape(W, N)
            ok = jnp.array(True)
            for ball in self.balls:
                if getattr(ball, "fk_jac_batched", None) is not None:
                    # SoA evaluator (models/robot.py) — avoids the 4×4 DH
                    # intermediates under vmap.
                    pts = jnp.asarray(ball.fk_jac_batched(q)[0], self.dtype)
                else:
                    pts = jax.vmap(
                        lambda s: jnp.asarray(ball.fk(s), self.dtype)
                    )(q)
                r = ball.radius
                if ball.is_gripper:
                    ok &= jnp.all(con3d[0][None, :] - ERROR <= pts - r)
                    ok &= jnp.all(pts + r <= con3d[1][None, :] + ERROR)
                for line in obstacles:
                    ok &= jnp.all(~line.violates(pts, r))
            return ok

        if per_query_obs:
            return is_ok_core
        return lambda x: is_ok_core(x, self.obstacles)
