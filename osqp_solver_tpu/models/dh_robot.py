"""Generic DH-parameterized robot arms, jnp-native.

The reference is hard-wired to one arm: it pulls FK/Jacobians for the UR5e
from the external ``Kinematics-UR5e-arm`` library and passes them into
``RobotBall`` (``/root/reference/src/utils.h:33-42``; use sites
``examples/solver-example.cpp:31,37-41``).  The GOMP stack here is already
robot-agnostic — ``RobotBall`` takes callables and the constraint builder /
planner are generic in the joint count N — so this module supplies the
missing piece for arms OTHER than the UR5e: a classic-DH table-driven robot
model with

* matrix-path FK for any frame (reference check / host use),
* the structure-of-arrays batched FK + geometric Jacobian hot path
  (same layout discipline as ``models/ur5e.py::fk_jacobian_points`` —
  every rotation entry is its own batch-shaped array, so nothing pads to
  (8, 128) tiles; the planner's SCP linearization consumes it via
  ``RobotBall.fk_jac_batched``),
* a jit-friendly damped-least-squares position IK for arms with no
  closed form (the UR5e keeps its analytic 8-branch IK in ``ur5e.py``),
* presets: ``UR5E`` (pinned equal to ``models/ur5e.py``), ``UR10E``,
  the 7-DOF ``IIWA14`` — the 7-DOF preset doubles as the test that the
  whole GOMP/ADMM stack is generic in N (``tests/test_dh_robot.py``) —
  and the 4-DOF ``SCARA`` (RRPR), which pins prismatic-joint support
  (``joint_types``: the joint variable extends ``d`` instead of θ; the
  Jacobian column is the joint axis with no angular contribution).

Classic DH convention throughout: ``T_i = Rz(θ_i)·Tz(d_i)·Tx(a_i)·Rx(α_i)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _snap(x: float) -> float:
    """Snap cos/sin of axis-aligned α to exact 0/±1 so the SoA composer can
    drop the corresponding terms at trace time (same trick as the UR5e
    ``_CA_SA`` table)."""
    for v in (0.0, 1.0, -1.0):
        if abs(x - v) < 1e-12:
            return v
    return float(x)


@dataclass(frozen=True)
class DHRobot:
    """A serial arm given by its classic DH table.

    ``a``/``d``/``alpha``: per-joint link length, offset, and twist (meters /
    radians), all the same length N.  ``joint_types``: per-joint ``"r"``
    (revolute — the joint variable is θᵢ, ``d[i]`` fixed) or ``"p"``
    (prismatic — the joint variable ADDS to ``d[i]``, θ fixed at
    ``theta[i]``), default all-revolute; SCARA-class arms mix the two
    (``SCARA`` preset).  All methods are traceable jnp and vmappable over
    waypoints and problem batches.
    """

    a: Tuple[float, ...]
    d: Tuple[float, ...]
    alpha: Tuple[float, ...]
    name: str = "dh-robot"
    joint_types: Tuple[str, ...] | None = None
    theta: Tuple[float, ...] | None = None  # fixed θ of prismatic joints

    def __post_init__(self):
        assert len(self.a) == len(self.d) == len(self.alpha), (
            self.a, self.d, self.alpha)
        if self.joint_types is None:
            object.__setattr__(self, "joint_types", ("r",) * len(self.a))
        if self.theta is None:
            object.__setattr__(self, "theta", (0.0,) * len(self.a))
        assert len(self.joint_types) == len(self.a) and all(
            t in ("r", "p") for t in self.joint_types
        ), self.joint_types
        assert len(self.theta) == len(self.a)

    @property
    def n_joints(self) -> int:
        return len(self.a)

    # -- matrix path (reference check / host use) ---------------------------

    def link_transform(self, i: int, qi):
        """Link transform at joint variable ``qi`` — θᵢ for a revolute
        joint, the prismatic extension added to ``d[i]`` otherwise."""
        if self.joint_types[i] == "r":
            theta, d = qi, self.d[i]
        else:
            theta = jnp.asarray(self.theta[i], jnp.asarray(qi).dtype)
            d = self.d[i] + qi
        ct, st = jnp.cos(theta), jnp.sin(theta)
        ca, sa = _snap(math.cos(self.alpha[i])), _snap(math.sin(self.alpha[i]))
        a = self.a[i]
        return jnp.array(
            [
                [ct, -st * ca, st * sa, a * ct],
                [st, ct * ca, -ct * sa, a * st],
                [jnp.zeros_like(ct), sa * jnp.ones_like(ct),
                 ca * jnp.ones_like(ct), d * jnp.ones_like(ct)],
                [jnp.zeros_like(ct), jnp.zeros_like(ct),
                 jnp.zeros_like(ct), jnp.ones_like(ct)],
            ]
        )

    def frames(self, q):
        """Cumulative transforms ``T_0i`` for i = 0..N; shape (N+1, 4, 4).

        Full-precision matmuls: a reduced-precision f32 default smears a
        6-link 4×4 chain by ~1e-3 tool error — enough to fail f32 IK
        tolerances and FK audits.  The chains are tiny; exactness is free."""
        with jax.default_matmul_precision("highest"):
            T = jnp.eye(4, dtype=q.dtype)
            out = [T]
            for i in range(self.n_joints):
                T = T @ self.link_transform(i, q[i])
                out.append(T)
            return jnp.stack(out)

    def point_fk(self, q, link: int | None = None):
        """Origin of frame ``link`` (default: the tool frame N); (3,).
        Full-precision chain — see :meth:`frames`."""
        link = self.n_joints if link is None else int(link)
        with jax.default_matmul_precision("highest"):
            T = jnp.eye(4, dtype=q.dtype)
            for i in range(link):
                T = T @ self.link_transform(i, q[i])
            return T[:3, 3]

    def fk(self, link: int | None = None):
        """``q (N,) -> point (3,)`` callable for :class:`RobotBall.fk`."""
        return partial(self.point_fk, link=link)

    def jacobian(self, link: int | None = None):
        """Exact 3×N position Jacobian (jacfwd of the closed-form FK)."""
        return jax.jacfwd(self.fk(link))

    # -- structure-of-arrays batched hot path -------------------------------

    def _soa_compose(self, R, p, qi, i):
        """(R, p) ∘ DH-link i at joint variable ``qi`` — all entries
        (...,)-arrays.  Revolute: θ = ``qi``; prismatic: θ fixed (cos/sin
        snap to exact constants so the composer drops terms at trace time)
        and ``qi`` extends ``d[i]``."""
        if self.joint_types[i] == "r":
            ct, st = jnp.cos(qi), jnp.sin(qi)
            d = self.d[i]
        else:
            ct, st = _snap(math.cos(self.theta[i])), _snap(math.sin(self.theta[i]))
            d = self.d[i] + qi
        ca, sa = _snap(math.cos(self.alpha[i])), _snap(math.sin(self.alpha[i]))
        a = self.a[i]
        cols = (
            (ct, st, 0.0),
            (-st * ca, ct * ca, sa),
            (st * sa, -ct * sa, ca),
        )

        def dot_row(r, col):
            acc = None
            for k in range(3):
                ck = col[k]
                if isinstance(ck, float) and ck == 0.0:
                    continue
                term = R[r][k] * ck
                acc = term if acc is None else acc + term
            return acc

        is_num = lambda v: isinstance(v, (int, float))
        Rn = [[dot_row(r, cols[j]) for j in range(3)] for r in range(3)]
        pn = tuple(
            p[r]
            + (R[r][0] * (a * ct) if not (is_num(a) and a == 0.0 or is_num(ct) and ct == 0.0) else 0.0)
            + (R[r][1] * (a * st) if not (is_num(a) and a == 0.0 or is_num(st) and st == 0.0) else 0.0)
            + (R[r][2] * d if not (is_num(d) and d == 0.0) else 0.0)
            for r in range(3)
        )
        return Rn, pn

    def fk_jacobian_points(self, q, link: int | None = None):
        """Batched FK point + 3×N geometric Jacobian, SoA form.

        ``q``: (..., N) with arbitrary leading batch dims; returns
        ``(points (..., 3), jac (..., 3, N))`` using purely elementwise ops
        on the leading dims (the accelerator-friendly layout — see
        ``docs/KERNELS.md`` round-3 addenda).  Geometric column
        ``J[:, i] = z_i × (p_link − p_i)``, identical to jacfwd of the
        matrix path (pinned by ``tests/test_dh_robot.py``).
        """
        points, jac, _, _ = self._fk_soa(q, link)
        return points, jac

    def _fk_soa(self, q, link: int | None = None):
        """Shared SoA FK walk: ``(points, Jp, R, Jw)`` for frame ``link``.

        ``R`` is the frame's rotation (..., 3, 3); ``Jw`` the angular
        geometric Jacobian whose column i is the joint axis ``z_i`` in the
        base frame (``ω = Jw·q̇``); columns i ≥ link are zero."""
        q = jnp.asarray(q)
        n = self.n_joints
        link = n if link is None else int(link)
        batch = q.shape[:-1]
        zero = jnp.zeros(batch, q.dtype)
        one = jnp.ones(batch, q.dtype)
        R = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
        p = (zero, zero, zero)
        axes, origins = [], []
        for i in range(link):
            axes.append((R[0][2], R[1][2], R[2][2]))
            origins.append(p)
            R, p = self._soa_compose(R, p, q[..., i], i)

        cols = []
        for i in range(n):
            if i < link:
                zx, zy, zz = axes[i]
                if self.joint_types[i] == "p":
                    # prismatic: linear motion straight along the joint
                    # axis — J_p column is z_i itself
                    cols.append((zx, zy, zz))
                    continue
                rx, ry, rz = (p[0] - origins[i][0], p[1] - origins[i][1],
                              p[2] - origins[i][2])
                cols.append((zy * rz - zz * ry, zz * rx - zx * rz,
                             zx * ry - zy * rx))
            else:
                cols.append((zero, zero, zero))
        points = jnp.stack(p, axis=-1)
        jac = jnp.stack(
            [jnp.stack([cols[i][ax] for i in range(n)], axis=-1)
             for ax in range(3)],
            axis=-2,
        )
        rot = jnp.stack(
            [jnp.stack(R[r], axis=-1) for r in range(3)], axis=-2
        )
        jac_w = jnp.stack(
            [
                jnp.stack(
                    [
                        axes[i][ax]
                        if i < link and self.joint_types[i] == "r"
                        else zero  # prismatic joints add no angular velocity
                        for i in range(n)
                    ],
                    axis=-1,
                )
                for ax in range(3)
            ],
            axis=-2,
        )
        return points, jac, rot, jac_w

    def fk_pose_jacobian(self, q, link: int | None = None):
        """Batched full-pose FK: ``(point (...,3), R (...,3,3),
        Jp (...,3,N), Jw (...,3,N))`` — the 6-D task-space surface behind
        :meth:`pose_ik` (capability anchor: the reference imports pose IK
        from the external UR5e library, ``examples/solver-example.cpp:53``).
        """
        points, jac, rot, jac_w = self._fk_soa(q, link)
        return points, rot, jac, jac_w

    def pose_fk(self, q, link: int | None = None):
        """``(point (3,), R (3,3))`` of frame ``link`` (matrix path;
        full-precision chain — see :meth:`frames`)."""
        link = self.n_joints if link is None else int(link)
        with jax.default_matmul_precision("highest"):
            T = jnp.eye(4, dtype=jnp.asarray(q).dtype)
            for i in range(link):
                T = T @ self.link_transform(i, q[i])
            return T[:3, 3], T[:3, :3]

    def make_ball(self, link: int | None = None, radius: float = 0.05,
                  is_gripper: bool = False):
        """:class:`~osqp_solver_tpu.models.robot.RobotBall` at frame
        ``link`` with both the scalar callables and the SoA batched
        evaluator (same surface as ``ur5e.make_ball``)."""
        from .robot import RobotBall

        return RobotBall(
            fk=self.fk(link),
            jacobian=self.jacobian(link),
            radius=radius,
            is_gripper=is_gripper,
            fk_jac_batched=partial(self.fk_jacobian_points, link=link),
        )

    # -- numeric IK (generic arms have no closed form) -----------------------

    @staticmethod
    def _default_tol(dtype) -> float:
        """Dtype-aware convergence tolerance: 1e-6 is below f32 FK noise
        (ADVICE r3), so f32 callers get 1e-4 unless they pass their own."""
        return 1e-6 if jnp.dtype(dtype) == jnp.float64 else 1e-4

    def position_ik(self, p, q0=None, link: int | None = None,
                    iters: int = 64, damping: float = 1e-3,
                    tol: float | None = None):
        """Damped-least-squares position IK: find q with ``fk(q) ≈ p``.

        Jit/vmap-friendly (``lax.fori_loop``, static shapes).  Returns
        ``(q, converged)`` where ``converged`` is ``‖fk(q) − p‖ ≤ tol``
        (``tol`` defaults per dtype: 1e-6 f64, 1e-4 f32).  For redundant
        arms (N > 3) DLS picks the minimum-norm step — the standard
        resolution of the null space.  The reference has no IK surface
        beyond the (never-called) UR5e ``gripper_ik``
        (``gomp-solver.h:34,103``); this generalizes the capability the
        external library provided for one arm to any DH arm.
        """
        p = jnp.asarray(p)
        p = p.astype(jnp.result_type(float, p.dtype))  # int targets just work
        if tol is None:
            tol = self._default_tol(p.dtype)
        n = self.n_joints
        q0 = jnp.zeros(n, p.dtype) if q0 is None else jnp.asarray(q0, p.dtype)
        lam2 = jnp.asarray(damping ** 2, p.dtype)
        eye3 = jnp.eye(3, dtype=p.dtype)

        def body(_, q):
            pt, J = self.fk_jacobian_points(q, link=link)
            e = p - pt
            # dq = Jᵀ (J Jᵀ + λ² I)⁻¹ e  (3×3 solve — cheap at any N).
            # HIGHEST matmul precision: a reduced-precision f32 default
            # (bf16 passes, TF32) stalls DLS short of the f32
            # tolerance; these products are tiny, so exactness is free.
            hi = jax.lax.Precision.HIGHEST
            JJt = jnp.matmul(J, J.T, precision=hi) + lam2 * eye3
            dq = jnp.matmul(
                J.T, jnp.linalg.solve(JJt, e), precision=hi
            )
            return q + dq

        # default_matmul_precision: jnp.linalg.solve's blocked LU also runs
        # matmuls at the backend default (reduced precision on
        # accelerators), which stalls
        # DLS ~1e-3 short of the f32 tolerance — force full precision for
        # the whole (tiny) loop.
        with jax.default_matmul_precision("highest"):
            q = jax.lax.fori_loop(0, iters, body, q0)
            err = jnp.linalg.norm(self.fk(link)(q) - p)
        return q, err <= tol

    def pose_ik(self, p, rot, q0=None, link: int | None = None,
                iters: int = 96, damping: float = 1e-3,
                tol: float | None = None, tol_rot: float | None = None):
        """Damped-least-squares full-pose IK: ``fk(q) ≈ p`` AND the frame's
        rotation ≈ ``rot`` (3×3).

        6-D task error ``[p − p(q); e_o]`` with the standard column-cross
        orientation error ``e_o = ½ Σᵢ R(q)[:,i] × rot[:,i]`` (smooth,
        vanishes exactly at alignment); step ``dq = Jᵀ(JJᵀ + λ²I₆)⁻¹ e``
        on the stacked geometric Jacobian ``J = [Jp; Jw]``.  Returns
        ``(q, converged)``; convergence is position error ≤ ``tol`` and
        relative-rotation angle ≤ ``tol_rot`` (radians; defaults per dtype).
        Note the column-cross error also vanishes at the antipode (θ = π
        about any axis) — seed ``q0`` within a half-turn of the target, as
        with any local IK.  Capability anchor: the reference's pose IK
        import, ``examples/solver-example.cpp:53``.
        """
        p = jnp.asarray(p)
        p = p.astype(jnp.result_type(float, p.dtype))
        rot = jnp.asarray(rot, p.dtype)
        if tol is None:
            tol = self._default_tol(p.dtype)
        if tol_rot is None:
            tol_rot = 1e-6 if p.dtype == jnp.float64 else 1e-3
        n = self.n_joints
        q0 = jnp.zeros(n, p.dtype) if q0 is None else jnp.asarray(q0, p.dtype)
        lam2 = jnp.asarray(damping ** 2, p.dtype)
        eye6 = jnp.eye(6, dtype=p.dtype)

        def orient_err(R):
            # ½ Σ columns R[:,i] × rot[:,i]
            return 0.5 * sum(
                jnp.cross(R[:, i], rot[:, i]) for i in range(3)
            )

        def body(_, q):
            pt, R, Jp, Jw = self.fk_pose_jacobian(q, link=link)
            e = jnp.concatenate([p - pt, orient_err(R)])
            J = jnp.concatenate([Jp, Jw], axis=0)  # (6, N)
            # HIGHEST precision: see position_ik (a reduced-precision default
            # stalls DLS short of the f32 tolerance).
            hi = jax.lax.Precision.HIGHEST
            JJt = jnp.matmul(J, J.T, precision=hi) + lam2 * eye6
            dq = jnp.matmul(
                J.T, jnp.linalg.solve(JJt, e), precision=hi
            )
            return q + dq

        # Full-precision matmuls for the loop AND the convergence check: at
        # a reduced-precision f32 default the check's rotᵀR trace
        # alone picks up ~1e-2 error — arccos turns that into DEGREES of
        # phantom angle error, failing solves whose rotation is exact
        # (found driving the grasp demo on hardware, round 5).
        with jax.default_matmul_precision("highest"):
            q = jax.lax.fori_loop(0, iters, body, q0)
            pt, R = self.pose_fk(q, link=link)
            pos_err = jnp.linalg.norm(pt - p)
            # relative-rotation angle from the trace of rotᵀR
            c = jnp.clip((jnp.trace(rot.T @ R) - 1.0) / 2.0, -1.0, 1.0)
            ang_err = jnp.arccos(c)
        return q, (pos_err <= tol) & (ang_err <= tol_rot)


def ik_checked(robot: DHRobot, p, *, rot=None, q0=None,
               link: int | None = None, **kw):
    """Host-side IK entry raising
    :class:`~osqp_solver_tpu.utils.types.NoInverseKinematicSolution` when
    DLS does not reach ``p`` (and, when ``rot`` is given, the target
    orientation) — same contract as ``ur5e.inverse_kinematics_checked``
    for generic arms."""
    from ..utils.types import NoInverseKinematicSolution

    if rot is None:
        q, ok = robot.position_ik(p, q0=q0, link=link, **kw)
    else:
        q, ok = robot.pose_ik(p, rot, q0=q0, link=link, **kw)
    if not bool(ok):
        raise NoInverseKinematicSolution(tuple(float(v) for v in jnp.asarray(p)))
    return q


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

_PI2 = math.pi / 2

from . import ur5e as _ur5e  # noqa: E402  (presets only)

#: Universal Robots UR5e — built FROM the analytic module's DH constants so
#: there is exactly one source of truth (ADVICE r3; still pinned by
#: ``tests/test_dh_robot.py::test_ur5e_preset_matches_analytic_module``).
UR5E = DHRobot(
    a=(0.0, _ur5e.A2, _ur5e.A3, 0.0, 0.0, 0.0),
    d=(_ur5e.D1, 0.0, 0.0, _ur5e.D4, _ur5e.D5, _ur5e.D6),
    alpha=tuple(float(x) for x in _ur5e.ALPHA),
    name="ur5e",
)

#: Universal Robots UR10e (published classic DH values).
UR10E = DHRobot(
    a=(0.0, -0.6127, -0.57155, 0.0, 0.0, 0.0),
    d=(0.1807, 0.0, 0.0, 0.17415, 0.11985, 0.11655),
    alpha=(_PI2, 0.0, 0.0, _PI2, -_PI2, 0.0),
    name="ur10e",
)

#: KUKA LBR iiwa 14 R820, classic-DH form — a 7-DOF redundant arm; used in
#: tests to pin that the whole GOMP/ADMM stack is generic in the joint count.
IIWA14 = DHRobot(
    a=(0.0,) * 7,
    d=(0.36, 0.0, 0.42, 0.0, 0.4, 0.0, 0.126),
    alpha=(-_PI2, _PI2, _PI2, -_PI2, -_PI2, _PI2, 0.0),
    name="iiwa14",
)

#: A 4-DOF SCARA (RRPR — two shoulder revolutes, a prismatic Z stroke, a
#: tool-rotation wrist; Epson LS6-class link lengths).  The pick-and-place
#: workhorse class, and the preset that pins prismatic-joint support: the
#: α₂ = π flip points the z₃/z₄ axes down, so +q₃ plunges the tool
#: (z = 0.2 − q₃) while keeping the classic-DH form.  q₃ ∈ [0, 0.2] m.
SCARA = DHRobot(
    a=(0.325, 0.275, 0.0, 0.0),
    d=(0.2, 0.0, 0.0, 0.0),
    alpha=(0.0, math.pi, 0.0, 0.0),
    joint_types=("r", "r", "p", "r"),
    name="scara",
)
