"""UR5e analytical kinematics, jnp-native.

JAX-native re-implementation of the capability the reference pulls in from
the external ``Kinematics-UR5e-arm`` library (``analytical_ik.h``; use sites
``/root/reference/examples/solver-example.cpp:31,37-41,53,98`` and SURVEY.md
§2.2): closed-form DH forward kinematics for the tool, the wrist ("6 back")
and the elbow frames, 3×6 position Jacobians, and the standard 8-branch
closed-form inverse kinematics.  Everything is traceable jnp — FK/Jacobians
``vmap`` over waypoints and problem batches inside the jitted SCP
linearization (``gomp/trajectory_qp.py::linearize_workspace``).

Classic DH parameters (Universal Robots published values for the UR5e)::

    i | a[m]     d[m]    alpha
    1 | 0        0.1625   π/2
    2 | -0.425   0        0
    3 | -0.3922  0        0
    4 | 0        0.1333   π/2
    5 | 0        0.0997  -π/2
    6 | 0        0.0996   0

Jacobians use ``jax.jacfwd`` on the closed-form FK — exact derivatives of the
same expressions, replacing the external library's hand-written
``joint_jacobian*`` functions.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# DH constants (float; cast to the tracer dtype at use).
D1, D4, D5, D6 = 0.1625, 0.1333, 0.0997, 0.0996
A2, A3 = -0.425, -0.3922
ALPHA = (np.pi / 2, 0.0, 0.0, np.pi / 2, -np.pi / 2, 0.0)
A_ = (0.0, A2, A3, 0.0, 0.0, 0.0)
D_ = (D1, 0.0, 0.0, D4, D5, D6)

NUM_JOINTS = 6


def _dh(theta, d, a, alpha):
    """Classic DH link transform ``Rz(θ)·Tz(d)·Tx(a)·Rx(α)`` as a 4×4."""
    ct, st = jnp.cos(theta), jnp.sin(theta)
    ca, sa = jnp.cos(alpha), jnp.sin(alpha)
    return jnp.array(
        [
            [ct, -st * ca, st * sa, a * ct],
            [st, ct * ca, -ct * sa, a * st],
            [0.0, sa, ca, d],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def link_transform(i: int, theta):
    return _dh(theta, D_[i], A_[i], ALPHA[i])


def frames(q):
    """Cumulative transforms ``T_0i`` for i = 0..6; shape (7, 4, 4).

    Full-precision matmuls: a reduced-precision f32 default (bf16 passes,
    TF32) lets the 6-link 4x4 chain accumulate ~1e-3 tool error — enough to fail
    f32 IK tolerances and FK audits.  These chains are tiny; exactness is
    free."""
    with jax.default_matmul_precision("highest"):
        T = jnp.eye(4, dtype=q.dtype)
        out = [T]
        for i in range(NUM_JOINTS):
            T = T @ link_transform(i, q[i])
            out.append(T)
        return jnp.stack(out)


def tool_pose(q):
    """Full 4×4 tool (frame 6) pose (full-precision chain — see frames)."""
    with jax.default_matmul_precision("highest"):
        T = jnp.eye(4, dtype=q.dtype)
        for i in range(NUM_JOINTS):
            T = T @ link_transform(i, q[i])
        return T


def forward_kinematics(q):
    """Tool-point position — mirror of the external ``forward_kinematics``
    (RobotBall use at ``solver-example.cpp:40``)."""
    return tool_pose(q)[:3, 3]


def forward_kinematics_6_back(q):
    """Wrist point one link "back" from the tool (origin of frame 5) —
    mirror of ``forward_kinematics_6_back`` (``solver-example.cpp:39``)."""
    with jax.default_matmul_precision("highest"):
        T = jnp.eye(4, dtype=q.dtype)
        for i in range(5):
            T = T @ link_transform(i, q[i])
        return T[:3, 3]


def forward_kinematics_elbow_joint(q):
    """Elbow position (origin of frame 2, end of the upper arm) — mirror of
    ``forward_kinematics_elbow_joint`` (``solver-example.cpp:31``)."""
    with jax.default_matmul_precision("highest"):
        T = jnp.eye(4, dtype=q.dtype)
        for i in range(2):
            T = T @ link_transform(i, q[i])
        return T[:3, 3]


# Position Jacobians (3×6) — exact jacfwd of the closed-form FK; mirrors of
# joint_jacobian / joint_jacobian_6_back / jacobian_elbow_joint.
joint_jacobian = jax.jacfwd(forward_kinematics)
joint_jacobian_6_back = jax.jacfwd(forward_kinematics_6_back)
jacobian_elbow_joint = jax.jacfwd(forward_kinematics_elbow_joint)


# ---------------------------------------------------------------------------
# Structure-of-arrays batched FK + geometric Jacobian (the planner hot path)
# ---------------------------------------------------------------------------
#
# The 4×4-matrix FK above is correct under vmap but slow when batched:
# every intermediate becomes a (..., 4, 4) array with tiny trailing dims
# (the planner's SCP linearization; benchmarks/profile_planner_round.py).  Here each rotation
# entry / origin coordinate is its OWN array over the batch dims, so every
# op is elementwise on (...,)-arrays and the batch tiles the lanes.
#
# The Jacobian is the geometric one — J[:, i] = z_i × (p_E − p_i) for a
# revolute joint about axis z_i through p_i — which is exactly
# jacfwd(forward_kinematics) for this chain (pinned by
# tests/test_ur5e.py::test_soa_matches_matrix_path).

# Exact (cos α, sin α) per joint — α ∈ {π/2, 0, −π/2}; the matrix path's
# jnp.cos(π/2) ≈ 6e-17 is numerically identical at f32.
_CA_SA = ((0.0, 1.0), (1.0, 0.0), (1.0, 0.0), (0.0, 1.0), (0.0, -1.0), (1.0, 0.0))

_FRAME_LINKS = {"tool": 6, "back6": 5, "elbow": 2}


def _soa_compose(R, p, th, i):
    """(R, p) ∘ DH-link i at angle ``th`` — all entries (...,)-arrays."""
    ct, st = jnp.cos(th), jnp.sin(th)
    ca, sa = _CA_SA[i]
    a, d = A_[i], D_[i]
    cols = (
        (ct, st, 0.0),
        (-st * ca, ct * ca, sa),
        (st * sa, -ct * sa, ca),
    )

    def dot_row(i_, col):
        acc = None
        for k in range(3):
            ck = col[k]
            if isinstance(ck, float):
                if ck == 0.0:
                    continue
                term = R[i_][k] * ck
            else:
                term = R[i_][k] * ck
            acc = term if acc is None else acc + term
        return acc

    Rn = [[dot_row(i_, cols[j]) for j in range(3)] for i_ in range(3)]
    pn = tuple(
        p[i_]
        + (R[i_][0] * (a * ct) if a else 0.0)
        + (R[i_][1] * (a * st) if a else 0.0)
        + (R[i_][2] * d if d else 0.0)
        for i_ in range(3)
    )
    return Rn, pn


def fk_jacobian_points(q, frame: str = "tool"):
    """Batched FK point + 3×6 position Jacobian, SoA form.

    ``q``: (..., 6) joint configurations with ARBITRARY leading batch dims.
    Returns ``(points (..., 3), jac (..., 3, 6))`` computed with purely
    elementwise ops on the leading dims.  ``frame``: "tool" (frame-6
    origin, = :func:`forward_kinematics`), "back6" (frame-5 origin),
    "elbow" (frame-2 origin).
    """
    q = jnp.asarray(q)
    n_links = _FRAME_LINKS[frame]
    dt_ = q.dtype
    batch = q.shape[:-1]
    zero = jnp.zeros(batch, dt_)
    one = jnp.ones(batch, dt_)
    R = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]
    p = (zero, zero, zero)
    axes, origins = [], []
    for i in range(n_links):
        # Joint i rotates about the CURRENT frame's z-axis through its origin.
        axes.append((R[0][2], R[1][2], R[2][2]))
        origins.append(p)
        R, p = _soa_compose(R, p, q[..., i], i)

    cols = []
    for i in range(NUM_JOINTS):
        if i < n_links:
            zx, zy, zz = axes[i]
            rx, ry, rz = (p[0] - origins[i][0], p[1] - origins[i][1],
                          p[2] - origins[i][2])
            cols.append((zy * rz - zz * ry, zz * rx - zx * rz,
                         zx * ry - zy * rx))
        else:
            cols.append((zero, zero, zero))
    points = jnp.stack(p, axis=-1)  # (..., 3)
    jac = jnp.stack(
        [jnp.stack([cols[i][ax] for i in range(NUM_JOINTS)], axis=-1)
         for ax in range(3)],
        axis=-2,
    )  # (..., 3, 6)
    return points, jac


def make_ball(frame: str, radius: float, is_gripper: bool = False):
    """UR5e :class:`~osqp_solver_tpu.models.robot.RobotBall` with BOTH the
    scalar callables (reference ``RobotBall.fk``/``jacobian`` API,
    utils.h:33-42) and the SoA batched evaluator the jitted SCP
    linearization prefers (``gomp/trajectory_qp.py::linearize_workspace``)."""
    from .robot import RobotBall

    fk = {"tool": forward_kinematics, "back6": forward_kinematics_6_back,
          "elbow": forward_kinematics_elbow_joint}[frame]
    jac = {"tool": joint_jacobian, "back6": joint_jacobian_6_back,
           "elbow": jacobian_elbow_joint}[frame]
    return RobotBall(
        fk=fk, jacobian=jac, radius=radius, is_gripper=is_gripper,
        fk_jac_batched=partial(fk_jacobian_points, frame=frame),
    )


# ---------------------------------------------------------------------------
# Closed-form inverse kinematics (8 branches).
# ---------------------------------------------------------------------------


def _inv_rigid(T):
    """Inverse of a rigid transform."""
    R = T[:3, :3]
    p = T[:3, 3]
    Ti = jnp.eye(4, dtype=T.dtype)
    Ti = Ti.at[:3, :3].set(R.T)
    return Ti.at[:3, 3].set(-R.T @ p)


def _safe_acos(x):
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def inverse_kinematics(T):
    """All 8 closed-form UR5e joint solutions for a tool pose ``T`` (4×4).

    Returns ``(solutions, valid)``: ``(8, 6)`` joint configurations and an
    ``(8,)`` bool mask (False where a branch is out of workspace).  API-parity
    capability: the reference stores but never calls its ``gripper_ik``
    (``gomp-solver.h:34,103`` — dead code there, live here).

    Branch order: (shoulder ±) × (wrist ±) × (elbow ±).
    """
    T = jnp.asarray(T)
    with jax.default_matmul_precision("highest"):
        # reduced-precision f32 matmuls would smear the branch reductions
        # (T01^-1 . T06 . T56^-1 . T45^-1 chains) by ~1e-3 — full precision
        # keeps the 8 branches at FK round-trip accuracy (see frames()).
        return _inverse_kinematics_body(T)


def _inverse_kinematics_body(T):
    dt_ = T.dtype
    px, py = T[0, 3], T[1, 3]

    # θ1: shoulder. Wrist center p05 = p06 − d6·z6.
    p05 = T[:3, 3] - D6 * T[:3, 2]
    R05 = jnp.hypot(p05[0], p05[1])
    psi = jnp.arctan2(p05[1], p05[0])
    phi = _safe_acos(D4 / jnp.maximum(R05, 1e-12))
    valid_1 = R05 >= abs(D4)
    th1_opts = jnp.stack([psi + phi + np.pi / 2, psi - phi + np.pi / 2])

    def for_th1(th1):
        c1, s1 = jnp.cos(th1), jnp.sin(th1)
        # θ5: wrist-2 from the projection of p06 onto the θ1 plane.
        arg5 = (px * s1 - py * c1 - D4) / D6
        valid_5 = jnp.abs(arg5) <= 1.0 + 1e-9
        th5_mag = _safe_acos(arg5)
        th5_opts = jnp.stack([th5_mag, -th5_mag])

        def for_th5(th5):
            s5 = jnp.sin(th5)
            sgn5 = jnp.where(s5 >= 0, 1.0, -1.0)
            # θ6 from the base-frame x/y axes of the tool rotation.
            denom_ok = jnp.abs(s5) > 1e-9
            q6 = jnp.arctan2(
                sgn5 * -(T[0, 1] * s1 - T[1, 1] * c1),
                sgn5 * (T[0, 0] * s1 - T[1, 0] * c1),
            )
            th6 = jnp.where(denom_ok, q6, 0.0)  # wrist singular: free θ6

            # Reduce to the planar 2R problem for θ2, θ3, θ4:
            # T14 = T01⁻¹ · T06 · T56⁻¹ · T45⁻¹.
            T01 = _dh(th1, jnp.asarray(D1, dt_), jnp.asarray(0.0, dt_), jnp.asarray(ALPHA[0], dt_))
            T45 = _dh(th5, jnp.asarray(D5, dt_), jnp.asarray(0.0, dt_), jnp.asarray(ALPHA[4], dt_))
            T56 = _dh(th6, jnp.asarray(D6, dt_), jnp.asarray(0.0, dt_), jnp.asarray(ALPHA[5], dt_))
            T14 = _inv_rigid(T01) @ T @ _inv_rigid(T56) @ _inv_rigid(T45)
            p13 = T14[:3, 3] - D4 * T14[:3, 1]
            L = jnp.hypot(p13[0], p13[1])
            c3 = (L**2 - A2**2 - A3**2) / (2 * A2 * A3)
            valid_3 = jnp.abs(c3) <= 1.0 + 1e-9
            th3_mag = _safe_acos(c3)

            def for_th3(th3):
                th2 = -jnp.arctan2(p13[1], -p13[0]) + jnp.arcsin(
                    jnp.clip(A3 * jnp.sin(th3) / jnp.maximum(L, 1e-12), -1.0, 1.0)
                )
                # θ4 closes the chain: T34 = T23⁻¹ · T12⁻¹ · T14.
                T12 = _dh(th2, jnp.asarray(0.0, dt_), jnp.asarray(A2, dt_), jnp.asarray(0.0, dt_))
                T23 = _dh(th3, jnp.asarray(0.0, dt_), jnp.asarray(A3, dt_), jnp.asarray(0.0, dt_))
                T34 = _inv_rigid(T23) @ _inv_rigid(T12) @ T14
                th4 = jnp.arctan2(T34[1, 0], T34[0, 0])
                return jnp.stack([th1, th2, th3, th4, th5, th6])

            sols = jnp.stack([for_th3(th3_mag), for_th3(-th3_mag)])
            return sols, jnp.stack([valid_3, valid_3]) & valid_5

        sols, valids = jax.vmap(for_th5)(th5_opts)  # (2, 2, 6), (2, 2)
        return sols.reshape(4, 6), valids.reshape(4)

    sols, valids = jax.vmap(for_th1)(th1_opts)  # (2, 4, 6), (2, 4)
    return sols.reshape(8, 6), valids.reshape(8) & valid_1


def inverse_kinematics_position(p, q_ref=None):
    """Position-only IK mirror of the external
    ``int inverse_kinematics(double*, x, y, z)`` signature
    (``solver-example.cpp:53``): finds joint configs whose *tool point*
    reaches ``p`` with a fixed downward-facing tool orientation, returning the
    solution closest to ``q_ref`` (or the first valid one).
    """
    p = jnp.asarray(p)
    # Tool z pointing down, x along base x.
    R = jnp.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], p.dtype)
    T = jnp.eye(4, dtype=p.dtype).at[:3, :3].set(R).at[:3, 3].set(p)
    sols, valid = inverse_kinematics(T)
    if q_ref is None:
        q_ref = jnp.zeros(6, p.dtype)
    dist = jnp.where(valid, jnp.sum((sols - q_ref) ** 2, axis=1), jnp.inf)
    best = jnp.argmin(dist)
    return sols[best], valid[best]


def inverse_kinematics_checked(p, q_ref=None):
    """Host-side IK entry that RAISES
    :class:`~osqp_solver_tpu.utils.types.NoInverseKinematicSolution` when no
    branch reaches ``p`` — the behavior the reference's dead exception
    (``utils.h:66-70``) was written for but never wired to its (also
    never-called) ``gripper_ik`` (``gomp-solver.h:34,103``).  Eager-only
    (raising is host control flow); inside jit use
    :func:`inverse_kinematics_position` and handle the validity flag.
    """
    from ..utils.types import NoInverseKinematicSolution

    q, valid = inverse_kinematics_position(p, q_ref)
    if not bool(valid):
        raise NoInverseKinematicSolution(tuple(float(v) for v in jnp.asarray(p)))
    return q


def wrap_to_pi(q):
    """Wrap angles to (−π, π]."""
    return jnp.arctan2(jnp.sin(q), jnp.cos(q))
