"""Obstacle geometry: horizontal-line obstacles + spherical keep-outs.

JAX-native re-design of the reference's ``src/horizontal-line.h`` (the whole
file, 106 LoC).  The reference operates point-by-point with scalar branches;
here every predicate is a vectorized jnp expression over a whole ``(W, 3)``
trajectory at once so the SCP linearization runs inside ``jit`` with static
shapes (and ``vmap``s over obstacles, balls, and problem batches).

Obstacles are duck-typed: anything with ``violates(points, radius)`` (the
exact-FK feasibility test) and ``linearize_rows(points, jac, jq, radius)``
(one SCP constraint row per waypoint) plugs into ``GOMPSolver``,
``linearize_workspace``, and the dense parity builder.  ``HorizontalLine``
is the reference's geometry; ``SphereObstacle`` is an extension beyond it.

Collision semantics mirror ``horizontal-line.h:78-92``:
a waypoint "collides" with the line iff the ball around the waypoint's XY
projection is within ``radius`` of the line, OR either adjacent trajectory
segment crosses the line in the XY plane.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from .constraints import INF  # noqa: F401  (re-exported convenience)

ERROR = 1e-3  # feasibility slack, mirrors /root/reference/src/utils.h:31


@struct.dataclass
class HorizontalLine:
    """An infinite horizontal (XY-plane-parallel) line obstacle.

    ``direction``: unit 3-vector along the line with z == 0
    (``horizontal-line.h:23-26`` normalizes the XY input direction).
    ``point``: any point on the line.  ``bypass_below`` mirrors
    ``bypass_from_below`` (``horizontal-line.h:15``): +1.0 if robot balls must
    pass under the line, else -1.0 (stored as a float so it stays a pytree
    leaf and batches under ``vmap``).
    """

    direction: jnp.ndarray  # (3,), unit, z = 0
    point: jnp.ndarray  # (3,)
    bypass_below: jnp.ndarray  # scalar: 1.0 = bypass from below, -1.0 = above

    @classmethod
    def create(cls, direction_xy, point, bypass_from_below: bool = False):
        d = np.asarray(direction_xy, dtype=np.float64)
        d3 = np.array([d[0], d[1], 0.0]) / np.linalg.norm(d)
        return cls(
            direction=jnp.asarray(d3),
            point=jnp.asarray(np.asarray(point, dtype=np.float64)),
            bypass_below=jnp.asarray(1.0 if bypass_from_below else -1.0),
        )

    # --- geometry (each works on (..., 3) batches of points) ----------------

    def distance_vec(self, p):
        """Perpendicular from ``p`` to the line, ``X - P``
        (``horizontal-line.h:44-47``)."""
        rel = p - self.point
        proj = jnp.sum(rel * self.direction, axis=-1, keepdims=True)
        x = self.point + proj * self.direction
        return x - p

    def distance_vec_xy(self, p):
        """XY components of the perpendicular (``horizontal-line.h:49-52``)."""
        return self.distance_vec(p)[..., :2]

    def distance_xy(self, p):
        """Horizontal distance from ``p`` to the line (``horizontal-line.h:54-59``)."""
        return jnp.linalg.norm(self.distance_vec_xy(p), axis=-1)

    def closest_point(self, p):
        """Point on the line closest to ``p`` (``horizontal-line.h:64-66``)."""
        return p + self.distance_vec(p)

    def on_opposite_sides(self, p, q):
        """True if ``p`` and ``q`` are on opposite sides in XY
        (``horizontal-line.h:68-72``)."""
        dp = self.distance_vec_xy(p)
        dq = self.distance_vec_xy(q)
        return jnp.sum(dp * dq, axis=-1) < 0

    def is_close(self, p, radius):
        """Ball of ``radius`` at ``p`` intersects the line in XY
        (``horizontal-line.h:74-76``)."""
        return self.distance_xy(p) < radius

    def has_collision(self, trajectory_xyz, radius):
        """Per-waypoint collision mask for a ``(W, 3)`` trajectory.

        Vectorized equivalent of ``horizontal-line.h:78-92`` evaluated for all
        waypoints at once: close to the line, or either adjacent segment
        crosses it in XY.
        """
        p = trajectory_xyz
        close = self.is_close(p, radius)  # (W,)
        crosses = self.on_opposite_sides(p[:-1], p[1:])  # (W-1,) segment t..t+1
        false_pad = jnp.zeros((1,), dtype=bool)
        prev_cross = jnp.concatenate([false_pad, crosses])  # segment (t-1, t)
        next_cross = jnp.concatenate([crosses, false_pad])  # segment (t, t+1)
        return close | prev_cross | next_cross

    def is_above(self, p, radius):
        """Ball at ``p`` is clear on its required side of the line, with the
        reference's ``radius ∓ ERROR`` slack (``horizontal-line.h:94-98``)."""
        dz = (p - self.point)[..., 2]
        below_ok = dz <= -radius + ERROR
        above_ok = dz >= radius - ERROR
        return jnp.where(self.bypass_below > 0, below_ok, above_ok)

    @property
    def bypass_from_below(self):
        return self.bypass_below > 0

    # --- obstacle protocol (duck-typed; SphereObstacle implements the same)

    def violates(self, points, radius):
        """Per-waypoint exact-FK infeasibility (``gomp-solver.h:141-199``
        usage): collision-flagged AND not clear on the required side."""
        return self.has_collision(points, radius) & ~self.is_above(
            points, radius
        )

    def linearize_rows(self, points, jac, jq, radius, movable=None):
        """One linearized collision row per waypoint, vectorized — the
        ``constraint-builder.h:246-267`` Z-row semantics: bound the ball's
        Z (via ``J_z``) above/below the line height at the closest point
        wherever :meth:`has_collision` flags the waypoint; dummy ``±INF``
        rows with the SAME coefficients elsewhere (``:108-117``).

        ``points``: ``(W, 3)`` ball positions at the linearization point;
        ``jac``: ``(W, 3, N)`` ball Jacobians; ``jq``: ``(W, 3)`` per-axis
        ``J·q0``.  ``movable`` (protocol-optional) is ignored: the Z-row
        is absolute — a waypoint clear on its required side satisfies its
        own row, pinned or not.  Returns ``(row_jac (W, N), low (W,),
        upp (W,))`` with the ±``radius`` ball tightening applied."""
        coll = self.has_collision(points, radius)  # (W,)
        bound = (
            self.closest_point(points)[..., 2] - points[..., 2] + jq[..., 2]
        )
        below = self.bypass_below > 0
        low = jnp.where(coll & ~below, bound, -INF) + radius
        upp = jnp.where(coll & below, bound, INF) - radius
        return jac[:, 2, :], low, upp


@struct.dataclass
class SphereObstacle:
    """A spherical keep-out obstacle — an EXTENSION beyond the
    reference's only geometry (``horizontal-line.h``): every robot ball
    must stay at least ``radius + ball_radius`` from ``center``.

    Implements the same duck-typed obstacle protocol as
    :class:`HorizontalLine` (``violates`` for the exact-FK check,
    ``linearize_rows`` for the SCP constraint rows), so spheres drop into
    ``GOMPSolver(obstacles=[...])``, ``linearize_workspace``, and the
    dense parity builder unchanged — the obstacle row container stores one
    scalar row per (ball, obstacle, waypoint) whatever its direction.

    ``margin``: SCP activation gate — the linearized keep-out row is live
    whenever the ball is within ``radius + ball_radius + margin`` of the
    center (the proximity analogue of the line's segment-crossing test);
    the exact-FK check uses the hard radius with the reference's ``ERROR``
    slack."""

    center: jnp.ndarray  # (3,)
    radius: jnp.ndarray  # scalar
    margin: jnp.ndarray  # scalar

    @classmethod
    def create(cls, center, radius, margin: float = 0.1):
        return cls(
            center=jnp.asarray(np.asarray(center, dtype=np.float64)),
            radius=jnp.asarray(float(radius)),
            margin=jnp.asarray(float(margin)),
        )

    def distance(self, p):
        """Euclidean distance from ``p`` (``(..., 3)``) to the center."""
        return jnp.linalg.norm(p - self.center, axis=-1)

    def segment_closest(self, points):
        """Closest approach of each trajectory segment ``[p_t, p_{t+1}]``
        to the center: ``(rel (W-1, 3), dist (W-1,), t (W-1,))`` with
        ``rel`` from the center to the segment's closest point and ``t``
        the on-segment parameter (same protocol arity as
        :meth:`CapsuleObstacle.segment_closest`).  The sphere analogue of
        the line's adjacent-segment-crossing test
        (``horizontal-line.h:78-92``): between-waypoint tunneling is
        caught here, not just waypoint penetration."""
        a, b = points[:-1], points[1:]
        d = b - a
        denom = jnp.maximum(jnp.sum(d * d, axis=-1), 1e-18)
        t = jnp.clip(
            jnp.sum((self.center - a) * d, axis=-1) / denom, 0.0, 1.0
        )
        rel = a + t[..., None] * d - self.center
        return rel, jnp.linalg.norm(rel, axis=-1), t

    def violates(self, points, radius):
        """Ball at a waypoint penetrates the keep-out sphere, OR either
        adjacent trajectory segment's closest approach does (the segment
        discipline the line obstacle applies in ``has_collision``,
        ``horizontal-line.h:78-92``) — with the reference's ``ERROR``
        feasibility slack.  A 2-waypoint hop THROUGH the sphere is
        therefore rejected even when both endpoints are clear."""
        clear = self.radius + radius - ERROR
        wp = self.distance(points) < clear
        _, seg_dist, _ = self.segment_closest(points)
        seg = seg_dist < clear
        pad = jnp.zeros((1,), bool)
        return wp | jnp.concatenate([pad, seg]) | jnp.concatenate([seg, pad])

    def linearize_rows(self, points, jac, jq, radius, movable=None):
        """Linearized keep-out row per waypoint, with between-waypoint
        tunneling handled (the sphere analogue of the line's
        adjacent-segment discipline, ``horizontal-line.h:78-92``).

        Two cut forms, selected per waypoint by whichever approach to the
        sphere is closest:

        * **own proximity** → the classic radial supporting-hyperplane
          ``n·(p − c) ≥ R + r`` with ``n = (p0 − c)/‖p0 − c‖`` (fallback
          ẑ at the exact center) — absolute: any waypoint clear of the
          sphere satisfies its own row, so a pinned-but-clear start/end
          never turns the QP infeasible;
        * **interior segment crossing** (an adjacent segment's closest
          approach, strictly between the endpoints, penetrates) → a
          *relative* push ``n·J·q ≥ n·J·q0 + depth·lever`` along the
          center→closest-point direction ``n`` (fallback: ⊥ to the chord),
          where ``depth = R + r − d_seg`` is the penetration and ``lever ≈
          1/(1 − t*)`` converts endpoint motion into crossing-point motion
          (capped at 4).  Moving the endpoint by ``depth·lever`` along
          ``n`` moves the chord's closest point clear — the cut actually
          removes the tunnel instead of chasing it along the path.

        ``movable``: optional ``(W,)`` bool — waypoints the QP can move
        (the planner marks the pinned start/end ``q₀``/``q_{W−3}`` as
        immovable).  Immovable waypoints never receive segment cuts (they
        cannot honor a demanded motion — the burden falls entirely on the
        segment's other endpoint); they keep the absolute radial cut,
        which a clear pin satisfies.

        Rows are live whenever the selected approach distance is inside
        the ``margin``-inflated radius, dummy ``±INF`` (same coefficients)
        elsewhere.  Same signature/returns as
        :meth:`HorizontalLine.linearize_rows`."""
        rel = points - self.center  # (W, 3)
        rel_s, _, t = self.segment_closest(points)  # (W-1, 3), _, (W-1,)
        Rtot = self.radius + radius
        return _keepout_cut_rows(
            points, jac, jq, rel, rel_s, t, Rtot, Rtot + self.margin, movable
        )


def _keepout_cut_rows(points, jac, jq, rel, rel_s, t, Rtot, gate, movable):
    """Shared SCP cut construction for convex keep-out obstacles (the body
    behind :meth:`SphereObstacle.linearize_rows`, reused by
    :class:`CapsuleObstacle`): given the obstacle-specific closest-approach
    geometry, build one linearized row per waypoint with the two cut forms
    documented on :meth:`SphereObstacle.linearize_rows` (absolute radial
    own-proximity cut; relative ``depth·lever`` push for interior
    trajectory-segment crossings, gated by ``movable``).

    ``rel``: ``(W, 3)`` from the obstacle core's closest point to each
    waypoint; ``rel_s``/``t``: ``(W-1, 3)``/``(W-1,)`` closest-approach
    vector and on-trajectory-segment parameter for each trajectory segment
    (from the core's nearest point to the segment's); ``Rtot``: hard
    keep-out distance (obstacle radius + ball radius); ``gate``: activation
    distance (``Rtot`` + margin)."""
    Wn = points.shape[0]
    dist = jnp.linalg.norm(rel, axis=-1)  # (W,)
    if movable is None:
        movable = jnp.ones((Wn,), bool)

    # --- own-proximity cut (absolute radial) -------------------------------
    zhat = jnp.zeros_like(rel).at[..., 2].set(1.0)
    n_own = jnp.where((dist > 1e-9)[:, None], rel, zhat)
    n_own = n_own / jnp.maximum(
        jnp.linalg.norm(n_own, axis=-1), 1e-9
    )[:, None]
    low_own = (
        Rtot
        - jnp.sum(n_own * rel, axis=-1)
        + jnp.sum(n_own * jq, axis=-1)
    )

    # --- interior-crossing cuts (relative push) ----------------------------
    dvec = points[1:] - points[:-1]
    d_seg = jnp.linalg.norm(rel_s, axis=-1)
    interior = (t > 1e-3) & (t < 1.0 - 1e-3)
    # push direction: core → closest point; through-core fallback:
    # ⊥ to the chord (horizontal), then ŷ
    perp = jnp.cross(dvec, zhat[:-1])
    yhat = jnp.zeros_like(rel_s).at[..., 1].set(1.0)
    n_seg = jnp.where(
        (d_seg > 1e-9)[:, None],
        rel_s,
        jnp.where(
            (jnp.linalg.norm(perp, axis=-1) > 1e-9)[:, None], perp, yhat
        ),
    )
    n_seg = n_seg / jnp.maximum(
        jnp.linalg.norm(n_seg, axis=-1), 1e-9
    )[:, None]
    depth = Rtot - d_seg  # (W-1,) > 0 iff the chord penetrates
    lev_a = 1.0 / jnp.clip(1.0 - t, 0.25, 1.0)
    lev_b = 1.0 / jnp.clip(t, 0.25, 1.0)

    inf1 = jnp.full((1,), jnp.inf, dist.dtype)
    zero1 = jnp.zeros((1, 3), rel.dtype)
    seg_d_eff = jnp.where(interior, d_seg, jnp.inf)
    # prev candidate of waypoint w: segment w-1, endpoint b (lever 1/t)
    prev_d = jnp.concatenate([inf1, seg_d_eff])
    prev_n = jnp.concatenate([zero1, n_seg])
    # zero (NOT inf*0 = NaN: masked in the forward pass but poisonous
    # under jax.grad through the unselected where-branch)
    zpad = jnp.zeros((1,), dist.dtype)
    prev_push = jnp.concatenate([zpad, depth * lev_b])
    # next candidate of waypoint w: segment w, endpoint a (lever 1/(1-t))
    next_d = jnp.concatenate([seg_d_eff, inf1])
    next_n = jnp.concatenate([n_seg, zero1])
    next_push = jnp.concatenate([depth * lev_a, zpad])
    # immovable waypoints cannot honor a demanded motion
    prev_d = jnp.where(movable, prev_d, jnp.inf)
    next_d = jnp.where(movable, next_d, jnp.inf)

    use_prev = prev_d < jnp.minimum(dist, next_d)
    use_next = (~use_prev) & (next_d < dist)
    n = jnp.where(
        use_prev[:, None],
        prev_n,
        jnp.where(use_next[:, None], next_n, n_own),
    )
    push = jnp.where(use_prev, prev_push, jnp.where(use_next, next_push, 0.0))
    rq0 = jnp.sum(n * jq, axis=-1)  # (n·J)·q0
    low_seg = rq0 + push
    low_sel = jnp.where(use_prev | use_next, low_seg, low_own)
    dmin = jnp.minimum(dist, jnp.minimum(prev_d, next_d))
    live = dmin < gate
    # (W, N) = n·J; full precision — a reduced-precision matmul default would
    # smear the SCP row coefficients ~0.4% (ops/ pins _HI the same way)
    row = jnp.einsum(
        "wa,wan->wn", n, jac, precision=jax.lax.Precision.HIGHEST
    )
    low = jnp.where(live, low_sel, -INF)
    upp = jnp.full_like(low, INF)
    return row, low, upp


@struct.dataclass
class CapsuleObstacle:
    """A capsule keep-out (a cylinder with hemispherical caps around the
    axis segment ``[a, b]``) — the third geometry of the duck-typed
    obstacle protocol, modeling posts, shelf edges, and cable runs: every
    robot ball must stay at least ``radius + ball_radius`` from the axis
    SEGMENT.  Same protocol (``violates`` + ``linearize_rows``) and the
    same between-waypoint tunneling discipline as
    :class:`SphereObstacle` (``horizontal-line.h:78-92`` anchor), sharing
    its cut construction (:func:`_keepout_cut_rows`); batches per-query
    via :func:`stack_obstacles` like any obstacle."""

    a: jnp.ndarray  # (3,) axis segment start
    b: jnp.ndarray  # (3,) axis segment end
    radius: jnp.ndarray  # scalar
    margin: jnp.ndarray  # scalar

    @classmethod
    def create(cls, a, b, radius, margin: float = 0.1):
        return cls(
            a=jnp.asarray(np.asarray(a, dtype=np.float64)),
            b=jnp.asarray(np.asarray(b, dtype=np.float64)),
            radius=jnp.asarray(float(radius)),
            margin=jnp.asarray(float(margin)),
        )

    def axis_closest(self, p):
        """Closest point on the axis segment ``[a, b]`` to ``p``
        (``(..., 3)``)."""
        v = self.b - self.a
        vv = jnp.maximum(jnp.sum(v * v), 1e-18)
        t = jnp.clip(jnp.sum((p - self.a) * v, axis=-1) / vv, 0.0, 1.0)
        return self.a + t[..., None] * v

    def distance(self, p):
        """Euclidean distance from ``p`` to the capsule axis segment."""
        return jnp.linalg.norm(p - self.axis_closest(p), axis=-1)

    def segment_closest(self, points):
        """Closest approach of each trajectory segment ``[p_t, p_{t+1}]``
        to the AXIS SEGMENT (segment-segment): returns
        ``(rel (W-1, 3), dist (W-1,), t (W-1,))`` with ``rel`` from the
        axis's nearest point to the trajectory's and ``t`` the parameter on
        the trajectory segment — the capsule analogue of
        :meth:`SphereObstacle.segment_closest`.

        Solved by box-clamped coordinate descent on the convex quadratic
        (the Eberly interior solution, then two exact 1-D re-solves with
        the other parameter clamped) — exact except in the
        parallel-segments flat direction, where any minimizer is as good.
        """
        p0 = points[:-1]
        u = points[1:] - p0  # (S, 3)
        v = self.b - self.a  # (3,)
        w0 = p0 - self.a  # (S, 3)
        A = jnp.maximum(jnp.sum(u * u, axis=-1), 1e-18)
        Bc = u @ v
        Cc = jnp.maximum(jnp.sum(v * v), 1e-18)
        D = jnp.sum(u * w0, axis=-1)
        E = w0 @ v
        den = A * Cc - Bc * Bc
        s = jnp.where(den > 1e-18, (Bc * E - Cc * D) / jnp.maximum(den, 1e-18), 0.0)
        s = jnp.clip(s, 0.0, 1.0)
        t_ax = jnp.clip((Bc * s + E) / Cc, 0.0, 1.0)  # axis param | s
        s = jnp.clip((Bc * t_ax - D) / A, 0.0, 1.0)  # traj param | t
        t_ax = jnp.clip((Bc * s + E) / Cc, 0.0, 1.0)
        traj_pt = p0 + s[:, None] * u
        axis_pt = self.a + t_ax[:, None] * v
        rel = traj_pt - axis_pt
        return rel, jnp.linalg.norm(rel, axis=-1), s

    def violates(self, points, radius):
        """Ball at a waypoint penetrates the capsule, OR either adjacent
        trajectory segment's closest approach to the axis segment does
        (the between-waypoint tunneling discipline,
        ``horizontal-line.h:78-92`` anchor) — with the reference's
        ``ERROR`` feasibility slack."""
        clear = self.radius + radius - ERROR
        wp = self.distance(points) < clear
        _, seg_dist, _ = self.segment_closest(points)
        seg = seg_dist < clear
        pad = jnp.zeros((1,), bool)
        return wp | jnp.concatenate([pad, seg]) | jnp.concatenate([seg, pad])

    def linearize_rows(self, points, jac, jq, radius, movable=None):
        """Linearized keep-out row per waypoint — the sphere's two cut
        forms (:meth:`SphereObstacle.linearize_rows`) with the capsule's
        closest-approach geometry: ``rel`` runs from the axis segment's
        nearest point instead of a fixed center (a supporting hyperplane of
        the capsule at the linearization point — the capsule is convex)."""
        rel = points - self.axis_closest(points)
        rel_s, _, t = self.segment_closest(points)
        Rtot = self.radius + radius
        return _keepout_cut_rows(
            points, jac, jq, rel, rel_s, t, Rtot, Rtot + self.margin, movable
        )


def call_linearize_rows(obstacle, points, jac, jq, radius, movable=None):
    """Invoke an obstacle's ``linearize_rows``, forwarding ``movable`` only
    when the implementation accepts it.

    The pre-round-5 duck-typed protocol was 4-argument
    (``linearize_rows(points, jac, jq, radius)``); round 5 added the
    optional ``movable`` waypoint mask (relative segment cuts must not
    demand motion from pinned endpoints).  User obstacles written against
    the old protocol keep working — they simply never emit relative cuts.
    Runs at trace time only (one ``inspect`` per compile)."""
    import inspect

    try:
        params = inspect.signature(obstacle.linearize_rows).parameters
        accepts = "movable" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
        )
    except (TypeError, ValueError):  # builtins/partials without signatures
        accepts = True
    if accepts and movable is not None:
        return obstacle.linearize_rows(points, jac, jq, radius, movable=movable)
    return obstacle.linearize_rows(points, jac, jq, radius)


def stack_obstacles(obstacles):
    """Stack ``B`` same-type obstacles into ONE batched pytree with a
    leading per-problem axis on every leaf — the container the batched
    planner paths accept for PER-QUERY obstacles
    (``GOMPSolver.run_batch_padded(..., obstacles=[stacked, ...])``): a
    fleet where every query has its own keep-out pose, all inside one
    compiled program (leaf values are traced inputs — moving an obstacle
    never recompiles).

    ``obstacles``: sequence of ``B`` obstacles of the SAME dataclass type
    (e.g. ``B`` :class:`SphereObstacle`\\ s at different centers).  Returns
    one obstacle pytree whose leaves are ``(B, ...)`` stacks.
    """
    first = obstacles[0]
    if any(type(o) is not type(first) for o in obstacles):
        raise TypeError(
            "stack_obstacles needs obstacles of one type per stack; got "
            + ", ".join(sorted({type(o).__name__ for o in obstacles}))
        )
    return jax.tree_util.tree_map(
        lambda *leaves: jnp.stack([jnp.asarray(l) for l in leaves]), *obstacles
    )


def stack_lines(lines) -> HorizontalLine:
    """Stack a list of ``HorizontalLine``s into one batched pytree with a
    leading obstacle axis, for ``vmap`` over obstacles."""
    if not lines:
        return HorizontalLine(
            direction=jnp.zeros((0, 3)),
            point=jnp.zeros((0, 3)),
            bypass_below=jnp.zeros((0,)),
        )
    return HorizontalLine(
        direction=jnp.stack([l.direction for l in lines]),
        point=jnp.stack([l.point for l in lines]),
        bypass_below=jnp.stack([jnp.reshape(l.bypass_below, ()) for l in lines]),
    )
