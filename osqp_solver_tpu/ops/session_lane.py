"""Batched lane-major solver sessions: a fleet of warm-started MPC solvers.

The scalar :mod:`osqp_solver_tpu.ops.session` mirrors the reference's
``QPSolver`` wrapper (``/root/reference/src/osqp-wrapper.h:12-60``) for one
problem; this is the same OSQP session contract — equilibrate once with
*frozen* scaling, cache the KKT factorization, carry x/y/ρ across
``Solve()`` calls — for a whole batch in the lane (batch-last) layout, so
every re-solve runs the lane driver (:mod:`ops.admm_lane`, with the fused
chunk kernel where :mod:`ops.backend` selects it) with zero relayouts and
**zero refactorizations** on the bounds-update fast path.

Production shape: B independent receding-horizon controllers (one QP per
robot) stepped together — per tick, update each problem's bounds
(values-only), re-solve warm-started from its own previous solution.

Like OSQP's ``osqp_update_bounds``, the cached factor stays valid only
while each row's classification (equality / loose / finite) is unchanged —
ρ_vec is derived from the bounds (``admm._rho_vec``).  Keep bound sweeps
classification-stable (shift an equality, don't turn it into a range); the
scalar session's ``guard_reclassification`` rationale applies unchanged.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from .. import struct

from .admm import Settings, _rho_vec
from .admm_lane import (
    _solve_core,
    identity_scaling_lane,
    ruiz_equilibrate_lane,
)
from .ruiz import Scaling


@struct.dataclass
class LaneSession:
    base: object  # unscaled LaneTrajectoryQP
    scaled: object  # Ruiz-scaled problem (scaling frozen at setup)
    scaling: Scaling
    warm_x: jnp.ndarray  # (n, B) unscaled primal carry
    warm_y: jnp.ndarray  # (m, B) unscaled dual carry
    rho_bar: jnp.ndarray  # (B,) carried ρ̄ (advanced by adaptation)
    factor: object  # cached KKT factor for (scaled, rho_bar)


def setup_lane(qps, settings: Settings = Settings()) -> LaneSession:
    """Equilibrate once, factor once (``OsqpSolver::Init`` semantics for the
    whole batch).  ``qps``: lane-major :class:`LaneTrajectoryQP` (or a
    batch-leading pytree, converted)."""
    from ..gomp.trajectory_qp_lane import LaneTrajectoryQP, to_lane

    if not isinstance(qps, LaneTrajectoryQP):
        qps = to_lane(qps)
    if settings.kkt_method != "direct":
        raise NotImplementedError("lane sessions support the direct backend")
    if settings.scaling > 0:
        scaled, scaling = ruiz_equilibrate_lane(qps, settings.scaling)
    else:
        scaled, scaling = qps, identity_scaling_lane(qps)
    n, B = qps.q.shape
    m = qps.l.shape[0]
    dtype = qps.q.dtype
    rho_bar = jnp.full((B,), settings.rho, dtype)
    factor = _fresh_factor(scaled, rho_bar, settings)
    return LaneSession(
        base=qps,
        scaled=scaled,
        scaling=scaling,
        warm_x=jnp.zeros((n, B), dtype),
        warm_y=jnp.zeros((m, B), dtype),
        rho_bar=rho_bar,
        factor=factor,
    )


def _fresh_factor(scaled, rho_bar, settings: Settings):
    rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
    return scaled.kkt_factor(rho_vec, settings.sigma)


def update_bounds_lane(
    session: LaneSession,
    guard_reclassification: bool = False,
    settings: Settings = Settings(),
    **bound_fields,
) -> LaneSession:
    """Values-only bounds/q update with frozen scaling and KEPT factor
    (``SetBounds``, ``osqp-wrapper.h:39-41``).  ``bound_fields`` replace
    fields on the unscaled base container (e.g. ``pos_l=..., pos_u=...``).

    The cached factor assumes each row's classification (equality / loose /
    finite → ρ_vec) is unchanged; an unguarded flip stalls convergence
    (tests/test_reclassification.py) though termination still evaluates TRUE
    residuals so accepted solutions remain optimal-to-tolerance.  With
    ``guard_reclassification=True`` the classification is compared
    elementwise and the WHOLE batch refactors under a scalar ``lax.cond``
    when any row of any problem flipped — zero factor cost on the (common)
    stable path, one batched refactor otherwise.  Off by default: the guard
    is a per-tick cost that insures against a hazard the fleet path avoids
    by construction and that can only stall (never corrupt) a solve.  Turn
    it on for bound sweeps that may cross equality↔box boundaries."""
    s = session.scaling
    old_rho = _rho_vec(
        session.rho_bar, session.scaled.l, session.scaled.u
    ) if guard_reclassification else None
    base = session.base.replace(**bound_fields)
    session = session.replace(base=base, scaled=base.scale_data(s.D, s.E, s.c))
    if not guard_reclassification:
        return session
    new_rho = _rho_vec(session.rho_bar, session.scaled.l, session.scaled.u)
    changed = jnp.any(old_rho != new_rho)

    def refactor(sess):
        return sess.replace(factor=_fresh_factor(sess.scaled, sess.rho_bar, settings))

    return jax.lax.cond(changed, refactor, lambda s: s, session)


def solve_lane(
    session: LaneSession, settings: Settings = Settings()
):
    """Warm-started re-solve on the cached factor; returns
    ``(advanced session, batch-leading SolveResult)`` — the OSQP
    cross-``Solve()`` carry (x/y/ρ/factor advance)."""
    result, (x, y, rho_bar, factor) = _solve_core(
        session.base, session.scaled, session.scaling, settings,
        wx=session.warm_x, wy=session.warm_y, rb=session.rho_bar,
        factor=session.factor,
    )
    return (
        session.replace(warm_x=x, warm_y=y, rho_bar=rho_bar, factor=factor),
        result,
    )


def mpc_scan_lane(
    session: LaneSession,
    updates,
    apply_update,
    settings: Settings = Settings(),
    emit: str = "stats",
):
    """Fleet MPC sweep: ``lax.scan`` over ticks, whole batch per tick.

    ``apply_update(base_qps, upd) -> new_base`` must change only bounds/q
    (A/P untouched, classification stable) so the cached factor stays valid
    across every tick of every problem.  ``emit``: "stats" scans out
    ``(status, iterations)`` per tick ((T, B) each — x for 1000×1024×1200
    ticks would be GBs); "full" also scans out x.

    Reference anchor: the warm-started sequential ``Solve()`` loop
    (``gomp-solver.h:41-52``) — here B problems × T ticks on one chip.
    """

    def step(sess, upd):
        sess = update_bounds_lane_apply(sess, apply_update, upd)
        sess, res = solve_lane(sess, settings)
        out = (res.status, res.iterations)
        if emit == "full":
            out = out + (res.x,)
        return sess, out

    return jax.lax.scan(step, session, updates)


def update_bounds_lane_apply(session, apply_update, upd) -> LaneSession:
    s = session.scaling
    base = apply_update(session.base, upd)
    return session.replace(base=base, scaled=base.scale_data(s.D, s.E, s.c))
