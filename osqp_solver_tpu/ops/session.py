"""Solver session: setup once, update values, re-solve warm-started.

Functional mirror of the reference's ``QPSolver`` wrapper
(``/root/reference/src/osqp-wrapper.h:12-60``) with OSQP's session semantics:

* ``setup``  — equilibrate once (Ruiz scaling computed here and *frozen*,
  like OSQP's ``Init``);
* ``update`` — replace problem values (A coefficients / bounds / q) keeping
  shapes and the original scaling, mirroring ``UpdateConstraintMatrix`` +
  ``SetBounds`` (``osqp-wrapper.h:33-43``) — OSQP rescales new data with the
  existing D/E/c, and the next solve refactorizes the KKT;
* ``solve``  — run ADMM warm-started from the previous solution (OSQP
  carries x/y/z across ``Solve()`` calls; the reference's explicit
  ``setWarmStart`` is the ``warm_start`` argument of :func:`setup`).

The session is a pytree — it jits, vmaps (batched sessions), and lives on
device across MPC/SCP re-solves (BASELINE config 4: carried state + cached
factorization reuse).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
from .. import struct

from . import admm
from .admm import ADMMState, Settings, SolveResult
from .ruiz import Scaling, identity_scaling, ruiz_equilibrate


@struct.dataclass
class Session:
    base: object  # unscaled QP (DenseQP / TrajectoryQP)
    scaled: object  # scaled QP
    scaling: Scaling
    warm_x: jnp.ndarray  # unscaled primal warm start for the next solve
    warm_y: jnp.ndarray  # unscaled dual warm start
    rho_bar: jnp.ndarray  # carried ρ (adapted across solves, like OSQP)
    factor: object  # cached KKT factor for (scaled, rho_bar)


def setup(
    qp,
    settings: Settings = Settings(),
    warm_x: Optional[jnp.ndarray] = None,
    warm_y: Optional[jnp.ndarray] = None,
) -> Session:
    """Equilibrate, factor, and create a session (mirror of
    ``OsqpSolver::Init`` + ``SetPrimalWarmStart``, ``osqp-wrapper.h:28,45-49``)."""
    n, m = qp.q.shape[-1], qp.l.shape[-1]
    dtype = qp.q.dtype
    if settings.scaling > 0:
        scaled, scaling = ruiz_equilibrate(qp, settings.scaling)
    else:
        scaled, scaling = qp, identity_scaling(n, m, dtype)
    rho_bar = jnp.asarray(settings.rho, dtype)
    factor = admm.kkt_factor(
        scaled, admm._rho_vec(rho_bar, scaled.l, scaled.u), settings.sigma, settings
    )
    return Session(
        base=qp,
        scaled=scaled,
        scaling=scaling,
        warm_x=jnp.zeros(n, dtype) if warm_x is None else jnp.asarray(warm_x, dtype),
        warm_y=jnp.zeros(m, dtype) if warm_y is None else jnp.asarray(warm_y, dtype),
        rho_bar=rho_bar,
        factor=factor,
    )


def update(
    session: Session,
    new_qp,
    refactor: bool = True,
    settings: Settings = Settings(),
) -> Session:
    """Values-only problem update with frozen scaling (OSQP
    ``osqp_update_A``/``osqp_update_bounds`` semantics; shapes must be
    unchanged — which the static containers guarantee by construction).

    ``refactor=False`` keeps the cached KKT factor — valid when only
    bounds/q changed (A and P values untouched), the MPC fast path
    (BASELINE config 4).
    """
    s = session.scaling
    scaled = new_qp.scale_data(s.D, s.E, s.c)
    session = session.replace(base=new_qp, scaled=scaled)
    if refactor:
        factor = admm.kkt_factor(
            scaled,
            admm._rho_vec(session.rho_bar, scaled.l, scaled.u),
            settings.sigma,
            settings,
        )
        session = session.replace(factor=factor)
    return session


def update_bounds(
    session: Session,
    guard_reclassification: bool = False,
    settings: Settings = Settings(),
    **bound_fields,
) -> Session:
    """Bounds/q-only update (``SetBounds``, ``osqp-wrapper.h:39-41``): new
    field values on the base QP, factor kept.

    Correctness requires the constraint classification (equality / loose)
    not to change — ρ_vec is derived from the bounds and must match the
    cached factor (OSQP refactorizes when a bounds update flips a row's
    type).  With ``guard_reclassification=True`` the classification is
    compared elementwise and the KKT is refactorized only when a row flipped
    (a ``lax.cond``; NOTE: under ``vmap`` this lowers to select so the whole
    batch pays the refactor whenever any problem flips — leave it off on the
    MPC fast path and keep bound sweeps classification-stable instead)."""
    old_rho = admm._rho_vec(
        session.rho_bar, session.scaled.l, session.scaled.u
    )
    session = update(
        session, session.base.replace(**bound_fields), refactor=False
    )
    if not guard_reclassification:
        return session
    import jax

    new_rho = admm._rho_vec(
        session.rho_bar, session.scaled.l, session.scaled.u
    )
    changed = jnp.any(old_rho != new_rho)

    def refactor(sess):
        factor = admm.kkt_factor(
            sess.scaled, new_rho, settings.sigma, settings
        )
        return sess.replace(factor=factor)

    return jax.lax.cond(changed, refactor, lambda s: s, session)


def solve(
    session: Session, settings: Settings = Settings()
) -> Tuple[Session, SolveResult]:
    """Solve warm-started from the session's carried iterates and cached
    factor; returns the updated session (iterates + adapted ρ + factor
    advanced — OSQP's cross-``Solve()`` warm starting) and the result."""
    st = admm.init_state(
        session.scaled,
        settings,
        warm_x=session.warm_x,
        warm_y=session.warm_y,
        scaling=session.scaling,
        rho_bar=session.rho_bar,
        factor=session.factor,
    )
    st = admm.run_admm(session.base, session.scaled, session.scaling, st, settings)
    result = admm.finalize(session.base, session.scaling, st)
    return (
        session.replace(
            warm_x=result.x, warm_y=result.y, rho_bar=st.rho_bar, factor=st.factor
        ),
        result,
    )


def mpc_scan(session: Session, updates, apply_update, settings: Settings = Settings()):
    """MPC sweep: ``lax.scan`` over parameter updates with on-device carried
    state (warm starts + cached factor) — the JAX-native replacement for the
    reference's sequential warm-started re-solves (``gomp-solver.h:41-52,65``;
    BASELINE config 4).

    ``apply_update(base_qp, upd) -> new_qp`` must change only bounds or ``q``
    (A/P coefficients untouched) so the cached factor stays valid; use
    :func:`update` with ``refactor=True`` between scans when coefficients
    change.
    """
    import jax

    def step(sess, upd):
        new_qp = apply_update(sess.base, upd)
        sess = update(sess, new_qp, refactor=False)
        sess, res = solve(sess, settings)
        return sess, (res.x, res.status, res.iterations)

    return jax.lax.scan(step, session, updates)
