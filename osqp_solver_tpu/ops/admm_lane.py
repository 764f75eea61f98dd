"""Lane-major (batch-last) batched ADMM driver — zero-relayout hot loop.

Same OSQP semantics as :mod:`osqp_solver_tpu.ops.admm` (Ruiz equilibration,
σ/ρ reduced-KKT, projection, α=1.6 over-relaxation, per-row ρ with
per-problem adaptation, OSQP-default termination, infeasibility
certificates — reference anchor ``/root/reference/src/osqp-wrapper.h`` and
SURVEY §2.2), but the batch axis lives *last* on every array — the fused
chunk kernel's layout (:mod:`.admm_fused`: one row of an array across the
batch is one coalesced load):

* ``vmap``-free: reductions are explicit ``axis=0`` (row axis), per-problem
  scalars are ``(B,)`` vectors;
* each chunk of iterations runs as the fused kernel or as XLA ops, as
  :func:`.backend.admm_chunk` decides; termination, certificates and ρ
  adaptation are XLA in both cases;
* ρ-adapt refactors assemble the KKT directly in lane layout
  (``LaneTrajectoryQP.kkt_blocks``).

Parity with the vmapped driver is pinned by ``tests/test_admm_lane.py``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from .. import struct

from .admm import (
    DIV_TOL,
    INF_THRESHOLD,
    RHO_MAX,
    RHO_MIN,
    Settings,
    SolveResult,
    _rho_vec,
    _stall_init,
    _stall_reset,
    _stall_update,
)
from . import backend
from .ruiz import MAX_SCALING, MIN_SCALING, Scaling, _limit
from .status import ExitCode

_HI = jax.lax.Precision.HIGHEST  # f32 products never run as TF32


# ---------------------------------------------------------------------------
# Ruiz equilibration, batch-last
# ---------------------------------------------------------------------------


def ruiz_equilibrate_lane(qp, iters: int = 10):
    """Batch-last Ruiz (OSQP ``scaling.c`` semantics — see
    :func:`osqp_solver_tpu.ops.ruiz.ruiz_equilibrate`): per-problem scalars
    are ``(B,)``, reductions run over the row axis.

    Norm-only iterations: instead of materializing the 21-array scaled
    container twice per iteration, each iteration computes the scaled row/column
    maxima directly from the base absolute coefficients weighted by the
    running (D, E, c) — elementwise-identical values (|a·e·d| = |a|·e·d for
    positive scalings, same multiply grouping as ``scale_data``) — and the
    full container is scaled exactly once at the end."""
    dtype = qp.q.dtype
    B = qp.q.shape[-1]
    W, N = qp.waypoints, qp.n_dim
    c = jnp.ones((B,), dtype)

    # Base absolute data (read once).
    a_c0 = jnp.abs(qp.dyn_coef[..., 0, :])
    a_c1 = jnp.abs(qp.dyn_coef[..., 1, :])
    a_c2 = jnp.abs(qp.dyn_coef[..., 2, :])
    a_pos = jnp.abs(qp.pos_coef)
    a_vel = jnp.abs(qp.vel_coef)
    a_a0 = jnp.abs(qp.acc_coef[..., 0, :])
    a_a1 = jnp.abs(qp.acc_coef[..., 1, :])
    a_ws = jnp.abs(qp.ws_jac)
    a_obs = jnp.abs(qp.obs_jac)
    a_Pd = jnp.abs(qp.P_diag)
    a_Pl = jnp.abs(qp.P_lower)
    a_q = jnp.abs(qp.q_vec)

    ones = lambda shape: jnp.ones(shape, dtype)  # noqa: E731
    Dq = ones((W, N, B))
    Dv = ones((W, N, B))
    e_dyn = ones((W - 1, N, B))
    e_pos = ones((W, N, B))
    e_vel = ones((W - 1, N, B))
    e_acc = ones((W - 2, N, B))
    e_ws = ones((qp.n_balls, W, 3, B))
    e_obs = ones((qp.n_balls, qp.n_obstacles, W, B))

    def p_colmax(ci):
        """Column maxima of |c·D P D| as (W, 2N, B) — same values as
        ``P_col_absmax(scale_data(...))``, computed without materializing."""
        d_int = jnp.concatenate([Dq, Dv], axis=1)  # (W, 2N, B)
        cd = ci * d_int
        pd = jnp.max(a_Pd * cd[:, :, None], axis=1) * d_int
        if W > 1:
            low_col = jnp.max(a_Pl * cd[1:, :, None], axis=1) * d_int[:-1]
            low_row = jnp.max(a_Pl * d_int[:-1, None, :], axis=2) * cd[1:]
            pd = pd.at[:-1].max(low_col)
            pd = pd.at[1:].max(low_row)
        return pd

    pad = lambda x, b, a: jnp.pad(x, ((b, a), (0, 0), (0, 0)))  # noqa: E731

    for _ in range(iters):
        # Scaled absolute coefficients (grouping mirrors scale_data).
        s_c0 = a_c0 * e_dyn * Dv[:-1]
        s_c1 = a_c1 * e_dyn * Dq[1:]
        s_c2 = a_c2 * e_dyn * Dq[:-1]
        s_pos = a_pos * e_pos * Dq
        s_vel = a_vel * e_vel * Dv[:-1]
        s_a0 = a_a0 * e_acc * Dv[1:-1]
        s_a1 = a_a1 * e_acc * Dv[:-2]
        s_ws = a_ws * e_ws[:, :, :, None, :] * Dq[None, :, None, :, :]
        s_obs = a_obs * e_obs[:, :, :, None, :] * Dq[None, None, :, :, :]

        # A column maxima (mirrors A_col_absmax).
        qm = jnp.maximum(s_pos, pad(s_c2, 0, 1))
        qm = jnp.maximum(qm, pad(s_c1, 1, 0))
        if qp.n_balls:
            qm = jnp.maximum(qm, jnp.max(s_ws, axis=(0, 2)))
        if qp.n_obstacles and qp.n_balls:
            qm = jnp.maximum(qm, jnp.max(s_obs, axis=(0, 1)))
        vm = pad(jnp.maximum(s_vel, s_c0), 0, 1)
        vm = jnp.maximum(vm, pad(s_a1, 0, 2))
        vm = jnp.maximum(vm, pad(s_a0, 1, 1))

        # KKT column maxima: P block included with the current c.
        pm = p_colmax(c)
        col_q = jnp.maximum(qm, pm[:, :N])
        col_v = jnp.maximum(vm, pm[:, N:])
        Dq = Dq * (1.0 / jnp.sqrt(_limit(col_q)))
        Dv = Dv * (1.0 / jnp.sqrt(_limit(col_v)))

        # A row maxima (mirrors A_row_absmax) → E updates per type.
        e_dyn = e_dyn * (
            1.0
            / jnp.sqrt(_limit(jnp.maximum(jnp.maximum(s_c0, s_c1), s_c2)))
        )
        e_pos = e_pos * (1.0 / jnp.sqrt(_limit(s_pos)))
        e_vel = e_vel * (1.0 / jnp.sqrt(_limit(s_vel)))
        e_acc = e_acc * (1.0 / jnp.sqrt(_limit(jnp.maximum(s_a0, s_a1))))
        e_ws = e_ws * (1.0 / jnp.sqrt(_limit(jnp.max(s_ws, axis=-2))))
        e_obs = e_obs * (1.0 / jnp.sqrt(_limit(jnp.max(s_obs, axis=-2))))

        # Cost normalization with the UPDATED D, current c.
        p_cols = _limit(p_colmax(c))
        Dflat = jnp.concatenate(
            [Dq.reshape(-1, B), Dv.reshape(-1, B)], axis=0
        )
        q_max = jnp.max(c * Dflat * a_q, axis=0)
        gamma = 1.0 / _limit(
            jnp.maximum(jnp.mean(p_cols.reshape(-1, B), axis=0), q_max)
        )
        c = c * gamma

    D = jnp.concatenate([Dq.reshape(-1, B), Dv.reshape(-1, B)], axis=0)
    E = qp._concat_rows(
        e_dyn, e_pos, e_vel, e_acc, e_ws, e_obs, pad_value=1.0
    )
    scaled = qp.scale_data(D, E, c)
    scaling = Scaling(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E, cinv=1.0 / c)
    return scaled, scaling


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


@struct.dataclass
class LaneADMMState:
    x: jnp.ndarray  # (n, B) scaled primal
    z: jnp.ndarray  # (m, B)
    y: jnp.ndarray  # (m, B)
    dx: jnp.ndarray
    dy: jnp.ndarray
    rho_bar: jnp.ndarray  # (B,)
    rho_vec: jnp.ndarray  # (m, B)
    factor: object
    iterations: jnp.ndarray  # (B,) int32
    status: jnp.ndarray  # (B,) int32
    done: jnp.ndarray  # (B,) bool
    prim_res: jnp.ndarray  # (B,)
    dual_res: jnp.ndarray  # (B,)
    # Anderson-acceleration carry (Settings.anderson > 0; None otherwise).
    aa_g: Optional[jnp.ndarray] = None  # (mh, d, B) chunk-map outputs
    aa_f: Optional[jnp.ndarray] = None  # (mh, d, B) chunk-map residuals
    aa_vin: Optional[jnp.ndarray] = None  # (d, B) current chunk's input v
    aa_n: Optional[jnp.ndarray] = None  # (B,) history length since reset
    aa_fnorm: Optional[jnp.ndarray] = None  # (B,) last residual inf-norm
    # Stall-detection carry (Settings.stall_checks > 0; None otherwise).
    stall_ref: Optional[jnp.ndarray] = None  # (B,) window-reference metric
    stall_k: Optional[jnp.ndarray] = None  # (B,) int32 checks since armed


def _norm0(v):
    """Per-problem inf-norm over the row axis: (m, B) → (B,)."""
    return jnp.max(jnp.abs(v), axis=0)


def init_state_lane(
    scaled,
    settings: Settings,
    warm_x: Optional[jnp.ndarray] = None,
    warm_y: Optional[jnp.ndarray] = None,
    scaling: Optional[Scaling] = None,
    rho_bar: Optional[jnp.ndarray] = None,
    factor=None,
    rho_vec: Optional[jnp.ndarray] = None,
) -> LaneADMMState:
    """Cold/warm start; ``warm_x``/``warm_y`` are unscaled ``(n|m, B)``."""
    dtype = scaled.q.dtype
    n, B = scaled.q.shape
    m = scaled.l.shape[0]
    if warm_x is None:
        x = jnp.zeros((n, B), dtype)
        z = jnp.zeros((m, B), dtype)
    else:
        x = scaling.Dinv * jnp.asarray(warm_x, dtype)
        z = scaled.A_matvec(x)
    if warm_y is None:
        y = jnp.zeros((m, B), dtype)
    else:
        y = scaling.c * scaling.Einv * jnp.asarray(warm_y, dtype)

    if rho_bar is None:
        rho_bar = jnp.full((B,), settings.rho, dtype)
    if rho_vec is None:
        rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
    if factor is None:
        factor = scaled.kkt_factor(rho_vec, settings.sigma)
    stall_ref, stall_k = _stall_init(settings, dtype, (B,))
    return LaneADMMState(
        x=x,
        z=z,
        y=y,
        dx=jnp.zeros((n, B), dtype),
        dy=jnp.zeros((m, B), dtype),
        rho_bar=rho_bar,
        rho_vec=rho_vec,
        factor=factor,
        iterations=jnp.zeros((B,), jnp.int32),
        status=jnp.full((B,), ExitCode.kUnknown, jnp.int32),
        done=jnp.zeros((B,), bool),
        prim_res=jnp.full((B,), jnp.inf, dtype),
        dual_res=jnp.full((B,), jnp.inf, dtype),
        stall_ref=stall_ref,
        stall_k=stall_k,
    )


def _round_factor(factor, mode: str):
    """Round-trip every factor leaf through a 2-byte storage dtype
    (``Settings.factor_round``): the solve then sees exactly the values a
    2-byte factor would hold, while every path still reads it at full
    width."""
    if mode == "none":
        return factor
    dt = {"f16": jnp.float16, "bf16": jnp.bfloat16}[mode]

    def rt(leaf):
        if leaf is None or not hasattr(leaf, "dtype"):
            return leaf
        if not jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf
        return leaf.astype(dt).astype(leaf.dtype)

    return jax.tree_util.tree_map(
        rt, factor, is_leaf=lambda x: x is None
    )


def _anderson_step(scaled, st, settings: Settings, reset_mask):
    """Safeguarded Anderson extrapolation of the chunk fixed-point map.

    One chunk of ``check_termination`` ADMM iterations is a fixed-point map
    T on v = (x, w = z + y/ρ) — the same map SCS 3.0 accelerates in
    production (PAPERS.md "Trajectory of ADMM and Adaptive Acceleration").
    Between chunks the last ``settings.anderson`` outputs g_i = T(v_i) and
    residuals f_i = g_i − v_i are combined by the type-II constrained
    least squares  min ‖Σ αᵢ fᵢ‖²  s.t. Σα = 1  (tiny per-problem mh×mh
    normal equations), and the iterate jumps to v⁺ = Σ αᵢ g_i.  z and y
    are recovered *consistently* from w (z = Π_[l,u](w), y = ρ(w − z)),
    so the next chunk's termination check evaluates true KKT residuals —
    an accepted solution is optimal-to-tolerance regardless of the path.

    Safeguard: a problem whose chunk residual grew past
    ``anderson_safeguard`` × its previous value — or whose ρ just adapted
    (``reset_mask``; w changes scale) — has its history reset.  A reset
    fills every slot with the current pair, which makes the LS degenerate
    to the plain iterate (any α over duplicates reproduces it).
    """
    mh = settings.anderson
    n = scaled.q.shape[0]

    x0, z0, y0 = st.x, st.z, st.y
    w0 = z0 + y0 / st.rho_vec
    v_out = jnp.concatenate([x0, w0], axis=0)  # (d, B)
    f = v_out - st.aa_vin
    fnorm = jnp.max(jnp.abs(f), axis=0)  # (B,)

    grew = fnorm > settings.anderson_safeguard * st.aa_fnorm
    reset = grew | reset_mask | (st.aa_n == 0)

    kept = jnp.where(reset, 0, st.aa_n)
    slot = kept % mh
    smask = ((jnp.arange(mh)[:, None] == slot[None, :]) | reset[None, :])
    sm = smask[:, None, :]  # (mh, 1, B)
    aa_g = jnp.where(sm, v_out[None], st.aa_g)
    aa_f = jnp.where(sm, f[None], st.aa_f)

    # α ∝ M⁻¹1 with M = FᵀF + λ·(tr(M)/mh)·I, normalized to Σα = 1.
    M = jnp.einsum("idb,jdb->bij", aa_f, aa_f, precision=_HI)
    tr = jnp.trace(M, axis1=1, axis2=2)
    lam = settings.anderson_reg * tr / mh + 1e-30
    M = M + lam[:, None, None] * jnp.eye(mh, dtype=M.dtype)
    a = jnp.linalg.solve(
        M, jnp.ones((M.shape[0], mh, 1), M.dtype)
    )[..., 0]
    s = jnp.sum(a, axis=1, keepdims=True)
    alpha = a / jnp.where(jnp.abs(s) < 1e-12, 1.0, s)
    v_acc = jnp.einsum("bi,idb->db", alpha, aa_g, precision=_HI)
    bad = (
        ~jnp.isfinite(jnp.max(jnp.abs(v_acc), axis=0))
        | (jnp.abs(s[:, 0]) < 1e-12)
    )
    skip = (st.done | bad)[None, :]
    v_new = jnp.where(skip, v_out, v_acc)

    xn = v_new[:n]
    w = v_new[n:]
    zn = jnp.clip(w, scaled.l, scaled.u)
    yn = st.rho_vec * (w - zn)
    frozen = st.done[None, :]
    xn = jnp.where(frozen, x0, xn)
    zn = jnp.where(frozen, z0, zn)
    yn = jnp.where(frozen, y0, yn)
    st = st.replace(x=xn, z=zn, y=yn)
    v_in_next = jnp.concatenate([xn, zn + yn / st.rho_vec], axis=0)
    return st.replace(
        aa_g=aa_g,
        aa_f=aa_f,
        aa_vin=v_in_next,
        aa_n=jnp.where(st.done, st.aa_n, kept + 1),
        aa_fnorm=jnp.where(st.done, st.aa_fnorm, fnorm),
    )


# ---------------------------------------------------------------------------
# Iteration / termination / adaptation
# ---------------------------------------------------------------------------


def _kkt_solve(scaled, factor, rhs, settings: Settings, rho_vec=None):
    x = scaled.kkt_solve(factor, rhs)
    if settings.kkt_refine and rho_vec is not None:
        for _ in range(settings.kkt_refine):
            resid = rhs - (
                scaled.P_matvec(x)
                + settings.sigma * x
                + scaled.AT_matvec(rho_vec * scaled.A_matvec(x))
            )
            x = x + scaled.kkt_solve(factor, resid)
    return x


def _iteration(scaled, st: LaneADMMState, factor, settings: Settings):
    sigma, alpha = settings.sigma, settings.alpha
    rhs = sigma * st.x - scaled.q + scaled.AT_matvec(st.rho_vec * st.z - st.y)
    xt = _kkt_solve(scaled, factor, rhs, settings, rho_vec=st.rho_vec)
    zt = scaled.A_matvec(xt)

    x_new = alpha * xt + (1.0 - alpha) * st.x
    z_tmp = alpha * zt + (1.0 - alpha) * st.z
    z_new = jnp.clip(z_tmp + st.y / st.rho_vec, scaled.l, scaled.u)
    y_new = st.y + st.rho_vec * (z_tmp - z_new)

    keep = st.done  # (B,) broadcasts against (rows, B)

    def sel(new, old):
        return jnp.where(keep, old, new)

    return st.replace(
        x=sel(x_new, st.x),
        z=sel(z_new, st.z),
        y=sel(y_new, st.y),
        dx=sel(x_new - st.x, st.dx),
        dy=sel(y_new - st.y, st.dy),
        iterations=st.iterations + jnp.where(keep, 0, 1).astype(jnp.int32),
    )


class TermQuantities(NamedTuple):
    """Per-problem (B,) reductions feeding the OSQP termination decision.

    Everything data-dependent the decision needs, produced by
    :func:`_termination_quantities`."""

    prim_res: jnp.ndarray
    dual_res: jnp.ndarray
    prim_norm: jnp.ndarray
    dual_norm: jnp.ndarray
    norm_dy: jnp.ndarray
    norm_dx: jnp.ndarray
    At_dy_max: jnp.ndarray  # ‖Aᵀdy_u‖∞
    support: jnp.ndarray  # Σ u·(dy_u)₊ + l·(dy_u)₋ over tight rows
    loose_dy_pos_max: jnp.ndarray  # max (dy_u)₊ over loose-u rows
    loose_dy_neg_max: jnp.ndarray  # max −(dy_u)₋ over loose-l rows
    P_dx_max: jnp.ndarray  # ‖P dx_u‖∞
    A_dx_max: jnp.ndarray  # max A dx_u over tight-u rows (−inf if none)
    A_dx_min: jnp.ndarray  # min A dx_u over tight-l rows (+inf if none)
    q_dot_dx: jnp.ndarray  # qᵀ dx_u
    blew_up: jnp.ndarray  # bool: iterates went non-finite


def _termination_quantities(
    base, scaled, scaling: Scaling, st: LaneADMMState
) -> TermQuantities:
    """jnp reference path (exactly the historical formulation)."""
    Einv, Dinv, cinv = scaling.Einv, scaling.Dinv, scaling.cinv

    Ax = scaled.A_matvec(st.x)
    Px = scaled.P_matvec(st.x)
    ATy = scaled.AT_matvec(st.y)

    prim_res = _norm0(Einv * (Ax - st.z))
    dual_res = cinv * _norm0(Dinv * (Px + scaled.q + ATy))
    prim_norm = jnp.maximum(_norm0(Einv * Ax), _norm0(Einv * st.z))
    dual_norm = cinv * jnp.maximum(
        jnp.maximum(_norm0(Dinv * Px), _norm0(Dinv * ATy)),
        _norm0(Dinv * scaled.q),
    )

    dy_u = cinv * scaling.E * st.dy
    dx_u = scaling.D * st.dx
    loose_u = base.u >= INF_THRESHOLD
    loose_l = base.l <= -INF_THRESHOLD

    dy_pos = jnp.maximum(dy_u, 0.0)
    dy_neg = jnp.minimum(dy_u, 0.0)
    support = jnp.sum(
        jnp.where(loose_u, 0.0, base.u * dy_pos)
        + jnp.where(loose_l, 0.0, base.l * dy_neg),
        axis=0,
    )
    A_dx = base.A_matvec(dx_u)
    neg_inf = jnp.asarray(-jnp.inf, dx_u.dtype)
    pos_inf = jnp.asarray(jnp.inf, dx_u.dtype)
    return TermQuantities(
        prim_res=prim_res,
        dual_res=dual_res,
        prim_norm=prim_norm,
        dual_norm=dual_norm,
        norm_dy=_norm0(dy_u),
        norm_dx=_norm0(dx_u),
        At_dy_max=_norm0(base.AT_matvec(dy_u)),
        support=support,
        loose_dy_pos_max=jnp.max(jnp.where(loose_u, dy_pos, 0.0), axis=0),
        loose_dy_neg_max=jnp.max(jnp.where(loose_l, -dy_neg, 0.0), axis=0),
        P_dx_max=_norm0(base.P_matvec(dx_u)),
        A_dx_max=jnp.max(jnp.where(loose_u, neg_inf, A_dx), axis=0),
        A_dx_min=jnp.min(jnp.where(loose_l, pos_inf, A_dx), axis=0),
        q_dot_dx=jnp.sum(base.q * dx_u, axis=0),
        blew_up=~jnp.isfinite(
            jnp.sum(st.x, axis=0) + jnp.sum(st.y, axis=0)
        ),
    )


def _termination_decide(
    st: LaneADMMState, tq: TermQuantities, settings: Settings
):
    """Status decision from the reductions (shared by jnp and kernel paths).

    ``all(v ≤ ε)`` over masked rows is expressed as ``max(v over mask) ≤ ε``
    — boolean-equivalent (≤ is monotone; empty mask → vacuous true via the
    0/∓inf initializers)."""
    prim_res, dual_res = tq.prim_res, tq.dual_res
    eps_prim = settings.eps_abs + settings.eps_rel * tq.prim_norm
    eps_dual = settings.eps_abs + settings.eps_rel * tq.dual_norm
    solved = (prim_res <= eps_prim) & (dual_res <= eps_dual)
    solved_inacc = (prim_res <= 10 * eps_prim) & (dual_res <= 10 * eps_dual)

    def prim_inf_at(eps):
        eps_p = eps * tq.norm_dy
        return (
            (tq.norm_dy > eps)
            & (tq.At_dy_max <= eps_p)
            & (tq.support <= -eps_p)
            & (tq.loose_dy_pos_max <= eps_p)
            & (tq.loose_dy_neg_max <= eps_p)
        )

    def dual_inf_at(eps):
        eps_d = eps * tq.norm_dx
        return (
            (tq.norm_dx > eps)
            & (tq.P_dx_max <= eps_d)
            & (tq.q_dot_dx <= -eps_d)
            & (tq.A_dx_max <= eps_d)
            & (tq.A_dx_min >= -eps_d)
        )

    prim_inf = prim_inf_at(settings.eps_prim_inf)
    dual_inf = dual_inf_at(settings.eps_dual_inf)
    # OSQP at max_iter re-checks with 10×-relaxed tolerances (termination.c
    # approximate mode) → the k*InfeasibleInaccurate statuses consumed by the
    # reference's exit-code surface (/root/reference/src/utils.h:11).
    prim_inf_inacc = prim_inf_at(10 * settings.eps_prim_inf)
    dual_inf_inacc = dual_inf_at(10 * settings.eps_dual_inf)

    blew_up = tq.blew_up

    st, stalled = _stall_update(
        st, prim_res, dual_res, eps_prim, eps_dual, settings
    )
    # A stalled problem gives up through the max_iter ladder below — same
    # statuses, fewer wasted iterations (Settings.stall_checks).
    at_max = (st.iterations >= settings.max_iter) | stalled
    new_status = jnp.where(
        blew_up,
        ExitCode.kNonConvex,
        jnp.where(
            solved,
            ExitCode.kOptimal,
            jnp.where(
                prim_inf,
                ExitCode.kPrimalInfeasible,
                jnp.where(
                    dual_inf,
                    ExitCode.kDualInfeasible,
                    jnp.where(
                        at_max,
                        jnp.where(
                            solved_inacc,
                            ExitCode.kOptimalInaccurate,
                            jnp.where(
                                prim_inf_inacc,
                                ExitCode.kPrimalInfeasibleInaccurate,
                                jnp.where(
                                    dual_inf_inacc,
                                    ExitCode.kDualInfeasibleInaccurate,
                                    ExitCode.kMaxIterations,
                                ),
                            ),
                        ),
                        ExitCode.kUnknown,
                    ),
                ),
            ),
        ),
    ).astype(jnp.int32)
    newly_done = solved | prim_inf | dual_inf | at_max | blew_up

    st = st.replace(
        status=jnp.where(st.done, st.status, new_status),
        done=st.done | newly_done,
        prim_res=jnp.where(st.done, st.prim_res, prim_res),
        dual_res=jnp.where(st.done, st.dual_res, dual_res),
    )
    return st, (prim_res, dual_res, tq.prim_norm, tq.dual_norm)


def _termination(
    base, scaled, scaling: Scaling, st: LaneADMMState, settings: Settings
):
    """Per-problem OSQP termination + infeasibility certificates, batch-last
    (mirrors ``admm._termination``; reductions over the row axis)."""
    tq = _termination_quantities(base, scaled, scaling, st)
    return _termination_decide(st, tq, settings)


def _adapt_rho_decision(st: LaneADMMState, norms, settings: Settings):
    prim_res, dual_res, prim_norm, dual_norm = norms
    pr = prim_res / jnp.maximum(prim_norm, DIV_TOL)
    dr = dual_res / jnp.maximum(dual_norm, DIV_TOL)
    new_rho = jnp.clip(
        st.rho_bar * jnp.sqrt(pr / jnp.maximum(dr, DIV_TOL)), RHO_MIN, RHO_MAX
    )
    tol = settings.adaptive_rho_tolerance
    adapt = (~st.done) & (
        (new_rho > tol * st.rho_bar) | (new_rho < st.rho_bar / tol)
    )
    return new_rho, adapt


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def solve_batched_lane(
    qps,
    settings: Settings = Settings(),
    warm_x: Optional[jnp.ndarray] = None,
    warm_y: Optional[jnp.ndarray] = None,
    rho0: Optional[jnp.ndarray] = None,
) -> SolveResult:
    """Batched solve in lane-major layout.

    ``qps``: a :class:`~osqp_solver_tpu.gomp.trajectory_qp_lane.LaneTrajectoryQP`
    (batch-last), or a batch-leading ``TrajectoryQP`` pytree (converted once
    up front).  ``warm_x``/``warm_y`` are batch-leading ``(B, n)``/``(B, m)``
    like :func:`osqp_solver_tpu.ops.admm.solve_batched` takes.  ``rho0``
    (scalar or ``(B,)``, traced) overrides ``settings.rho`` as the initial
    per-problem ρ̄ — OSQP's ``update_rho`` before solve, without recompiling
    per value.  Returns a
    batch-leading :class:`SolveResult` (same contract as ``solve_batched``);
    per-problem adaptive ρ follows the same any-adapt-gated batched refactor.
    Direct KKT backend only (the CG path stays on the vmapped driver).
    """
    from ..gomp.trajectory_qp_lane import LaneTrajectoryQP, to_lane

    if not isinstance(qps, LaneTrajectoryQP):
        qps = to_lane(qps)
    if settings.kkt_method != "direct":
        raise NotImplementedError(
            "solve_batched_lane supports the direct KKT backend only; "
            "use ops.admm.solve_batched for kkt_method='cg'."
        )

    base = qps
    if settings.scaling > 0:
        scaled, scaling = ruiz_equilibrate_lane(base, settings.scaling)
    else:
        scaled, scaling = base, identity_scaling_lane(base)

    wx = None if warm_x is None else jnp.moveaxis(jnp.asarray(warm_x), 0, -1)
    wy = None if warm_y is None else jnp.moveaxis(jnp.asarray(warm_y), 0, -1)
    rb = None
    if rho0 is not None:
        rb = jnp.broadcast_to(
            jnp.asarray(rho0, base.q.dtype), (base.q.shape[-1],)
        )
    result, _ = _solve_core(base, scaled, scaling, settings, wx, wy, rb)
    return result


_FACTOR_ROUND_VALUES = ("none", "f16", "bf16")


def _validate_factor_round(settings: Settings) -> None:
    """Fail fast on an invalid ``factor_round``: a typo'd value would
    otherwise surface as a bare KeyError deep inside ``_round_factor``."""
    if settings.factor_round not in _FACTOR_ROUND_VALUES:
        raise ValueError(
            f"Settings.factor_round={settings.factor_round!r}: allowed "
            f"values are {_FACTOR_ROUND_VALUES}"
        )


def identity_scaling_lane(base) -> Scaling:
    n, B = base.q.shape
    m = base.l.shape[0]
    dtype = base.q.dtype
    one = jnp.ones((B,), dtype)
    ones_n = jnp.ones((n, B), dtype)
    ones_m = jnp.ones((m, B), dtype)
    return Scaling(
        D=ones_n, E=ones_m, c=one, Dinv=ones_n, Einv=ones_m, cinv=one
    )


def _solve_core(
    base, scaled, scaling: Scaling, settings: Settings,
    wx=None, wy=None, rb=None, factor=None,
):
    """Chunked ADMM loop on an already-equilibrated lane problem.

    ``wx``/``wy``: lane-major unscaled warm starts; ``factor``: a cached KKT
    factor consistent with ``rb`` (session fast path).  Each chunk of
    iterations runs as the fused chunk kernel or as XLA ops, as
    :func:`.backend.admm_chunk` decides.  Returns ``(SolveResult,
    (x_lane, y_lane, rho_bar, factor))`` where the second element is the
    lane-major carry a session threads into the next solve.
    """
    from . import admm_fused

    _validate_factor_round(settings)
    use_kernel = backend.admm_chunk(scaled, settings) == backend.TRITON
    coef = admm_fused.build_coef_pack(scaled) if use_kernel else None

    def run_iters(st, factor, n_iter):
        """``n_iter`` iterations on a fixed factor (kept out of the carry);
        each counts only for problems not yet done."""
        if use_kernel:
            x, z, y, dx, dy = admm_fused.fused_admm_chunk(
                scaled, factor, st.x, st.z, st.y, st.rho_vec, st.done,
                settings, n_iter=n_iter, coef=coef,
            )
            return st.replace(
                x=x, z=z, y=y, dx=dx, dy=dy,
                iterations=st.iterations
                + jnp.where(st.done, 0, n_iter).astype(jnp.int32),
            )
        return jax.lax.fori_loop(
            0,
            n_iter,
            lambda i, s: _iteration(
                scaled, s.replace(factor=None), factor, settings
            ),
            st.replace(factor=None),
        ).replace(factor=st.factor)

    def fresh_factor(rho_vec_arr):
        f = scaled.kkt_factor(rho_vec_arr, settings.sigma)
        return _round_factor(f, settings.factor_round)

    if rb is None:
        rb = jnp.full((base.q.shape[-1],), settings.rho, base.q.dtype)
    rho_vec0 = _rho_vec(rb, scaled.l, scaled.u)
    if factor is None:
        factor = fresh_factor(rho_vec0)
    st = init_state_lane(
        scaled, settings, wx, wy, scaling,
        rho_bar=rb, rho_vec=rho_vec0, factor=factor,
    )

    def cond(st):
        return jnp.any((~st.done) & (st.iterations < settings.max_iter))

    # Cold solves of a known class never converge before a known floor, so
    # the first ``termination_warmup`` iterations run as the loop's first
    # chunk with no check after it (the early checks' fixed costs are
    # skipped).  Its iteration count is a runtime value, so one chunk call
    # site (one compiled kernel) serves the whole solve.  Warm-started
    # sessions should keep termination_warmup=0.
    warmup = min(settings.termination_warmup, settings.max_iter)

    def anderson_input(st):
        return jnp.concatenate([st.x, st.z + st.y / st.rho_vec], axis=0)

    if settings.anderson > 0:
        # Anderson-acceleration carry: ring history of chunk-map outputs /
        # residuals on v = (x, w = z + y/ρ), the current chunk's input, and
        # the safeguard norm (see _anderson_step).
        v0 = anderson_input(st)
        B_ = v0.shape[-1]
        st = st.replace(
            aa_g=jnp.zeros((settings.anderson,) + v0.shape, v0.dtype),
            aa_f=jnp.zeros((settings.anderson,) + v0.shape, v0.dtype),
            aa_vin=v0,
            aa_n=jnp.zeros((B_,), jnp.int32),
            aa_fnorm=jnp.full((B_,), jnp.inf, v0.dtype),
        )

    def check(st):
        """Termination, ρ adaptation and the Anderson step after a chunk."""
        st, norms = _termination(base, scaled, scaling, st, settings)
        aa_reset = jnp.zeros_like(st.done)
        if settings.adaptive_rho:
            interval = max(
                settings.adaptive_rho_interval, settings.check_termination
            )
            at_interval = (st.iterations % interval) < settings.check_termination
            new_rho, adapt = _adapt_rho_decision(st, norms, settings)
            adapt = adapt & at_interval

            def do_adapt(st):
                rho_bar = jnp.where(adapt, new_rho, st.rho_bar)
                rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
                st = st.replace(
                    rho_bar=rho_bar,
                    rho_vec=rho_vec,
                    factor=fresh_factor(rho_vec),
                )
                return _stall_reset(st, adapt, settings)

            st = jax.lax.cond(jnp.any(adapt), do_adapt, lambda s: s, st)
            aa_reset = adapt  # w = z + y/ρ changes scale under the new ρ
        if settings.anderson > 0:
            st = _anderson_step(scaled, st, settings, aa_reset)
        return st

    def after_warmup(st):
        if settings.anderson > 0:
            st = st.replace(aa_vin=anderson_input(st))
        return st

    def chunk(carry):
        st, first = carry
        if warmup > 0:
            n = jnp.where(first, warmup, settings.check_termination)
            st = run_iters(st, st.factor, n)
            st = jax.lax.cond(first, after_warmup, check, st)
        else:
            st = check(run_iters(st, st.factor, settings.check_termination))
        return st, jnp.zeros((), bool)

    st, _ = jax.lax.while_loop(
        lambda c: cond(c[0]), chunk, (st, jnp.asarray(warmup > 0))
    )
    if settings.polish:
        st = _polish(base, scaled, scaling, st, settings)
    carry = (
        scaling.D * st.x,
        scaling.cinv * scaling.E * st.y,
        st.rho_bar,
        st.factor,
    )
    return _finalize(base, scaling, st), carry


def _polish(base, scaled, scaling: Scaling, st: LaneADMMState, settings: Settings):
    """Lane-major OSQP-style polish (mirrors ``admm.polish``)."""
    delta = settings.polish_delta
    z_u = scaling.Einv * st.z
    y_u = scaling.cinv * scaling.E * st.y
    l_u = scaling.Einv * scaled.l
    u_u = scaling.Einv * scaled.u
    act_low = (z_u - l_u) < -y_u
    act_upp = (u_u - z_u) < y_u
    active = act_low | act_upp
    z_target = jnp.where(act_low, scaled.l, jnp.where(act_upp, scaled.u, st.z))
    rho_pol = jnp.where(active, 1.0 / delta, delta)

    factor = scaled.kkt_factor(rho_pol, settings.sigma)
    rhs = -scaled.q + scaled.AT_matvec(rho_pol * z_target)
    x = scaled.kkt_solve(factor, rhs)
    for _ in range(settings.polish_refine_iter):
        resid = rhs - (
            scaled.P_matvec(x)
            + settings.sigma * x
            + scaled.AT_matvec(rho_pol * scaled.A_matvec(x))
        )
        x = x + scaled.kkt_solve(factor, resid)
    Ax = scaled.A_matvec(x)
    y = jnp.where(active, rho_pol * (Ax - z_target), 0.0)
    z = jnp.where(active, z_target, Ax)

    prim = _norm0(scaling.Einv * (Ax - z))
    dual = scaling.cinv * _norm0(
        scaling.Dinv * (scaled.P_matvec(x) + scaled.q + scaled.AT_matvec(y))
    )
    better = (prim <= st.prim_res) & (dual <= st.dual_res) & (
        st.status == ExitCode.kOptimal
    )
    sel = lambda new, old: jnp.where(better, new, old)
    return st.replace(
        x=sel(x, st.x),
        z=sel(z, st.z),
        y=sel(y, st.y),
        prim_res=sel(prim, st.prim_res),
        dual_res=sel(dual, st.dual_res),
    )


def _finalize(base, scaling: Scaling, st: LaneADMMState) -> SolveResult:
    """Unscale and package a batch-leading :class:`SolveResult`."""
    x = scaling.D * st.x
    y = scaling.cinv * scaling.E * st.y
    z = scaling.Einv * st.z
    status = jnp.where(
        st.done, st.status, jnp.full_like(st.status, ExitCode.kMaxIterations)
    )
    obj = 0.5 * jnp.sum(x * base.P_matvec(x), axis=0) + jnp.sum(
        base.q * x, axis=0
    )
    return SolveResult(
        x=x.T,
        y=y.T,
        z=z.T,
        status=status,
        iterations=st.iterations,
        prim_res=st.prim_res,
        dual_res=st.dual_res,
        rho=st.rho_bar,
        obj_val=obj,
    )
