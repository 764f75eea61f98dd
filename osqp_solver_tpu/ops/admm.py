"""OSQP-semantics ADMM core.

Re-implements the capability of the OSQP C solver the reference drives through
``osqp-cpp`` (``/root/reference/src/osqp-wrapper.h:16-54``; algorithm per
SURVEY.md §2.2): Ruiz equilibration, σ/ρ-regularized reduced-KKT solve, box
projection, over-relaxed dual update, per-constraint ρ with adaptation,
residual-based termination at OSQP-default tolerances, and primal/dual
infeasibility certificates — but as a *fixed-shape, functional* JAX loop:

* state is a pytree (:class:`ADMMState`); the loop is a ``lax.while_loop``
  over chunks of ``check_termination`` iterations;
* a ``done`` mask freezes converged problems so the solver ``vmap``s into a
  batched solver with masked convergence (SURVEY.md §2.3 batch parallelism);
* the KKT factor is carried in-state and refactorized only when ρ adapts
  (mirroring OSQP's cached qdldl factorization, ``osqp-wrapper.h:33-43``).

No data-dependent Python control flow: everything composes with ``jit``,
``vmap``, ``shard_map``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from .. import struct

from .ruiz import Scaling, identity_scaling, ruiz_equilibrate
from .status import ExitCode

# OSQP internal constants.
RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_FACTOR = 1e3  # rho multiplier for equality rows
RHO_TOL = 1e-4  # |u - l| below this (scaled) => equality row
INF_THRESHOLD = 1e25
DIV_TOL = 1e-10


@dataclasses.dataclass(frozen=True)
class Settings:
    """OSQP-default settings (the reference never overrides them except
    ``verbose``, ``osqp-wrapper.h:26-27``).

    ``adaptive_rho_interval`` deviates from OSQP's wall-clock heuristic
    (meaningless under jit): ρ is re-evaluated every this-many iterations.
    """

    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    max_iter: int = 4000
    check_termination: int = 25
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 50
    adaptive_rho_tolerance: float = 5.0
    scaling: int = 10  # Ruiz iterations; 0 disables
    # KKT backend: "direct" = cached block/dense Cholesky (qdldl analogue),
    # "cg" = matrix-free preconditioned CG on the reduced system (indirect
    # analogue; no factorization — for problems whose factors don't fit).
    kkt_method: str = "direct"
    cg_tol: float = 1e-7
    cg_max_iter: int = 100
    # Iterative-refinement steps after each direct KKT solve (0 = off).
    # One step recovers near-f64 solve accuracy in f32 for ill-conditioned
    # KKT systems at the cost of one extra matvec + back-substitution.
    kkt_refine: int = 0
    # Solution polishing (OSQP `polish`, default off there too): after
    # convergence, re-solve with active constraints pinned (huge ρ on the
    # dual-active rows, tiny elsewhere — the penalty form of the active-set
    # KKT) + refinement; adopted only if it improves both residuals.
    polish: bool = False
    polish_delta: float = 1e-6
    polish_refine_iter: int = 3
    # Unroll factor for the vmapped driver's inner (per-chunk) iteration
    # loop.  The best factor is problem-dependent; sweep per deployment.
    inner_unroll: int = 1
    # Fused ADMM chunk kernel (ops/admm_fused.py, Pallas through Triton):
    # "auto" = wherever ops/backend.py finds it runs and implements the
    # problem and settings; "on" = demand it (ValueError where it cannot
    # run); "off" = always the XLA path.
    fused_chunk: str = "auto"
    # Safeguarded Anderson acceleration of the chunk fixed-point map
    # (lane driver only; SCS 3.0 ships the same scheme in production —
    # PAPERS.md "Trajectory of ADMM and Adaptive Acceleration").  Between
    # chunks of ``check_termination`` iterations, the iterate
    # v = (x, w = z + y/ρ) is extrapolated from the last ``anderson``
    # chunk outputs by a tiny per-problem constrained least squares;
    # z/y are recovered consistently (z = Π_[l,u](w), y = ρ(w − z)), so
    # termination still evaluates TRUE residuals — an accepted solution is
    # optimal-to-tolerance regardless of how it was reached.  History
    # resets per problem when the residual grows past
    # ``anderson_safeguard``× the previous chunk's or when ρ adapts.
    # 0 disables (the OSQP-parity default).
    anderson: int = 0
    anderson_reg: float = 1e-8
    anderson_safeguard: float = 1.5
    # Reduced-precision factor values (lane driver): every factor (setup
    # and ρ-adaptation refactors) is rounded through a 2-byte dtype and
    # back, so the solve sees exactly the values a 2-byte factor would
    # hold.  "none" (default), "f16" or "bf16".  Polish keeps its own
    # full-precision factor.  A full "f16" solve converges but needs
    # several times the iterations of a full-precision one.
    factor_round: str = "none"
    # Run the first this-many iterations as ONE unchecked chunk before the
    # ``check_termination`` cadence starts (lane driver).  Cold solves of a
    # known class never converge before a known floor (the honest GOMP
    # class needs ≥22), so a warmup chunk skips the early checks' fixed
    # costs (chunk dispatch, termination reductions, decide/cond) while
    # executed-iteration counts stay those of the cadence.  0 disables;
    # keep 0 for warm-started sessions (re-solves converge in a few
    # iterations).
    termination_warmup: int = 0
    # In-solver stall detection (beyond OSQP, default ON — set
    # ``stall_checks=0`` for exact OSQP give-up semantics).  The residual
    # metric max(prim_res/eps_prim, dual_res/eps_dual) — how many × the
    # iterate misses the current tolerances — is tracked across termination
    # checks: whenever it improves by ``stall_rtol`` (relative) over the
    # window reference, the window re-arms; after ``stall_checks``
    # consecutive checks WITHOUT such an improvement the problem exits
    # early through the SAME ladder max_iter uses (10×-relaxed re-check →
    # kOptimalInaccurate / k*InfeasibleInaccurate / kMaxIterations), so
    # downstream status consumers see max_iter semantics, just without
    # grinding out the remaining iterations.  ρ adaptation re-arms the
    # window (residual trajectories legitimately restart).  Motivation
    # (BASELINE.md round-4 decomposition): the default-settings full
    # time-scaling search burns 91% of its ADMM iterations in ONE
    # never-certifying marginal segment that plateaus to max_iter=4000;
    # stall detection gives OSQP-default users the capped-row throughput
    # with no knob.  Defaults: 12 checks × check_termination=25 ⇒ a
    # problem must improve 5% per ≤300 iterations to keep running — a
    # problem that cannot do that cannot traverse the remaining decades
    # to certify by 4000 either.  The native oracle implements the same
    # rule behind the same parameters, so status-for-status
    # cross-validation covers the stall path too.
    stall_checks: int = 12
    stall_rtol: float = 0.05
    # Patience floor in ITERATIONS: the window above is counted in checks,
    # so an aggressive cadence (check_termination=1-3) would silently
    # shrink it to a dozen iterations and give up on legitimately slow
    # mid-convergence plateaus.  Stall therefore needs BOTH
    # ``stall_checks`` consecutive no-progress checks AND a window of at
    # least ``stall_min_iters`` iterations — effective checks =
    # max(stall_checks, ceil(stall_min_iters / check_termination))
    # (:func:`stall_checks_needed`; same floor in the native oracle).  36
    # = 12 checks x the fleet cadence ct=3, so every published ct>=3
    # measurement is unchanged, while ct=1 users get a 36-iteration window
    # instead of 12 (every converging segment of the benchmark class needs
    # <=48 iterations total, so 36 without ANY 5% improvement is already
    # decisive; a longer floor only grinds more iterations on segments
    # that will not certify).
    stall_min_iters: int = 36


def refine_steps_for_horizon(waypoints: int, dtype) -> int:
    """Auto-policy for f32 long horizons.

    Long-horizon f32 accuracy rests on exact f32 accumulation in the scan
    block-Cholesky/solve (``ops/tridiag.py`` ``_HI``): a reduced-precision
    matmul there accumulates error over W steps until the factor loses
    positive definiteness.  With it pinned, W=802 f32 converges with zero
    refinement on the CPU exact-count harness, like the f64 oracle.
    Refinement is kept only as a safety margin beyond that range."""
    if jnp.dtype(dtype) == jnp.dtype(jnp.float64):
        return 0
    if waypoints > 1024:
        return 1
    return 0


def with_auto_refine(settings: Settings, waypoints: int, dtype) -> Settings:
    """Bump ``kkt_refine`` per the long-horizon policy (never lowers an
    explicit user setting)."""
    auto = refine_steps_for_horizon(waypoints, dtype)
    if auto > settings.kkt_refine:
        return dataclasses.replace(settings, kkt_refine=auto)
    return settings


@struct.dataclass
class ADMMState:
    x: jnp.ndarray  # scaled primal iterate (n,)
    z: jnp.ndarray  # scaled constraint iterate (m,)
    y: jnp.ndarray  # scaled dual iterate (m,)
    dx: jnp.ndarray  # last-iteration deltas (for infeasibility certificates)
    dy: jnp.ndarray
    rho_bar: jnp.ndarray  # scalar ρ
    rho_vec: jnp.ndarray  # per-row ρ (m,)
    factor: object  # cached KKT factor pytree
    iterations: jnp.ndarray  # int32
    status: jnp.ndarray  # int32 ExitCode
    done: jnp.ndarray  # bool — frozen problems stop updating
    prim_res: jnp.ndarray
    dual_res: jnp.ndarray
    # Stall-detection carry (Settings.stall_checks > 0; None otherwise).
    stall_ref: Optional[jnp.ndarray] = None  # window-reference residual metric
    stall_k: Optional[jnp.ndarray] = None  # int32 checks since the window armed


@struct.dataclass
class SolveResult:
    """Structured per-problem solve output (replaces the reference's
    exit-code + printf observability, SURVEY.md §5)."""

    x: jnp.ndarray  # primal solution (unscaled)
    y: jnp.ndarray  # dual solution (unscaled)
    z: jnp.ndarray  # Ax at the solution (unscaled)
    status: jnp.ndarray  # int32 ExitCode
    iterations: jnp.ndarray
    prim_res: jnp.ndarray
    dual_res: jnp.ndarray
    rho: jnp.ndarray
    obj_val: jnp.ndarray


def _rho_vec(rho_bar, l, u):
    """Per-constraint ρ (OSQP semantics): equality rows get 1e3·ρ, loose rows
    get RHO_MIN."""
    loose = (l <= -INF_THRESHOLD) & (u >= INF_THRESHOLD)
    eq = (u - l) < RHO_TOL
    rho = jnp.where(eq, RHO_EQ_FACTOR * rho_bar, rho_bar)
    rho = jnp.where(loose, RHO_MIN, rho)
    return jnp.clip(rho, RHO_MIN, RHO_MAX)


def _inf_norm(v):
    return jnp.max(jnp.abs(v)) if v.shape[-1] else jnp.zeros(())


# --- collective-aware reductions -------------------------------------------
# A QP container living inside ``shard_map`` (e.g. the horizon-sharded
# ``parallel.banded.ShardedBandedQP``) exposes ``collective_axis``; all
# scalar reductions in the solver then combine across the mesh axis so every
# device sees identical residuals/certificates/decisions.  Payload: O(1)
# scalars per termination check.


def _qp_axis(qp):
    return getattr(qp, "collective_axis", None)


def _g_inf_norm(qp, v):
    r = _inf_norm(v)
    ax = _qp_axis(qp)
    return jax.lax.pmax(r, ax) if ax else r


def _g_max(qp, v):
    """Global max of a (possibly signed) vector — no abs, for cone checks."""
    r = jnp.max(v)
    ax = _qp_axis(qp)
    return jax.lax.pmax(r, ax) if ax else r


def _g_sum(qp, v):
    s = jnp.sum(v) if v.shape[-1] else jnp.zeros(())
    ax = _qp_axis(qp)
    return jax.lax.psum(s, ax) if ax else s


def _g_all(qp, b):
    """Global AND of a traced bool scalar."""
    ax = _qp_axis(qp)
    if not ax:
        return b
    return jax.lax.psum(jnp.where(b, 0, 1), ax) == 0


def kkt_factor(qp, rho_vec, sigma, settings: Settings):
    """Backend-dispatching KKT "factorization": direct Cholesky, or the
    (ρ, σ) snapshot for the matrix-free CG backend."""
    if settings.kkt_method == "cg":
        return (rho_vec, jnp.asarray(sigma, qp.q.dtype))
    return qp.kkt_factor(rho_vec, sigma)


def kkt_solve(qp, factor, rhs, settings: Settings, rho_vec=None):
    if settings.kkt_method == "cg":
        from .cg import cg_solve

        rho_vec_f, sigma = factor
        return cg_solve(
            qp, rho_vec_f, sigma, rhs,
            tol=settings.cg_tol, max_iter=settings.cg_max_iter,
        ).x
    x = qp.kkt_solve(factor, rhs)
    if settings.kkt_refine and rho_vec is not None:
        for _ in range(settings.kkt_refine):
            resid = rhs - (
                qp.P_matvec(x)
                + settings.sigma * x
                + qp.AT_matvec(rho_vec * qp.A_matvec(x))
            )
            x = x + qp.kkt_solve(factor, resid)
    return x


def _admm_iteration(scaled, st: ADMMState, settings: Settings) -> ADMMState:
    """One scaled ADMM iteration (OSQP §alg1; SURVEY.md §3.4):
    x̃ = K⁻¹(σx − q + Aᵀ(ρz − y)); z̃ = Ax̃; over-relax; project; dual update."""
    sigma = settings.sigma
    alpha = settings.alpha

    rhs = sigma * st.x - scaled.q + scaled.AT_matvec(st.rho_vec * st.z - st.y)
    xt = kkt_solve(scaled, st.factor, rhs, settings, rho_vec=st.rho_vec)
    zt = scaled.A_matvec(xt)

    x_new = alpha * xt + (1.0 - alpha) * st.x
    z_tmp = alpha * zt + (1.0 - alpha) * st.z
    z_new = jnp.clip(z_tmp + st.y / st.rho_vec, scaled.l, scaled.u)
    y_new = st.y + st.rho_vec * (z_tmp - z_new)

    # Masked convergence: frozen problems keep their iterates.
    keep = st.done

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


def stall_checks_needed(settings) -> int:
    """Effective consecutive-no-progress-check threshold: ``stall_checks``
    floored so the window spans at least ``stall_min_iters`` iterations at
    the configured termination cadence (checks happen every
    ``check_termination`` iterations)."""
    ct = max(1, int(settings.check_termination))
    return max(
        int(settings.stall_checks), -(-int(settings.stall_min_iters) // ct)
    )


def _stall_update(st, prim_res, dual_res, eps_prim, eps_dual, settings):
    """Windowed no-progress detector (``Settings.stall_checks``), shared by
    the vmapped (:func:`_termination`) and lane
    (:func:`admm_lane._termination_decide`) paths — shapes follow the
    state's ((,) or (B,)).

    Returns ``(state-with-updated-window, stalled)``; the caller folds
    ``stalled`` into its ``at_max`` branch so a stalled problem exits with
    exactly the status max_iter would produce."""
    if settings.stall_checks <= 0 or st.stall_ref is None:
        return st, jnp.zeros_like(st.done)
    tiny = jnp.asarray(1e-30, prim_res.dtype)
    metric = jnp.maximum(
        prim_res / jnp.maximum(eps_prim, tiny),
        dual_res / jnp.maximum(eps_dual, tiny),
    )
    improved = metric < (1.0 - settings.stall_rtol) * st.stall_ref
    stall_k = jnp.where(improved, 0, st.stall_k + 1).astype(jnp.int32)
    stall_ref = jnp.where(improved, metric, st.stall_ref)
    stalled = (~st.done) & (stall_k >= stall_checks_needed(settings))
    return (
        st.replace(
            stall_ref=jnp.where(st.done, st.stall_ref, stall_ref),
            stall_k=jnp.where(st.done, st.stall_k, stall_k),
        ),
        stalled,
    )


def _stall_reset(st, mask, settings: Settings):
    """Re-arm the stall window where ``mask`` (ρ adapted there)."""
    if settings.stall_checks <= 0 or st.stall_ref is None:
        return st
    return st.replace(
        stall_ref=jnp.where(mask, jnp.inf, st.stall_ref),
        stall_k=jnp.where(mask, 0, st.stall_k).astype(jnp.int32),
    )


def _stall_init(settings: Settings, dtype, shape=()):
    """Initial (stall_ref, stall_k) carry — ``(None, None)`` when off."""
    if settings.stall_checks <= 0:
        return None, None
    return (
        jnp.full(shape, jnp.inf, dtype),
        jnp.zeros(shape, jnp.int32),
    )


def _termination(base, scaled, scaling: Scaling, st: ADMMState, settings: Settings):
    """Unscaled residuals, OSQP termination + infeasibility certificates.

    Returns updated state with ``done``/``status``/residuals set, plus the
    normalization terms used for ρ adaptation.
    """
    Einv, Dinv, cinv = scaling.Einv, scaling.Dinv, scaling.cinv
    m = st.z.shape[-1]

    Ax = scaled.A_matvec(st.x)
    Px = scaled.P_matvec(st.x)
    ATy = scaled.AT_matvec(st.y)

    prim_res = _g_inf_norm(scaled, Einv * (Ax - st.z))
    dual_res = cinv * _g_inf_norm(scaled, Dinv * (Px + scaled.q + ATy))
    prim_norm = jnp.maximum(
        _g_inf_norm(scaled, Einv * Ax), _g_inf_norm(scaled, Einv * st.z)
    )
    dual_norm = cinv * jnp.maximum(
        jnp.maximum(
            _g_inf_norm(scaled, Dinv * Px), _g_inf_norm(scaled, Dinv * ATy)
        ),
        _g_inf_norm(scaled, Dinv * scaled.q),
    )

    eps_prim = settings.eps_abs + settings.eps_rel * prim_norm
    eps_dual = settings.eps_abs + settings.eps_rel * dual_norm
    solved = (prim_res <= eps_prim) & (dual_res <= eps_dual)
    # 10x-relaxed tolerances — OSQP's "solved inaccurate" at max_iter.
    solved_inacc = (prim_res <= 10 * eps_prim) & (dual_res <= 10 * eps_dual)
    if m == 0:
        solved = dual_res <= eps_dual
        solved_inacc = dual_res <= 10 * eps_dual

    # --- infeasibility certificates on unscaled deltas ----------------------
    dy_u = cinv * scaling.E * st.dy
    dx_u = scaling.D * st.dx
    norm_dy = _g_inf_norm(base, dy_u)
    norm_dx = _g_inf_norm(base, dx_u)

    loose_u = base.u >= INF_THRESHOLD
    loose_l = base.l <= -INF_THRESHOLD

    # Primal infeasibility: Aᵀδy ≈ 0 and the support function of [l,u] at δy
    # is negative (OSQP §3.4 with eps_prim_inf tolerances).  The reductions
    # are computed once; the decision is evaluated at the strict tolerance
    # every check and at the 10×-relaxed tolerance at max_iter (OSQP
    # termination.c "approximate" mode → k*InfeasibleInaccurate statuses,
    # the enum surface the reference consumes at utils.h:11).
    At_dy_max = _g_inf_norm(base, base.AT_matvec(dy_u))
    dy_pos = jnp.maximum(dy_u, 0.0)
    dy_neg = jnp.minimum(dy_u, 0.0)
    support = _g_sum(
        base,
        jnp.where(loose_u, 0.0, base.u * dy_pos)
        + jnp.where(loose_l, 0.0, base.l * dy_neg),
    ) if m else jnp.zeros(())
    # max over loose rows of the outward δy component (vacuous 0 if none):
    # ``all(v ≤ ε over mask)`` ⇔ ``max(v over mask, init 0) ≤ ε`` for ε ≥ 0.
    loose_dy_pos_max = _g_inf_norm(
        base, jnp.where(loose_u, dy_pos, 0.0)
    ) if m else jnp.zeros(())
    loose_dy_neg_max = _g_inf_norm(
        base, jnp.where(loose_l, -dy_neg, 0.0)
    ) if m else jnp.zeros(())

    def prim_inf_at(eps):
        # OSQP guards the certificate with an *absolute* δy-magnitude
        # threshold (is_primal_infeasible): near convergence δy is numerical
        # noise that can wander in null(Aᵀ) and must not trigger a spurious
        # certificate.
        if not m:
            return jnp.array(False)
        eps_p = eps * norm_dy
        return (
            (norm_dy > eps)
            & (At_dy_max <= eps_p)
            & (support <= -eps_p)
            & (loose_dy_pos_max <= eps_p)
            & (loose_dy_neg_max <= eps_p)
        )

    prim_inf = prim_inf_at(settings.eps_prim_inf)
    prim_inf_inacc = prim_inf_at(10 * settings.eps_prim_inf)

    # Dual infeasibility: Pδx ≈ 0, qᵀδx < 0, Aδx in the recession cone.
    P_dx_max = _g_inf_norm(base, base.P_matvec(dx_u))
    q_dot_dx = _g_sum(base, base.q * dx_u)
    if m:
        A_dx = base.A_matvec(dx_u)
        neg_inf = jnp.asarray(-jnp.inf, dx_u.dtype)
        A_dx_tight_u_max = _g_max(base, jnp.where(loose_u, neg_inf, A_dx))
        A_dx_tight_l_min = -_g_max(base, jnp.where(loose_l, neg_inf, -A_dx))

    def dual_inf_at(eps):
        eps_d = eps * norm_dx
        cone_ok = (
            (A_dx_tight_u_max <= eps_d) & (A_dx_tight_l_min >= -eps_d)
            if m
            else jnp.array(True)
        )
        return (
            (norm_dx > eps)
            & (P_dx_max <= eps_d)
            & (q_dot_dx <= -eps_d)
            & cone_ok
        )

    dual_inf = dual_inf_at(settings.eps_dual_inf)
    dual_inf_inacc = dual_inf_at(10 * settings.eps_dual_inf)

    # Failure detection (SURVEY.md §5): a diverged/NaN iterate marks the
    # problem kNonConvex (the practical analogue of OSQP's non-convexity
    # abort) instead of raising — batched siblings keep solving.
    blew_up = ~jnp.isfinite(_g_sum(base, st.x) + _g_sum(base, st.y))

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
                    # OSQP at max_iter re-checks with 10×-relaxed tolerances
                    # (termination.c approximate mode), in this order.
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
    return st, (prim_res, dual_res, prim_norm, dual_norm)


def _adapt_rho_decision(st: ADMMState, norms, settings: Settings):
    """OSQP adaptive-ρ decision: candidate ρ from the sqrt residual ratio,
    and whether it moved by more than ``adaptive_rho_tolerance``."""
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


def _adapt_rho(scaled, st: ADMMState, norms, settings: Settings) -> ADMMState:
    """Single-problem adaptive ρ: refactorize the KKT when ρ moves."""
    new_rho, adapt = _adapt_rho_decision(st, norms, settings)

    def do_adapt(st):
        rho_bar = new_rho
        rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
        factor = kkt_factor(scaled, rho_vec, settings.sigma, settings)
        st = st.replace(rho_bar=rho_bar, rho_vec=rho_vec, factor=factor)
        return _stall_reset(st, jnp.array(True), settings)

    return jax.lax.cond(adapt, do_adapt, lambda s: s, st)


def init_state(
    scaled,
    settings: Settings,
    warm_x: Optional[jnp.ndarray] = None,
    warm_y: Optional[jnp.ndarray] = None,
    scaling: Optional[Scaling] = None,
    rho_bar: Optional[jnp.ndarray] = None,
    factor=None,
) -> ADMMState:
    """Cold (x=z=y=0) or warm-started scaled state + initial KKT factor.

    ``warm_x``/``warm_y`` are *unscaled* (user-space) vectors — mirrors
    ``SetPrimalWarmStart`` (``osqp-wrapper.h:45-49``); on warm start
    ``z = A x`` so dynamics-consistent trajectories start feasible.
    """
    dtype = scaled.q.dtype
    n = scaled.q.shape[-1]
    m = scaled.l.shape[-1]
    if scaling is None:
        scaling = identity_scaling(n, m, dtype)
    if warm_x is None:
        x = jnp.zeros(n, dtype)
        z = jnp.zeros(m, dtype)
    else:
        x = scaling.Dinv * jnp.asarray(warm_x, dtype)
        z = scaled.A_matvec(x)
    if warm_y is None:
        y = jnp.zeros(m, dtype)
    else:
        y = scaling.c * scaling.Einv * jnp.asarray(warm_y, dtype)

    if rho_bar is None:
        rho_bar = jnp.asarray(settings.rho, dtype)
    rho_vec = _rho_vec(rho_bar, scaled.l, scaled.u)
    if factor is None:
        # Mirrors OSQP's setup-time KKT factorization; pass a cached factor
        # to reuse it across MPC re-solves (osqp-wrapper.h:33-43 semantics:
        # bounds-only updates do not refactorize).
        factor = kkt_factor(scaled, rho_vec, settings.sigma, settings)
    stall_ref, stall_k = _stall_init(settings, dtype)
    return ADMMState(
        x=x,
        z=z,
        y=y,
        dx=jnp.zeros(n, dtype),
        dy=jnp.zeros(m, dtype),
        rho_bar=rho_bar,
        rho_vec=rho_vec,
        factor=factor,
        iterations=jnp.zeros((), jnp.int32),
        status=jnp.full((), ExitCode.kUnknown, jnp.int32),
        done=jnp.zeros((), bool),
        prim_res=jnp.full((), jnp.inf, dtype),
        dual_res=jnp.full((), jnp.inf, dtype),
        stall_ref=stall_ref,
        stall_k=stall_k,
    )


def run_admm(base, scaled, scaling: Scaling, st: ADMMState, settings: Settings) -> ADMMState:
    """Run the chunked ADMM loop to termination (all problems done or
    ``max_iter``)."""

    def cond(st):
        return (~st.done) & (st.iterations < settings.max_iter)

    def chunk(st):
        # The factor is constant within a chunk (ρ adapts only at chunk
        # boundaries).  Keep it OUT of the fori_loop carry and close over it
        # instead, so loop-invariant work derived from it is hoisted out of
        # the loop.
        factor = st.factor
        st = jax.lax.fori_loop(
            0,
            settings.check_termination,
            lambda i, s: _admm_iteration(
                scaled, s.replace(factor=factor), settings
            ).replace(factor=None),
            st.replace(factor=None),
            unroll=settings.inner_unroll,
        ).replace(factor=factor)
        st, norms = _termination(base, scaled, scaling, st, settings)
        if settings.adaptive_rho:
            interval = max(
                settings.adaptive_rho_interval, settings.check_termination
            )
            do = (st.iterations % interval) < settings.check_termination
            st = jax.lax.cond(
                do,
                lambda s: _adapt_rho(scaled, s, norms, settings),
                lambda s: s,
                st,
            )
        return st

    return jax.lax.while_loop(cond, chunk, st)


def polish(base, scaled, scaling: Scaling, st: ADMMState, settings: Settings) -> ADMMState:
    """OSQP-style solution polishing (OSQP ``polish.c`` semantics, penalty
    form): pin the dual-active constraints (ȳ<0 → lower bound, ȳ>0 → upper)
    by solving ``(P+σI+Aᵀdiag(ρ_pol)A) x = −q + Aᵀ(ρ_pol·z_act)`` with huge
    ρ on active rows and tiny elsewhere, plus iterative refinement; the
    polished iterate is adopted only where it improves both residuals."""
    delta = settings.polish_delta
    # OSQP polish.c active-set guess: a bound is active when the slack is
    # smaller than the dual magnitude pointing into it.  polish.c classifies
    # on UNSCALED data — undo the Ruiz scaling (z_u = E⁻¹z, y_u = c⁻¹Ey)
    # before the comparison so per-row E²/c factors don't skew the guess.
    z_u = scaling.Einv * st.z
    y_u = scaling.cinv * scaling.E * st.y
    l_u = scaling.Einv * scaled.l
    u_u = scaling.Einv * scaled.u
    act_low = (z_u - l_u) < -y_u
    act_upp = (u_u - z_u) < y_u
    active = act_low | act_upp
    z_target = jnp.where(act_low, scaled.l, jnp.where(act_upp, scaled.u, st.z))
    rho_pol = jnp.where(active, 1.0 / delta, delta)

    factor = kkt_factor(scaled, rho_pol, settings.sigma, settings)
    rhs = -scaled.q + scaled.AT_matvec(rho_pol * z_target)
    x = kkt_solve(scaled, factor, rhs, settings)
    for _ in range(settings.polish_refine_iter):
        resid = rhs - (
            scaled.P_matvec(x)
            + settings.sigma * x
            + scaled.AT_matvec(rho_pol * scaled.A_matvec(x))
        )
        x = x + kkt_solve(scaled, factor, resid, settings)
    Ax = scaled.A_matvec(x)
    y = jnp.where(active, rho_pol * (Ax - z_target), 0.0)
    z = jnp.where(active, z_target, Ax)

    # Unscaled residuals of the polished iterate.
    prim = _g_inf_norm(scaled, scaling.Einv * (Ax - z))
    dual = scaling.cinv * _g_inf_norm(
        scaled,
        scaling.Dinv * (scaled.P_matvec(x) + scaled.q + scaled.AT_matvec(y)),
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


def solve(
    qp,
    settings: Settings = Settings(),
    warm_x: Optional[jnp.ndarray] = None,
    warm_y: Optional[jnp.ndarray] = None,
) -> SolveResult:
    """Solve one QP end-to-end: equilibrate → ADMM → unscale.

    Jit/vmap-friendly: ``jax.vmap(lambda qp: solve(qp, s))(batched_qp)`` gives
    the batched solver with masked convergence (BASELINE config 2).
    """
    if settings.scaling > 0:
        scaled, scaling = ruiz_equilibrate(qp, settings.scaling)
    else:
        scaled, scaling = qp, identity_scaling(
            qp.q.shape[-1], qp.l.shape[-1], qp.q.dtype
        )
    st = init_state(scaled, settings, warm_x, warm_y, scaling)
    st = run_admm(qp, scaled, scaling, st, settings)
    if settings.polish:
        st = polish(qp, scaled, scaling, st, settings)
    return finalize(qp, scaling, st)


def solve_batched(
    qps,
    settings: Settings = Settings(),
    warm_x: Optional[jnp.ndarray] = None,
    warm_y: Optional[jnp.ndarray] = None,
) -> SolveResult:
    """Batched solve with **per-problem adaptive ρ and no unconditional
    batch-wide refactorization** (SURVEY hard part #3 / VERDICT r1 next #5).

    ``jax.vmap(solve)`` lowers the per-problem ``lax.cond`` in
    :func:`_adapt_rho` to a select, so the whole batch pays a KKT
    refactorization at *every* adapt interval whether or not any problem's ρ
    moved.  Here the while-loop runs at the batch level, so the adapt check
    is a *scalar* ``any(adapt_mask)`` guarding a real ``lax.cond``:

    * no problem adapts (the common steady case) → zero factor cost;
    * some problems adapt → one batched refactor in which non-adapting
      problems recompute with their unchanged ρ_vec (numerically identical
      factors), and each problem's ρ trajectory follows its own residual
      ratios exactly as in the unbatched solver.

    ``qps`` is a problem pytree with a leading batch axis (as built by
    ``jax.vmap`` over constructors); returns a batched :class:`SolveResult`.
    """
    def setup_one(qp, wx, wy):
        if settings.scaling > 0:
            scaled, scaling = ruiz_equilibrate(qp, settings.scaling)
        else:
            scaled, scaling = qp, identity_scaling(
                qp.q.shape[-1], qp.l.shape[-1], qp.q.dtype
            )
        st = init_state(scaled, settings, wx, wy, scaling)
        return scaled, scaling, st

    setup = jax.vmap(
        setup_one,
        in_axes=(0, None if warm_x is None else 0, None if warm_y is None else 0),
    )
    scaled, scaling, st = setup(qps, warm_x, warm_y)

    iter_fn = jax.vmap(
        lambda s, state: _admm_iteration(s, state, settings)
    )
    term_fn = jax.vmap(
        lambda b, s, sc, state: _termination(b, s, sc, state, settings)
    )

    def cond(st):
        return jnp.any((~st.done) & (st.iterations < settings.max_iter))

    def chunk(st):
        # Factor out of the inner carry (constant within a chunk) so work
        # derived from it is hoisted — see run_admm.
        factor = st.factor
        st = jax.lax.fori_loop(
            0,
            settings.check_termination,
            lambda i, s: iter_fn(scaled, s.replace(factor=factor)).replace(
                factor=None
            ),
            st.replace(factor=None),
            unroll=settings.inner_unroll,
        ).replace(factor=factor)
        st, norms = term_fn(qps, scaled, scaling, st)
        if settings.adaptive_rho:
            interval = max(
                settings.adaptive_rho_interval, settings.check_termination
            )
            at_interval = (st.iterations % interval) < settings.check_termination
            new_rho, adapt = jax.vmap(
                lambda state, nm: _adapt_rho_decision(state, nm, settings)
            )(st, norms)
            adapt = adapt & at_interval

            def do_adapt(st):
                rho_bar = jnp.where(adapt, new_rho, st.rho_bar)
                # map over the container: .l/.u are per-problem properties
                rho_vec = jax.vmap(
                    lambda s, rb: _rho_vec(rb, s.l, s.u)
                )(scaled, rho_bar)
                factor = jax.vmap(
                    lambda s, rv: kkt_factor(s, rv, settings.sigma, settings)
                )(scaled, rho_vec)
                st = st.replace(
                    rho_bar=rho_bar, rho_vec=rho_vec, factor=factor
                )
                return _stall_reset(st, adapt, settings)

            # Scalar predicate → real branch even in the batched program:
            # the refactor runs only when at least one problem's ρ moved.
            st = jax.lax.cond(jnp.any(adapt), do_adapt, lambda s: s, st)
        return st

    st = jax.lax.while_loop(cond, chunk, st)
    if settings.polish:
        st = jax.vmap(
            lambda b, s, sc, state: polish(b, s, sc, state, settings)
        )(qps, scaled, scaling, st)
    return jax.vmap(finalize)(qps, scaling, st)


def finalize(base, scaling: Scaling, st: ADMMState) -> SolveResult:
    """Unscale iterates and package a :class:`SolveResult`."""
    x = scaling.D * st.x
    y = scaling.cinv * scaling.E * st.y
    z = scaling.Einv * st.z
    status = jnp.where(
        st.done, st.status, jnp.full_like(st.status, ExitCode.kMaxIterations)
    )
    obj = 0.5 * _g_sum(base, x * base.P_matvec(x)) + _g_sum(base, base.q * x)
    return SolveResult(
        x=x,
        y=y,
        z=z,
        status=status,
        iterations=st.iterations,
        prim_res=st.prim_res,
        dual_res=st.dual_res,
        rho=st.rho_bar,
        obj_val=obj,
    )
