"""Fused ADMM chunk kernel: ``n_iter`` OSQP iterations in one GPU launch.

Pallas through Triton.  The plain path (:func:`.admm_lane._iteration` under
a ``fori_loop``) runs each iteration as a handful of XLA fusions plus a
block-tridiagonal solve that is a 2·W-step ``lax.scan``; on a GPU every scan
step is at least one kernel launch.  This kernel runs a whole chunk of
iterations per launch.  Each program owns a tile of ``block_b`` problems of
the batch-last (lane) arrays: every quantity of one problem is one lane of a
``(block_b,)`` vector, so one row of an array at one waypoint is one
coalesced load, and the per-problem arithmetic is the scalar recurrence of
the reference solver run lane-parallel.

Per iteration, per program:

* a **forward pass** over the waypoints builds the reduced-KKT right-hand
  side ``σx − q + Aᵀ(ρz − y)`` from the stencil coefficients (the Aᵀ gather
  at waypoint t reads constraint rows of t−1 and t only) and runs the
  forward block substitution;
* a **backward pass** finishes the substitution and, as ``x̃_t`` emerges
  (``x̃_{t+1}`` is still in registers), applies waypoint t's A-rows,
  over-relaxation, box projection and dual update, and writes x/z/y back in
  place.

Substitution form (gain-free): with ``C_t`` the diagonal blocks of the block
Cholesky factor and ``Ml_t`` the sparse KKT coupling block between
waypoints t+1 and t (3N nonzeros, rebuilt from ρ and the stencil
coefficients), the forward pass stores
``h_t = C_tᵀ⁻¹C_t⁻¹(r_t − Ml_{t−1}h_{t−1})`` and the backward pass computes
``x̃_t = h_t − C_tᵀ⁻¹C_t⁻¹(Ml_tᵀx̃_{t+1})``.  This is the factor's
block-tridiagonal solve with ``G_t = Ml_t·C_t⁻ᵀ`` never formed, so only
``C_t`` is read.  It needs the velocity-diagonal objective (the GOMP cost),
whose coupling block adds one diagonal to ``Ml``.

Termination, ρ adaptation and certificates stay in XLA
(:func:`.admm_lane._termination`): the kernel emits the final iteration's
deltas ``dx``/``dy`` for them.  No matrix product runs inside the kernel,
so nothing in it can fall into TF32.

Reference anchor: the OSQP ADMM hot loop (SURVEY §3.4) — per iteration one
cached-factor KKT solve, projection and dual update (α = 1.6
over-relaxation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# One problem per lane and one warp per 32 problems: at multiples of 32 no
# lane holds a replica, so every value a program stores is re-read by the
# thread that stored it.  (Tiles of 16 to 128 problems ran equally fast on
# an H100.)
BLOCK_B = 32


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def kernel_unsupported_reason(qp, settings):
    """``None`` when the kernel implements ``qp`` under ``settings``; else
    the reason it does not (the backend module then selects XLA)."""
    if qp.row_layout != "waypoint":
        return "row_layout must be 'waypoint'"
    if qp.p_structure != "vel_diag":
        return "the gain-free substitution needs a velocity-diagonal P"
    if qp.waypoints < 3:
        return "needs at least 3 waypoints"
    if settings.kkt_method != "direct":
        return "kkt_method must be 'direct'"
    if settings.kkt_refine:
        return "kkt_refine is not implemented in the kernel"
    return None


# ---------------------------------------------------------------------------
# Static layouts
# ---------------------------------------------------------------------------


def _row_layout(qp):
    """Per-waypoint row offsets inside the padded (Rp) row tile."""
    N = qp.n_dim
    off = {"dyn": 0, "pos": N, "vel": 2 * N, "acc": 3 * N}
    ball_rows = []
    o = 4 * N
    for b in range(qp.n_balls):
        ws_off = o if qp.gripper_flags[b] else None
        if qp.gripper_flags[b]:
            o += 3
        obs_off = o if qp.n_obstacles else None
        o += qp.n_obstacles
        ball_rows.append((ws_off, obs_off))
    return off, tuple(ball_rows)


def _coef_layout(qp):
    """Row offsets inside the per-waypoint coefficient pack (CRp rows)."""
    N = qp.n_dim
    off = {
        "c0": 0, "c1": N, "c2": 2 * N,
        "pos": 3 * N, "vel": 4 * N,
        "a0": 5 * N, "a1": 6 * N,
    }
    ball_coefs = []
    o = 7 * N
    for b in range(qp.n_balls):
        ws_off = o if qp.gripper_flags[b] else None
        if qp.gripper_flags[b]:
            o += 3 * N
        obs_off = o if qp.n_obstacles else None
        o += qp.n_obstacles * N
        ball_coefs.append((ws_off, obs_off))
    return off, tuple(ball_coefs), o, _pad8(o)


def build_coef_pack(qp) -> jnp.ndarray:
    """(W, CRp, B) stencil coefficient pack — constant per solve.  Rows a
    waypoint does not have (dyn/vel at W−1, acc at W−2 and W−1) are zero."""
    W, N, B = qp.waypoints, qp.n_dim, qp.batch
    dt = qp.q_vec.dtype
    _, _, CR, CRp = _coef_layout(qp)

    def padW(x, missing):
        if not missing:
            return x
        return jnp.concatenate(
            [x, jnp.zeros((missing,) + x.shape[1:], dt)], axis=0
        )

    c = qp.dyn_coef  # (W-1, N, 3, B)
    a = qp.acc_coef  # (W-2, N, 2, B)
    parts = [
        padW(c[..., 0, :], 1), padW(c[..., 1, :], 1), padW(c[..., 2, :], 1),
        qp.pos_coef, padW(qp.vel_coef, 1),
        padW(a[..., 0, :], 2), padW(a[..., 1, :], 2),
    ]
    for b in range(qp.n_balls):
        if qp.gripper_flags[b]:
            parts.append(qp.ws_jac[b].reshape(W, 3 * N, B))
        if qp.n_obstacles:
            parts.append(
                jnp.moveaxis(qp.obs_jac[b], 0, 1).reshape(
                    W, qp.n_obstacles * N, B
                )
            )
    coef = jnp.concatenate(parts, axis=1)
    if CRp > CR:
        coef = jnp.concatenate(
            [coef, jnp.zeros((W, CRp - CR, B), dt)], axis=1
        )
    return coef


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def _make_kernel(*, W, N, R, Rp, CRp, sigma, alpha, row_off, coef_off,
                 ball_rows, ball_coefs, n_obstacles, block_b):
    """Kernel body.  Each waypoint step issues all of its loads first, then
    the arithmetic, then its stores: no store or branch sits between two
    loads, so the loads of a step are in flight together (one warp per
    program leaves nothing else to hide their latency).  The iteration
    count is a runtime input, so a warmup chunk and the cadence chunk share
    one compiled kernel."""
    B2 = 2 * N
    WN = W * N
    dyn = [row_off["dyn"] + j for j in range(N)]
    acc = [row_off["acc"] + j for j in range(N)]
    near = ("c0", "c1", "c2", "a0", "a1")  # coefficients of Ml and t−1 terms

    def kernel(n_iter_ref, chol, plow, coef, q, rho, lo, up, done,
               _x_in, _z_in, _y_in, x, z, y, dx, dy, h):
        cols = pl.ds(pl.program_id(0) * block_b, block_b)
        frozen = done[0, cols] > 0.5
        n_iter = n_iter_ref[0]
        zero = tuple(jnp.zeros((block_b,), x.dtype) for _ in range(B2))

        def ld(ref, row):
            return ref[row, cols]

        def put(ref, row, val, mask=None):
            row = jnp.asarray(row, jnp.int32)  # one index dtype under x64
            if mask is None:
                ref[row, cols] = val
            else:
                pl_triton.store(ref.at[row, cols], val, mask=mask)

        # Flat lane layouts: x = [q (W·N); v (W·N)]; z/y/ρ/l/u waypoint-major
        # (Rp rows per waypoint); factor blocks row-major (2N·2N per
        # waypoint); coefficients CRp rows per waypoint.
        def xrow(t, i):
            return t * N + i if i < N else WN + t * N + (i - N)

        def load_coef(t, names=None):
            if names is None:
                return [ld(coef, t * CRp + k) for k in range(CRp)]
            return {
                nm: [ld(coef, t * CRp + coef_off[nm] + j) for j in range(N)]
                for nm in names
            }

        def load_chol(t):
            base = t * (B2 * B2)
            return {
                (i, j): ld(chol, base + i * B2 + j)
                for i in range(B2) for j in range(i + 1)
            }

        def load_pvel(t):
            base = t * (B2 * B2)
            return [ld(plow, base + (N + j) * B2 + N + j) for j in range(N)]

        def lower_solve(L, b):  # C w = b
            w = []
            for i in range(B2):
                a_ = b[i]
                for j in range(i):
                    a_ = a_ - L[(i, j)] * w[j]
                w.append(a_ / L[(i, i)])
            return w

        def upper_solve(L, b):  # Cᵀ x = b
            xs = [None] * B2
            for i in reversed(range(B2)):
                a_ = b[i]
                for j in range(i + 1, B2):
                    a_ = a_ - L[(j, i)] * xs[j]
                xs[i] = a_ / L[(i, i)]
            return xs

        def coupling(c, rd, ra, pv):
            """Ml (waypoint t+1 rows, t columns): the q→q, v→q and v→v
            diagonals from ρ of the dyn/acc rows, the stencil coefficients
            and the P_lower velocity diagonal."""
            qq = [rd[j] * c["c1"][j] * c["c2"][j] for j in range(N)]
            qv = [rd[j] * c["c1"][j] * c["c0"][j] for j in range(N)]
            vv = [ra[j] * c["a0"][j] * c["a1"][j] + pv[j] for j in range(N)]
            return qq, qv, vv

        def named(cf):
            return {nm: [cf[coef_off[nm] + j] for j in range(N)] for nm in near}

        def a_rows(cf, cur, nxt):
            """A rows of one waypoint from x̃_t (``cur``) and x̃_{t+1}
            (``nxt``); ``None`` for padding rows."""
            out = [None] * Rp
            for j in range(N):
                out[row_off["dyn"] + j] = (
                    cf[coef_off["c0"] + j] * cur[N + j]
                    + cf[coef_off["c1"] + j] * nxt[j]
                    + cf[coef_off["c2"] + j] * cur[j]
                )
                out[row_off["pos"] + j] = cf[coef_off["pos"] + j] * cur[j]
                out[row_off["vel"] + j] = cf[coef_off["vel"] + j] * cur[N + j]
                out[row_off["acc"] + j] = (
                    cf[coef_off["a0"] + j] * nxt[N + j]
                    + cf[coef_off["a1"] + j] * cur[N + j]
                )
            for (ws_r, obs_r), (ws_c, obs_c) in zip(ball_rows, ball_coefs):
                groups = []
                if ws_r is not None:
                    groups += [(ws_r + a3, ws_c + a3 * N) for a3 in range(3)]
                if obs_r is not None:
                    groups += [(obs_r + o, obs_c + o * N) for o in range(n_obstacles)]
                for r, c0 in groups:
                    a_ = cf[c0] * cur[0]
                    for j in range(1, N):
                        a_ = a_ + cf[c0 + j] * cur[j]
                    out[r] = a_
            return out

        def at_own(cf, v):
            """Aᵀ gather of waypoint t's own rows ``v`` into its variables."""
            g = [None] * B2
            for j in range(N):
                a_ = cf[coef_off["c2"] + j] * v[row_off["dyn"] + j]
                a_ = a_ + cf[coef_off["pos"] + j] * v[row_off["pos"] + j]
                for (ws_r, obs_r), (ws_c, obs_c) in zip(ball_rows, ball_coefs):
                    if ws_r is not None:
                        for a3 in range(3):
                            a_ = a_ + cf[ws_c + a3 * N + j] * v[ws_r + a3]
                    if obs_r is not None:
                        for o in range(n_obstacles):
                            a_ = a_ + cf[obs_c + o * N + j] * v[obs_r + o]
                g[j] = a_
                b_ = cf[coef_off["c0"] + j] * v[row_off["dyn"] + j]
                b_ = b_ + cf[coef_off["vel"] + j] * v[row_off["vel"] + j]
                b_ = b_ + cf[coef_off["a1"] + j] * v[row_off["acc"] + j]
                g[N + j] = b_
            return g

        def fwd_step(t, h_prev):
            tp = jnp.maximum(t - 1, 0)
            # ---- loads ----
            cf = load_coef(t)
            rho_t = [ld(rho, t * Rp + r) for r in range(R)]
            z_t = [ld(z, t * Rp + r) for r in range(R)]
            y_t = [ld(y, t * Rp + r) for r in range(R)]
            prev_rows = dyn + acc
            rho_p = {r: ld(rho, tp * Rp + r) for r in prev_rows}
            z_p = {r: ld(z, tp * Rp + r) for r in prev_rows}
            y_p = {r: ld(y, tp * Rp + r) for r in prev_rows}
            cf_p = load_coef(tp, near)
            pv_p = load_pvel(tp)
            x_t = [ld(x, xrow(t, i)) for i in range(B2)]
            q_t = [ld(q, xrow(t, i)) for i in range(B2)]
            L = load_chol(t)
            # ---- arithmetic ----
            v = [rho_t[r] * z_t[r] - y_t[r] for r in range(R)]
            v = v + [None] * (Rp - R)
            g = at_own(cf, v)
            has_prev = t > 0
            for j in range(N):
                r1, r2 = dyn[j], acc[j]
                vd = rho_p[r1] * z_p[r1] - y_p[r1]
                va = rho_p[r2] * z_p[r2] - y_p[r2]
                g[j] = g[j] + jnp.where(has_prev, cf_p["c1"][j] * vd, 0.0)
                g[N + j] = g[N + j] + jnp.where(
                    has_prev, cf_p["a0"][j] * va, 0.0
                )
            b = [sigma * x_t[i] - q_t[i] + g[i] for i in range(B2)]
            # r_t − Ml_{t−1}·h_{t−1}; h_prev is zero at t = 0.
            qq, qv, vv = coupling(
                cf_p, [rho_p[r] for r in dyn], [rho_p[r] for r in acc], pv_p
            )
            for j in range(N):
                b[j] = b[j] - (qq[j] * h_prev[j] + qv[j] * h_prev[N + j])
                b[N + j] = b[N + j] - vv[j] * h_prev[N + j]
            ht = upper_solve(L, lower_solve(L, b))
            # ---- stores ----
            for i in range(B2):
                put(h, t * B2 + i, ht[i])
            return tuple(ht)

        def bwd_step(k, xn, final):
            t = W - 1 - k
            # ---- loads ----
            h_t = [ld(h, t * B2 + i) for i in range(B2)]
            L = load_chol(t)
            cf = load_coef(t)
            # x̃_W is zero, so the P_lower row read at t = W−1 (clamped to
            # W−2) never contributes.
            pv = load_pvel(jnp.minimum(t, W - 2))
            x_old = [ld(x, xrow(t, i)) for i in range(B2)]
            rows = [t * Rp + r for r in range(Rp)]
            rho_t = [ld(rho, rr) for rr in rows]
            z_old = [ld(z, rr) for rr in rows]
            y_old = [ld(y, rr) for rr in rows]
            lo_t = [ld(lo, rr) for rr in rows]
            up_t = [ld(up, rr) for rr in rows]
            # ---- arithmetic ----
            # Ml_tᵀ·x̃_{t+1}; at t = W−1 its stencil coefficients are zero.
            qq, qv, vv = coupling(
                named(cf), [rho_t[r] for r in dyn], [rho_t[r] for r in acc], pv
            )
            u = [None] * B2
            for j in range(N):
                u[j] = qq[j] * xn[j]
                u[N + j] = qv[j] * xn[j] + vv[j] * xn[N + j]
            r_ = upper_solve(L, lower_solve(L, u))
            xt = [h_t[i] - r_[i] for i in range(B2)]
            x_new = [alpha * xt[i] + (1.0 - alpha) * x_old[i] for i in range(B2)]
            zt = a_rows(cf, xt, xn)
            z_new, y_new = [], []
            for r in range(Rp):
                z_a = alpha * zt[r] if zt[r] is not None else 0.0
                z_tmp = z_a + (1.0 - alpha) * z_old[r]
                zn = jnp.clip(z_tmp + y_old[r] / rho_t[r], lo_t[r], up_t[r])
                z_new.append(zn)
                y_new.append(y_old[r] + rho_t[r] * (z_tmp - zn))
            # ---- stores ----
            last = jnp.broadcast_to(final, (block_b,))
            for i in range(B2):
                row = xrow(t, i)
                put(x, row, jnp.where(frozen, x_old[i], x_new[i]))
                put(dx, row, jnp.where(frozen, 0.0, x_new[i] - x_old[i]), last)
            for r in range(Rp):
                put(z, rows[r], jnp.where(frozen, z_old[r], z_new[r]))
                put(y, rows[r], jnp.where(frozen, y_old[r], y_new[r]))
                put(dy, rows[r], jnp.where(frozen, 0.0, y_new[r] - y_old[r]), last)
            return tuple(xt)

        def iteration(it, carry):
            final = it == n_iter - 1
            jax.lax.fori_loop(0, W, fwd_step, zero)
            jax.lax.fori_loop(
                0, W, lambda k, xn: bwd_step(k, xn, final), zero
            )
            return carry

        jax.lax.fori_loop(0, n_iter, iteration, 0)

    return kernel


# ---------------------------------------------------------------------------
# Host-side call
# ---------------------------------------------------------------------------


def fused_admm_chunk(
    scaled, factor, x, z, y, rho_vec, done, settings, n_iter=None,
    coef=None, block_b=BLOCK_B, interpret=False,
):
    """Run ``n_iter`` (default ``settings.check_termination``) ADMM
    iterations in one launch.

    ``scaled``: waypoint-layout, velocity-diagonal
    :class:`~osqp_solver_tpu.gomp.trajectory_qp_lane.LaneTrajectoryQP`
    (Ruiz-scaled); ``factor``: its ``LaneFactor`` for ``rho_vec`` (only the
    diagonal Cholesky blocks are read); lane state ``x (n, B)``,
    ``z/y/rho_vec (m, B)``, ``done (B,) bool``; ``coef``: the
    :func:`build_coef_pack` of ``scaled`` (built here when omitted).

    Returns ``(x, z, y, dx, dy)``: the state after the chunk — the same
    values as ``n_iter`` applications of :func:`.admm_lane._iteration` up
    to rounding — and the final iteration's deltas, zero for frozen
    problems (their status is already decided).  A batch that is not a
    multiple of ``block_b`` is padded with copies of its last problem,
    marked frozen.  ``interpret=True`` runs the kernel in the Pallas
    interpreter (tests on the CPU).
    """
    reason = kernel_unsupported_reason(scaled, settings)
    if reason is not None:
        raise ValueError(f"fused_admm_chunk: {reason}")
    W, N, B = scaled.waypoints, scaled.n_dim, scaled.batch
    B2 = 2 * N
    Rp = scaled.rows_per_waypoint_padded
    row_off, ball_rows = _row_layout(scaled)
    coef_off, ball_coefs, _, CRp = _coef_layout(scaled)
    dt = scaled.q_vec.dtype
    if coef is None:
        coef = build_coef_pack(scaled)

    pad = -B % block_b

    def lane2d(a):
        a = a.reshape(-1, B)
        return jnp.pad(a, ((0, 0), (0, pad)), mode="edge") if pad else a

    done_f = done.astype(dt)[None, :]
    if pad:
        done_f = jnp.pad(done_f, ((0, 0), (0, pad)), constant_values=1.0)
    n = scaled.n
    m = W * Rp
    Bp = B + pad
    n_iter = settings.check_termination if n_iter is None else n_iter
    inputs = [
        jnp.asarray(n_iter, jnp.int32).reshape(1),
        lane2d(factor.chol), lane2d(scaled.P_lower), lane2d(coef),
        lane2d(scaled.q_vec), lane2d(rho_vec), lane2d(scaled.l),
        lane2d(scaled.u), done_f, lane2d(x), lane2d(z), lane2d(y),
    ]
    kernel = _make_kernel(
        W=W, N=N, R=scaled.rows_per_waypoint, Rp=Rp, CRp=CRp,
        sigma=float(settings.sigma), alpha=float(settings.alpha),
        row_off=row_off, coef_off=coef_off,
        ball_rows=ball_rows, ball_coefs=ball_coefs,
        n_obstacles=scaled.n_obstacles, block_b=block_b,
    )
    shape = lambda rows: jax.ShapeDtypeStruct((rows, Bp), dt)  # noqa: E731
    outs = pl.pallas_call(
        kernel,
        grid=(Bp // block_b,),
        out_shape=(
            shape(n), shape(m), shape(m),  # x, z, y (in place)
            shape(n), shape(m),  # dx, dy
            shape(W * B2),  # h: forward-pass scratch
        ),
        input_output_aliases={9: 0, 10: 1, 11: 2},
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=block_b // 32 or 1, num_stages=1
        ),
        interpret=interpret,
        name="admm_chunk",
    )(*inputs)
    return tuple(o[:, :B] for o in outs[:5])
