"""Lane-major (batch-last) trajectory QP container.

The vmapped batched solver (:func:`osqp_solver_tpu.ops.admm.solve_batched`)
keeps every array batch-*leading* ``(B, ...)``.  This container stores the
whole problem batch-*trailing* — vectors are ``(rows..., B)``, block
matrices ``(W, 2N, 2N, B)`` — so one row of one array across the batch is
contiguous: the fused ADMM chunk kernel (:mod:`osqp_solver_tpu.ops.
admm_fused`) reads it as one coalesced load per row.  The XLA factor and
solve (:meth:`LaneTrajectoryQP.kkt_factor`/``kkt_solve``) move the batch
axis to the front around their vmapped scans.  It mirrors the semantics of
:class:`~osqp_solver_tpu.gomp.trajectory_qp.TrajectoryQP` (itself the
JAX-native re-design of the reference's sparse CSC assembly,
``/root/reference/src/constraints/constraint-builder.h``) method for method;
parity is pinned by ``tests/test_admm_lane.py`` against the vmapped path.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from .. import struct

_HI = jax.lax.Precision.HIGHEST  # exact f32 accumulation (see ops/tridiag.py)
_INF = 1e30  # matches constraints.INF (reference constraints.h:11)


@struct.dataclass
class LaneTrajectoryQP:
    # --- static structure ---------------------------------------------------
    waypoints: int = struct.field(pytree_node=False)
    n_dim: int = struct.field(pytree_node=False)
    gripper_flags: Tuple[bool, ...] = struct.field(pytree_node=False)
    n_obstacles: int = struct.field(pytree_node=False)

    # --- objective (batch-trailing) -----------------------------------------
    P_diag: jnp.ndarray  # (W, 2N, 2N, B)
    P_lower: jnp.ndarray  # (W-1, 2N, 2N, B)
    q_vec: jnp.ndarray  # (2WN, B)

    # --- constraint blocks (batch-trailing) ---------------------------------
    dyn_coef: jnp.ndarray  # (W-1, N, 3, B)
    dyn_l: jnp.ndarray  # (W-1, N, B)
    dyn_u: jnp.ndarray
    pos_coef: jnp.ndarray  # (W, N, B)
    pos_l: jnp.ndarray
    pos_u: jnp.ndarray
    vel_coef: jnp.ndarray  # (W-1, N, B)
    vel_l: jnp.ndarray
    vel_u: jnp.ndarray
    acc_coef: jnp.ndarray  # (W-2, N, 2, B)
    acc_l: jnp.ndarray  # (W-2, N, B)
    acc_u: jnp.ndarray
    ws_jac: jnp.ndarray  # (n_balls, W, 3, N, B)
    ws_l: jnp.ndarray  # (n_balls, W, 3, B)
    ws_u: jnp.ndarray
    obs_jac: jnp.ndarray  # (n_balls, n_obs, W, N, B)
    obs_l: jnp.ndarray  # (n_balls, n_obs, W, B)
    obs_u: jnp.ndarray

    # Row-space layout of the flat (m, B) constraint vectors (l, u, ρ, z, y):
    #   "type":     type-major — all dyn rows, then pos, vel, acc, ws/obs
    #               (matches TrajectoryQP row order exactly);
    #   "waypoint": waypoint-major — R rows per waypoint (dyn, pos, vel, acc,
    #               ws/obs), padded to a sublane multiple, so the fused ADMM
    #               chunk kernel streams contiguous (R, B) tiles per
    #               waypoint.  Padding rows carry zero A-coefficients and
    #               (−INF, INF) bounds — the reference's own dummy-row trick
    #               (constraint-builder.h:112-116) applied to tiling.
    row_layout: str = struct.field(pytree_node=False, default="type")
    # "vel_diag": P nonzero only on the velocity diagonal (see TrajectoryQP).
    p_structure: str = struct.field(pytree_node=False, default="block")

    # ------------------------------------------------------------ structure

    @property
    def n_balls(self) -> int:
        return len(self.gripper_flags)

    @property
    def batch(self) -> int:
        return self.q_vec.shape[-1]

    @property
    def n(self) -> int:
        return 2 * self.waypoints * self.n_dim

    @property
    def m(self) -> int:
        W, N = self.waypoints, self.n_dim
        if self.row_layout == "waypoint":
            return W * self.rows_per_waypoint_padded
        return (
            (W - 1) * N
            + W * N
            + (W - 1) * N
            + (W - 2) * N
            + sum(W * self._rows_per_wp(b) for b in range(self.n_balls))
        )

    def _rows_per_wp(self, ball: int) -> int:
        return (3 if self.gripper_flags[ball] else 0) + self.n_obstacles

    @property
    def rows_per_waypoint(self) -> int:
        """Real constraint rows per waypoint in the waypoint-major layout."""
        return 4 * self.n_dim + sum(
            self._rows_per_wp(b) for b in range(self.n_balls)
        )

    @property
    def rows_per_waypoint_padded(self) -> int:
        """Rows per waypoint rounded up to the f32 sublane multiple (8)."""
        return -(-self.rows_per_waypoint // 8) * 8

    # ---------------------------------------------------------- row packing

    def _concat_rows(self, dyn, pos, vel, acc, ws, obs, pad_value=0.0):
        """Pack per-block row values into the flat (m, B) vector.

        ``row_layout == "type"``: same row order as
        ``TrajectoryQP._concat_rows``.  ``"waypoint"``: R rows per waypoint
        (dyn, pos, vel, acc, per-ball ws/obs), padded with ``pad_value``
        where a type has no row at that waypoint and up to the sublane
        multiple."""
        B = dyn.shape[-1]
        if self.row_layout == "waypoint":
            W = self.waypoints

            def padW(x, missing):
                if not missing:
                    return x
                fill = jnp.full((missing,) + x.shape[1:], pad_value, x.dtype)
                return jnp.concatenate([x, fill], axis=0)

            parts = [padW(dyn, 1), pos, padW(vel, 1), padW(acc, 2)]
            for b in range(self.n_balls):
                if self.gripper_flags[b]:
                    parts.append(ws[b])  # (W, 3, B)
                if self.n_obstacles:
                    parts.append(jnp.moveaxis(obs[b], 0, 1))  # (W, n_obs, B)
            rows = jnp.concatenate(parts, axis=1)  # (W, R, B)
            Rp = self.rows_per_waypoint_padded
            if Rp > rows.shape[1]:
                fill = jnp.full(
                    (W, Rp - rows.shape[1], B), pad_value, rows.dtype
                )
                rows = jnp.concatenate([rows, fill], axis=1)
            return rows.reshape(W * Rp, B)
        parts = [
            dyn.reshape(-1, B), pos.reshape(-1, B),
            vel.reshape(-1, B), acc.reshape(-1, B),
        ]
        for b in range(self.n_balls):
            per_wp = []
            if self.gripper_flags[b]:
                per_wp.append(ws[b])  # (W, 3, B)
            if self.n_obstacles:
                per_wp.append(jnp.moveaxis(obs[b], 0, 1))  # (W, n_obs, B)
            if per_wp:
                parts.append(jnp.concatenate(per_wp, axis=1).reshape(-1, B))
        return jnp.concatenate(parts, axis=0) if parts else dyn.reshape(-1, B)

    def _split_rows(self, y):
        """Inverse of :meth:`_concat_rows` (padding dropped); ws/obs
        zero-filled for balls without those rows."""
        W, N = self.waypoints, self.n_dim
        B = y.shape[-1]
        if self.row_layout == "waypoint":
            rows = y.reshape(W, self.rows_per_waypoint_padded, B)
            dyn = rows[: W - 1, 0:N]
            pos = rows[:, N : 2 * N]
            vel = rows[: W - 1, 2 * N : 3 * N]
            acc = rows[: W - 2, 3 * N : 4 * N]
            ws = jnp.zeros((self.n_balls, W, 3, B), dtype=y.dtype)
            obs = jnp.zeros(
                (self.n_balls, self.n_obstacles, W, B), dtype=y.dtype
            )
            off = 4 * N
            for b in range(self.n_balls):
                if self.gripper_flags[b]:
                    ws = ws.at[b].set(rows[:, off : off + 3])
                    off += 3
                if self.n_obstacles:
                    obs = obs.at[b].set(
                        jnp.moveaxis(rows[:, off : off + self.n_obstacles], 0, 1)
                    )
                    off += self.n_obstacles
            return dyn, pos, vel, acc, ws, obs
        sizes = [(W - 1) * N, W * N, (W - 1) * N, (W - 2) * N]
        off = 0
        outs = []
        for s in sizes:
            outs.append(y[off : off + s])
            off += s
        dyn = outs[0].reshape(W - 1, N, B)
        pos = outs[1].reshape(W, N, B)
        vel = outs[2].reshape(W - 1, N, B)
        acc = outs[3].reshape(W - 2, N, B)
        ws = jnp.zeros((self.n_balls, W, 3, B), dtype=y.dtype)
        obs = jnp.zeros((self.n_balls, self.n_obstacles, W, B), dtype=y.dtype)
        for b in range(self.n_balls):
            rpw = self._rows_per_wp(b)
            if rpw == 0:
                continue
            blk = y[off : off + W * rpw].reshape(W, rpw, B)
            off += W * rpw
            k = 0
            if self.gripper_flags[b]:
                ws = ws.at[b].set(blk[:, :3])
                k = 3
            if self.n_obstacles:
                obs = obs.at[b].set(jnp.moveaxis(blk[:, k:], 0, 1))
        return dyn, pos, vel, acc, ws, obs

    # --------------------------------------------------------- flat bounds

    @property
    def l(self):
        return self._concat_rows(
            self.dyn_l, self.pos_l, self.vel_l, self.acc_l, self.ws_l,
            self.obs_l, pad_value=-_INF,
        )

    @property
    def u(self):
        return self._concat_rows(
            self.dyn_u, self.pos_u, self.vel_u, self.acc_u, self.ws_u,
            self.obs_u, pad_value=_INF,
        )

    @property
    def q(self):
        return self.q_vec

    # ---------------------------------------------------------- operators

    def _qv(self, x):
        W, N = self.waypoints, self.n_dim
        B = x.shape[-1]
        return x[: W * N].reshape(W, N, B), x[W * N :].reshape(W, N, B)

    def _interleave(self, x):
        q, v = self._qv(x)
        return jnp.concatenate([q, v], axis=1)  # (W, 2N, B)

    def _deinterleave(self, s):
        N = self.n_dim
        B = s.shape[-1]
        return jnp.concatenate(
            [s[:, :N].reshape(-1, B), s[:, N:].reshape(-1, B)], axis=0
        )

    def A_matvec(self, x):
        q, v = self._qv(x)
        c = self.dyn_coef
        dyn = c[..., 0, :] * v[:-1] + c[..., 1, :] * q[1:] + c[..., 2, :] * q[:-1]
        pos = self.pos_coef * q
        vel = self.vel_coef * v[:-1]
        a = self.acc_coef
        acc = a[..., 0, :] * v[1:-1] + a[..., 1, :] * v[:-2]
        ws = jnp.einsum("gwanb,wnb->gwab", self.ws_jac, q, precision=_HI)
        obs = jnp.einsum("gownb,wnb->gowb", self.obs_jac, q, precision=_HI)
        return self._concat_rows(dyn, pos, vel, acc, ws, obs)

    def AT_matvec(self, y):
        dyn, pos, vel, acc, ws, obs = self._split_rows(y)
        W, N = self.waypoints, self.n_dim
        B = y.shape[-1]
        c = self.dyn_coef
        a = self.acc_coef
        qg = self.pos_coef * pos
        qg = qg.at[1:].add(c[..., 1, :] * dyn)
        qg = qg.at[:-1].add(c[..., 2, :] * dyn)
        qg = qg + jnp.einsum("gwanb,gwab->wnb", self.ws_jac, ws, precision=_HI)
        qg = qg + jnp.einsum("gownb,gowb->wnb", self.obs_jac, obs, precision=_HI)
        vg = jnp.zeros((W, N, B), dtype=y.dtype)
        vg = vg.at[:-1].add(c[..., 0, :] * dyn + self.vel_coef * vel)
        vg = vg.at[1:-1].add(a[..., 0, :] * acc)
        vg = vg.at[:-2].add(a[..., 1, :] * acc)
        return jnp.concatenate([qg.reshape(-1, B), vg.reshape(-1, B)], axis=0)

    def P_matvec(self, x):
        s = self._interleave(x)  # (W, 2N, B)
        y = jnp.einsum("wijb,wjb->wib", self.P_diag, s, precision=_HI)
        if self.waypoints > 1:
            y = y.at[1:].add(
                jnp.einsum("wijb,wjb->wib", self.P_lower, s[:-1], precision=_HI)
            )
            y = y.at[:-1].add(
                jnp.einsum("wjib,wjb->wib", self.P_lower, s[1:], precision=_HI)
            )
        return self._deinterleave(y)

    # --------------------------------------------------------- Ruiz norms

    def A_col_absmax(self):
        c = jnp.abs(self.dyn_coef)
        a = jnp.abs(self.acc_coef)
        pad = lambda x, p: jnp.pad(x, (p, (0, 0), (0, 0)))
        qm = jnp.abs(self.pos_coef)
        qm = jnp.maximum(qm, pad(c[..., 2, :], (0, 1)))
        qm = jnp.maximum(qm, pad(c[..., 1, :], (1, 0)))
        if self.n_balls:
            qm = jnp.maximum(qm, jnp.max(jnp.abs(self.ws_jac), axis=(0, 2)))
        if self.n_obstacles and self.n_balls:
            qm = jnp.maximum(qm, jnp.max(jnp.abs(self.obs_jac), axis=(0, 1)))
        vm = pad(jnp.maximum(jnp.abs(self.vel_coef), c[..., 0, :]), (0, 1))
        vm = jnp.maximum(vm, pad(a[..., 1, :], (0, 2)))
        vm = jnp.maximum(vm, pad(a[..., 0, :], (1, 1)))
        B = qm.shape[-1]
        return jnp.concatenate([qm.reshape(-1, B), vm.reshape(-1, B)], axis=0)

    def A_row_absmax(self):
        dyn = jnp.max(jnp.abs(self.dyn_coef), axis=-2)
        pos = jnp.abs(self.pos_coef)
        vel = jnp.abs(self.vel_coef)
        acc = jnp.max(jnp.abs(self.acc_coef), axis=-2)
        ws = jnp.max(jnp.abs(self.ws_jac), axis=-2)
        obs = jnp.max(jnp.abs(self.obs_jac), axis=-2)
        return self._concat_rows(dyn, pos, vel, acc, ws, obs)

    def P_col_absmax(self):
        W = self.waypoints
        pd = jnp.max(jnp.abs(self.P_diag), axis=1)  # (W, 2N, B) per-col max
        if W > 1:
            low_col = jnp.max(jnp.abs(self.P_lower), axis=1)
            low_row = jnp.max(jnp.abs(self.P_lower), axis=2)
            pd = pd.at[:-1].max(low_col)
            pd = pd.at[1:].max(low_row)
        return self._deinterleave(pd)

    # ------------------------------------------------------------- scaling

    def scale_data(self, D, E, c):
        """Diagonal scaling with batch-trailing ``D (n, B)``, ``E (m, B)``,
        ``c (B,)`` — mirrors ``TrajectoryQP.scale_data``."""
        W, N = self.waypoints, self.n_dim
        Dq, Dv = self._qv(D)
        e_dyn, e_pos, e_vel, e_acc, e_ws, e_obs = self._split_rows(E)
        d_int = self._interleave(D)  # (W, 2N, B)
        P_diag = c * d_int[:, :, None, :] * self.P_diag * d_int[:, None, :, :]
        P_lower = (
            c * d_int[1:, :, None, :] * self.P_lower * d_int[:-1, None, :, :]
            if W > 1
            else self.P_lower
        )
        dyn_coef = jnp.stack(
            [
                self.dyn_coef[..., 0, :] * e_dyn * Dv[:-1],
                self.dyn_coef[..., 1, :] * e_dyn * Dq[1:],
                self.dyn_coef[..., 2, :] * e_dyn * Dq[:-1],
            ],
            axis=-2,
        )
        acc_coef = jnp.stack(
            [
                self.acc_coef[..., 0, :] * e_acc * Dv[1:-1],
                self.acc_coef[..., 1, :] * e_acc * Dv[:-2],
            ],
            axis=-2,
        )
        return self.replace(
            P_diag=P_diag,
            P_lower=P_lower,
            q_vec=c * D * self.q_vec,
            dyn_coef=dyn_coef,
            dyn_l=e_dyn * self.dyn_l,
            dyn_u=e_dyn * self.dyn_u,
            pos_coef=self.pos_coef * e_pos * Dq,
            pos_l=e_pos * self.pos_l,
            pos_u=e_pos * self.pos_u,
            vel_coef=self.vel_coef * e_vel * Dv[:-1],
            vel_l=e_vel * self.vel_l,
            vel_u=e_vel * self.vel_u,
            acc_coef=acc_coef,
            acc_l=e_acc * self.acc_l,
            acc_u=e_acc * self.acc_u,
            ws_jac=self.ws_jac * e_ws[:, :, :, None, :] * Dq[None, :, None, :, :],
            ws_l=e_ws * self.ws_l,
            ws_u=e_ws * self.ws_u,
            obs_jac=self.obs_jac
            * e_obs[:, :, :, None, :]
            * Dq[None, None, :, :, :],
            obs_l=e_obs * self.obs_l,
            obs_u=e_obs * self.obs_u,
        )

    # ------------------------------------------------------------ KKT path

    def kkt_blocks(self, rho_vec, sigma):
        """``P + σI + Aᵀdiag(ρ)A`` as lane-major block-tridiagonal
        ``(diag (W, 2N, 2N, B), lower (W-1, 2N, 2N, B))``.

        Scatter-free (see ``TrajectoryQP.kkt_blocks``)."""
        W, N = self.waypoints, self.n_dim
        r_dyn, r_pos, r_vel, r_acc, r_ws, r_obs = self._split_rows(rho_vec)
        dt = self.P_diag.dtype

        c0 = self.dyn_coef[..., 0, :]
        c1 = self.dyn_coef[..., 1, :]
        c2 = self.dyn_coef[..., 2, :]
        a0 = self.acc_coef[..., 0, :]
        a1 = self.acc_coef[..., 1, :]
        pad = lambda x, b, a: jnp.pad(x, ((b, a), (0, 0), (0, 0)))

        d_qq = r_pos * self.pos_coef**2
        d_qq = d_qq + pad(r_dyn * c2 * c2, 0, 1) + pad(r_dyn * c1 * c1, 1, 0)
        d_vv = pad(r_dyn * c0 * c0 + r_vel * self.vel_coef**2, 0, 1)
        d_vv = d_vv + pad(r_acc * a0 * a0, 1, 1) + pad(r_acc * a1 * a1, 0, 2)
        d_qv = pad(r_dyn * c2 * c0, 0, 1)

        eye = jnp.eye(2 * N, dtype=dt)[None, :, :, None]
        k_qv = jnp.eye(2 * N, k=N, dtype=dt)[None, :, :, None]
        k_vq = jnp.eye(2 * N, k=-N, dtype=dt)[None, :, :, None]
        zpad = jnp.zeros_like(d_qv)
        M_diag = (
            self.P_diag
            + sigma * eye
            + jnp.concatenate([d_qq, d_vv], axis=1)[:, :, None, :] * eye
            + jnp.concatenate([d_qv, zpad], axis=1)[:, :, None, :] * k_qv
            + jnp.concatenate([zpad, d_qv], axis=1)[:, :, None, :] * k_vq
        )

        l_qq = r_dyn * c1 * c2
        l_qv = r_dyn * c1 * c0
        l_vv = pad(r_acc * a0 * a1, 0, 1)
        zlow = jnp.zeros_like(l_qq)
        M_lower = (
            self.P_lower
            + jnp.concatenate([l_qq, l_vv], axis=1)[:, :, None, :] * eye
            + jnp.concatenate([l_qv, zlow], axis=1)[:, :, None, :] * k_qv
        )

        ws_c = jnp.einsum(
            "gwanb,gwab,gwamb->wnmb", self.ws_jac, r_ws, self.ws_jac,
            precision=_HI,
        )
        if self.n_obstacles and self.n_balls:
            ws_c = ws_c + jnp.einsum(
                "gownb,gowb,gowmb->wnmb", self.obs_jac, r_obs, self.obs_jac,
                precision=_HI,
            )
        M_diag = M_diag + jnp.pad(ws_c, ((0, 0), (0, N), (0, N), (0, 0)))
        return M_diag, M_lower

    def kkt_factor(self, rho_vec, sigma):
        from ..ops.tridiag import block_tridiag_factor

        diag, lower = self.kkt_blocks(rho_vec, sigma)
        f = jax.vmap(block_tridiag_factor)(
            jnp.moveaxis(diag, -1, 0), jnp.moveaxis(lower, -1, 0)
        )
        return LaneFactor(
            chol=jnp.moveaxis(f.chol, 0, -1), gain=jnp.moveaxis(f.gain, 0, -1)
        )

    def kkt_solve(self, factor, rhs):
        from ..ops.tridiag import BlockTridiagFactor, block_tridiag_solve

        out = jax.vmap(
            lambda c, g, r: block_tridiag_solve(BlockTridiagFactor(c, g), r)
        )(
            jnp.moveaxis(factor.chol, -1, 0),
            jnp.moveaxis(factor.gain, -1, 0),
            jnp.moveaxis(self._interleave(rhs), -1, 0),
        )
        return self._deinterleave(jnp.moveaxis(out, 0, -1))


@struct.dataclass
class LaneFactor:
    chol: jnp.ndarray  # (W, 2N, 2N, B)
    gain: jnp.ndarray  # (W-1, 2N, 2N, B)


_ARRAY_FIELDS = (
    "P_diag", "P_lower", "q_vec",
    "dyn_coef", "dyn_l", "dyn_u",
    "pos_coef", "pos_l", "pos_u",
    "vel_coef", "vel_l", "vel_u",
    "acc_coef", "acc_l", "acc_u",
    "ws_jac", "ws_l", "ws_u",
    "obs_jac", "obs_l", "obs_u",
)


def from_trailing(qps, row_layout: str = "type") -> LaneTrajectoryQP:
    """Wrap a ``TrajectoryQP`` pytree whose array leaves are already
    batch-*trailing* (built with ``jax.vmap(build_one, out_axes=-1)``) —
    zero-relayout lane construction: the vmapped assembly writes the lane
    layout directly."""
    return LaneTrajectoryQP(
        waypoints=qps.waypoints,
        n_dim=qps.n_dim,
        gripper_flags=qps.gripper_flags,
        n_obstacles=qps.n_obstacles,
        row_layout=row_layout,
        p_structure=getattr(qps, "p_structure", "block"),
        **{k: getattr(qps, k) for k in _ARRAY_FIELDS},
    )


def to_lane(qps) -> LaneTrajectoryQP:
    """Convert a batch-leading ``TrajectoryQP`` pytree (as built by ``vmap``
    over constructors) into the lane-major container — one relayout, paid
    once per problem batch instead of per kernel call."""
    return LaneTrajectoryQP(
        waypoints=qps.waypoints,
        n_dim=qps.n_dim,
        gripper_flags=qps.gripper_flags,
        n_obstacles=qps.n_obstacles,
        p_structure=getattr(qps, "p_structure", "block"),
        **{k: jnp.moveaxis(getattr(qps, k), 0, -1) for k in _ARRAY_FIELDS},
    )
