"""Structured (block-banded) trajectory QP — the hot-path problem container.

This is the JAX-native re-design of the reference's sparse-triplet CSC
assembly (``/root/reference/src/constraints/constraint-builder.h``): instead
of a general sparse matrix, the constraint Jacobian ``A`` is stored as its
structural blocks (all shapes static in ``(W, N)``):

* dynamics rows  ``v_t − q_{t+1} + q_t``   — coefficient array ``(W-1, N, 3)``
* position/velocity box rows               — coefficient arrays ``(W, N)``
* acceleration rows ``v_{t+1} − v_t``      — coefficient array ``(W-2, N, 2)``
* workspace rows — per-ball ``(W, 3, N)`` Jacobian blocks (gripper XYZ) and
  per-ball-per-obstacle ``(W, N)`` Z-row blocks

The coefficient arrays start at the reference's ±1 stencils and absorb Ruiz
scaling exactly, so the same ADMM core (``ops/admm.py``) runs unchanged.  The
reduced KKT matrix ``P + σI + Aᵀdiag(ρ)A`` assembles directly into
block-tridiagonal ``(W, 2N, 2N)`` form over interleaved per-waypoint
``[q_t, v_t]`` states and factors with the scan-based block Cholesky in
:mod:`osqp_solver_tpu.ops.tridiag` — O(W·(2N)³) sequential-in-W instead of
general sparse LDLᵀ, and fully batchable.

Row-space note: the reference over-allocates workspace rows by a factor
``N/3`` and leaves them as all-zero rows with infinite bounds
(``constraint-builder.h:43-44``); such rows are mathematically inert, so this
container keeps only the *used* rows (flat row order otherwise identical:
dyn, pos, vel, acc, then per ball per waypoint gripper-XYZ + obstacle rows,
matching ``constraint-builder.h:90-122``).  ``row_map()`` gives the mapping
into the reference's padded row space for parity tests.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..ops.tridiag import (
    block_tridiag_factor,
    block_tridiag_matvec,
    block_tridiag_solve,
    block_tridiag_to_dense,
)
from .constraints import INF, INF_THRESHOLD

_HI = jax.lax.Precision.HIGHEST  # exact f32 accumulation (see ops/tridiag.py)
from .layout import TrajectoryLayout, make_layout


@struct.dataclass
class TrajectoryQP:
    # --- static structure ---------------------------------------------------
    waypoints: int = struct.field(pytree_node=False)
    n_dim: int = struct.field(pytree_node=False)
    gripper_flags: Tuple[bool, ...] = struct.field(pytree_node=False)
    n_obstacles: int = struct.field(pytree_node=False)

    # --- objective: block-tridiagonal P over interleaved [q_t, v_t] ---------
    P_diag: jnp.ndarray  # (W, 2N, 2N)
    P_lower: jnp.ndarray  # (W-1, 2N, 2N)
    q_vec: jnp.ndarray  # (2WN,) reference layout [q..., v...]

    # --- constraint blocks --------------------------------------------------
    dyn_coef: jnp.ndarray  # (W-1, N, 3): coeffs on [v_t, q_{t+1}, q_t]
    dyn_l: jnp.ndarray  # (W-1, N)
    dyn_u: jnp.ndarray
    pos_coef: jnp.ndarray  # (W, N)
    pos_l: jnp.ndarray
    pos_u: jnp.ndarray
    vel_coef: jnp.ndarray  # (W-1, N)
    vel_l: jnp.ndarray
    vel_u: jnp.ndarray
    acc_coef: jnp.ndarray  # (W-2, N, 2): coeffs on [v_{t+1}, v_t]
    acc_l: jnp.ndarray
    acc_u: jnp.ndarray
    ws_jac: jnp.ndarray  # (n_balls, W, 3, N) — zero for non-gripper balls
    ws_l: jnp.ndarray  # (n_balls, W, 3)
    ws_u: jnp.ndarray
    obs_jac: jnp.ndarray  # (n_balls, n_obs, W, N)
    obs_l: jnp.ndarray  # (n_balls, n_obs, W)
    obs_u: jnp.ndarray

    # Static structure of the objective blocks: "block" = generic dense
    # (2N, 2N) blocks; "vel_diag" = nonzeros only on the velocity diagonal
    # (the GOMP smoothness Laplacian, utils.h:50-64) — lets the fused chunk
    # kernel rebuild the KKT coupling block from one P diagonal.
    p_structure: str = struct.field(pytree_node=False, default="block")

    # ------------------------------------------------------------ structure

    @property
    def n_balls(self) -> int:
        return len(self.gripper_flags)

    @property
    def n(self) -> int:
        return 2 * self.waypoints * self.n_dim

    @property
    def m(self) -> int:
        W, N = self.waypoints, self.n_dim
        return (
            (W - 1) * N
            + W * N
            + (W - 1) * N
            + (W - 2) * N
            + sum(W * self._rows_per_wp(b) for b in range(self.n_balls))
        )

    def _rows_per_wp(self, ball: int) -> int:
        return (3 if self.gripper_flags[ball] else 0) + self.n_obstacles

    # ---------------------------------------------------------- row packing

    def _concat_rows(self, dyn, pos, vel, acc, ws, obs):
        """Pack per-block row values into the flat (m,) vector.

        ``ws``: (n_balls, W, 3); ``obs``: (n_balls, n_obs, W).  Per ball the
        waypoint-major interleave of gripper XYZ rows then obstacle rows
        mirrors ``constraint-builder.h:95-119``.
        """
        parts = [dyn.reshape(-1), pos.reshape(-1), vel.reshape(-1), acc.reshape(-1)]
        for b in range(self.n_balls):
            per_wp = []
            if self.gripper_flags[b]:
                per_wp.append(ws[b])  # (W, 3)
            if self.n_obstacles:
                per_wp.append(jnp.moveaxis(obs[b], 0, 1))  # (W, n_obs)
            if per_wp:
                parts.append(jnp.concatenate(per_wp, axis=1).reshape(-1))
        return jnp.concatenate(parts) if parts else dyn.reshape(-1)

    def _split_rows(self, y):
        """Inverse of :meth:`_concat_rows` — returns (dyn, pos, vel, acc, ws,
        obs) with ws/obs zero-filled for balls without those rows."""
        W, N = self.waypoints, self.n_dim
        sizes = [(W - 1) * N, W * N, (W - 1) * N, (W - 2) * N]
        off = 0
        outs = []
        for s in sizes:
            outs.append(y[off : off + s])
            off += s
        dyn = outs[0].reshape(W - 1, N)
        pos = outs[1].reshape(W, N)
        vel = outs[2].reshape(W - 1, N)
        acc = outs[3].reshape(W - 2, N)
        ws = jnp.zeros((self.n_balls, W, 3), dtype=y.dtype)
        obs = jnp.zeros((self.n_balls, self.n_obstacles, W), dtype=y.dtype)
        for b in range(self.n_balls):
            rpw = self._rows_per_wp(b)
            if rpw == 0:
                continue
            blk = y[off : off + W * rpw].reshape(W, rpw)
            off += W * rpw
            k = 0
            if self.gripper_flags[b]:
                ws = ws.at[b].set(blk[:, :3])
                k = 3
            if self.n_obstacles:
                obs = obs.at[b].set(jnp.moveaxis(blk[:, k:], 0, 1))
        return dyn, pos, vel, acc, ws, obs

    def row_map(self) -> np.ndarray:
        """Compact-row → reference padded-row indices (host-side, tests)."""
        lay = self.layout()
        idx = []
        W, N = self.waypoints, self.n_dim
        idx.extend(range((W - 1) * N))  # dynamics
        idx.extend(range(lay.position_offset, lay.position_offset + W * N))
        idx.extend(range(lay.velocity_offset, lay.velocity_offset + (W - 1) * N))
        idx.extend(
            range(lay.acceleration_offset, lay.acceleration_offset + (W - 2) * N)
        )
        for b in range(self.n_balls):
            for t in range(W):
                for k in range(self._rows_per_wp(b)):
                    idx.append(lay.workspace_row(b, t, k))
        return np.asarray(idx)

    def layout(self) -> TrajectoryLayout:
        return make_layout(
            self.waypoints, self.n_dim, self.gripper_flags, self.n_obstacles
        )

    # --------------------------------------------------------- flat bounds

    @property
    def l(self):
        return self._concat_rows(
            self.dyn_l, self.pos_l, self.vel_l, self.acc_l, self.ws_l, self.obs_l
        )

    @property
    def u(self):
        return self._concat_rows(
            self.dyn_u, self.pos_u, self.vel_u, self.acc_u, self.ws_u, self.obs_u
        )

    @property
    def q(self):
        return self.q_vec

    # ---------------------------------------------------------- operators

    def _qv(self, x):
        W, N = self.waypoints, self.n_dim
        return x[: W * N].reshape(W, N), x[W * N :].reshape(W, N)

    def _interleave(self, x):
        q, v = self._qv(x)
        return jnp.concatenate([q, v], axis=1)  # (W, 2N)

    def _deinterleave(self, s):
        N = self.n_dim
        return jnp.concatenate([s[:, :N].reshape(-1), s[:, N:].reshape(-1)])

    def A_matvec(self, x):
        q, v = self._qv(x)
        c = self.dyn_coef
        dyn = c[..., 0] * v[:-1] + c[..., 1] * q[1:] + c[..., 2] * q[:-1]
        pos = self.pos_coef * q
        vel = self.vel_coef * v[:-1]
        a = self.acc_coef
        acc = a[..., 0] * v[1:-1] + a[..., 1] * v[:-2]
        ws = jnp.einsum("bwan,wn->bwa", self.ws_jac, q, precision=_HI)
        obs = jnp.einsum("bown,wn->bow", self.obs_jac, q, precision=_HI)
        return self._concat_rows(dyn, pos, vel, acc, ws, obs)

    def AT_matvec(self, y):
        dyn, pos, vel, acc, ws, obs = self._split_rows(y)
        W, N = self.waypoints, self.n_dim
        c = self.dyn_coef
        a = self.acc_coef
        qg = self.pos_coef * pos
        qg = qg.at[1:].add(c[..., 1] * dyn)
        qg = qg.at[:-1].add(c[..., 2] * dyn)
        qg = qg + jnp.einsum("bwan,bwa->wn", self.ws_jac, ws, precision=_HI)
        qg = qg + jnp.einsum("bown,bow->wn", self.obs_jac, obs, precision=_HI)
        vg = jnp.zeros((W, N), dtype=y.dtype)
        vg = vg.at[:-1].add(c[..., 0] * dyn + self.vel_coef * vel)
        vg = vg.at[1:-1].add(a[..., 0] * acc)
        vg = vg.at[:-2].add(a[..., 1] * acc)
        return jnp.concatenate([qg.reshape(-1), vg.reshape(-1)])

    def P_matvec(self, x):
        s = self._interleave(x)
        return self._deinterleave(block_tridiag_matvec(self.P_diag, self.P_lower, s))

    # --------------------------------------------------------- Ruiz norms

    def A_col_absmax(self):
        W, N = self.waypoints, self.n_dim
        c = jnp.abs(self.dyn_coef)
        a = jnp.abs(self.acc_coef)
        qm = jnp.abs(self.pos_coef)
        qm = jnp.maximum(qm, jnp.pad(c[..., 2], ((0, 1), (0, 0))))
        qm = jnp.maximum(qm, jnp.pad(c[..., 1], ((1, 0), (0, 0))))
        if self.n_balls:
            qm = jnp.maximum(qm, jnp.max(jnp.abs(self.ws_jac), axis=(0, 2)))
        if self.n_obstacles and self.n_balls:
            qm = jnp.maximum(qm, jnp.max(jnp.abs(self.obs_jac), axis=(0, 1)))
        vm = jnp.pad(jnp.maximum(jnp.abs(self.vel_coef), c[..., 0]), ((0, 1), (0, 0)))
        vm = jnp.maximum(vm, jnp.pad(a[..., 1], ((0, 2), (0, 0))))
        vm = jnp.maximum(vm, jnp.pad(a[..., 0], ((1, 1), (0, 0))))
        return jnp.concatenate([qm.reshape(-1), vm.reshape(-1)])

    def A_row_absmax(self):
        dyn = jnp.max(jnp.abs(self.dyn_coef), axis=-1)
        pos = jnp.abs(self.pos_coef)
        vel = jnp.abs(self.vel_coef)
        acc = jnp.max(jnp.abs(self.acc_coef), axis=-1)
        ws = jnp.max(jnp.abs(self.ws_jac), axis=-1)
        obs = jnp.max(jnp.abs(self.obs_jac), axis=-1)
        return self._concat_rows(dyn, pos, vel, acc, ws, obs)

    def P_col_absmax(self):
        W = self.waypoints
        pd = jnp.max(jnp.abs(self.P_diag), axis=1)  # (W, 2N) per-col max
        if W > 1:
            low_col = jnp.max(jnp.abs(self.P_lower), axis=1)  # cols in block t
            low_row = jnp.max(jnp.abs(self.P_lower), axis=2)  # cols in block t+1
            pd = pd.at[:-1].max(low_col)
            pd = pd.at[1:].max(low_row)
        return self._deinterleave(pd)

    # ------------------------------------------------------------- scaling

    def scale_data(self, D, E, c):
        W, N = self.waypoints, self.n_dim
        Dq, Dv = self._qv(D)
        e_dyn, e_pos, e_vel, e_acc, e_ws, e_obs = self._split_rows(E)
        d_int = self._interleave(D)  # (W, 2N)
        P_diag = c * d_int[:, :, None] * self.P_diag * d_int[:, None, :]
        P_lower = (
            c * d_int[1:, :, None] * self.P_lower * d_int[:-1, None, :]
            if W > 1
            else self.P_lower
        )
        dyn_coef = jnp.stack(
            [
                self.dyn_coef[..., 0] * e_dyn * Dv[:-1],
                self.dyn_coef[..., 1] * e_dyn * Dq[1:],
                self.dyn_coef[..., 2] * e_dyn * Dq[:-1],
            ],
            axis=-1,
        )
        acc_coef = jnp.stack(
            [
                self.acc_coef[..., 0] * e_acc * Dv[1:-1],
                self.acc_coef[..., 1] * e_acc * Dv[:-2],
            ],
            axis=-1,
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
            ws_jac=self.ws_jac * e_ws[..., None] * Dq[None, :, None, :],
            ws_l=e_ws * self.ws_l,
            ws_u=e_ws * self.ws_u,
            obs_jac=self.obs_jac * e_obs[..., None] * Dq[None, None, :, :],
            obs_l=e_obs * self.obs_l,
            obs_u=e_obs * self.obs_u,
        )

    # ------------------------------------------------------------ KKT path

    def kkt_blocks(self, rho_vec, sigma):
        """Assemble ``P + σI + Aᵀdiag(ρ)A`` as block-tridiagonal
        ``(diag, lower)``.

        Scatter-free: every AᵀρA contribution lands on a sub-block diagonal
        of the (2N, 2N) waypoint blocks, so each is an outer product of a
        per-waypoint vector with a constant shifted-identity mask — pure
        broadcast adds that XLA fuses, instead of scatter HLO (which once
        dominated the batch-1024 honest solve's refactors).
        """
        W, N = self.waypoints, self.n_dim
        r_dyn, r_pos, r_vel, r_acc, r_ws, r_obs = self._split_rows(rho_vec)
        dt = self.P_diag.dtype

        c0 = self.dyn_coef[..., 0]
        c1 = self.dyn_coef[..., 1]
        c2 = self.dyn_coef[..., 2]
        a0 = self.acc_coef[..., 0]
        a1 = self.acc_coef[..., 1]
        pad = lambda x, b, a: jnp.pad(x, ((b, a), (0, 0)))

        # Per-waypoint sub-block diagonals of AᵀρA (each (W, N)).
        d_qq = r_pos * self.pos_coef**2
        d_qq = d_qq + pad(r_dyn * c2 * c2, 0, 1) + pad(r_dyn * c1 * c1, 1, 0)
        d_vv = pad(r_dyn * c0 * c0 + r_vel * self.vel_coef**2, 0, 1)
        d_vv = d_vv + pad(r_acc * a0 * a0, 1, 1) + pad(r_acc * a1 * a1, 0, 2)
        d_qv = pad(r_dyn * c2 * c0, 0, 1)

        eye = jnp.eye(2 * N, dtype=dt)
        k_qv = jnp.eye(2 * N, k=N, dtype=dt)  # ones at (j, N+j)
        zpad = jnp.zeros_like(d_qv)
        M_diag = (
            self.P_diag
            + sigma * eye
            + jnp.concatenate([d_qq, d_vv], axis=1)[:, :, None] * eye
            + jnp.concatenate([d_qv, zpad], axis=1)[:, :, None] * k_qv
            + jnp.concatenate([zpad, d_qv], axis=1)[:, :, None] * k_qv.T
        )

        # Lower (t+1, t) blocks: dyn couples (q_{t+1} → q_t, v_t), acc
        # couples (v_{t+1} → v_t) — again all sub-block diagonals.
        l_qq = r_dyn * c1 * c2
        l_qv = r_dyn * c1 * c0
        l_vv = pad(r_acc * a0 * a1, 0, 1)
        zlow = jnp.zeros_like(l_qq)
        M_lower = (
            self.P_lower
            + jnp.concatenate([l_qq, l_vv], axis=1)[:, :, None] * eye
            + jnp.concatenate([l_qv, zlow], axis=1)[:, :, None] * k_qv
        )

        ws_c = jnp.einsum("bwan,bwa,bwam->wnm", self.ws_jac, r_ws, self.ws_jac, precision=_HI)
        if self.n_obstacles and self.n_balls:
            ws_c = ws_c + jnp.einsum(
                "bown,bow,bowm->wnm", self.obs_jac, r_obs, self.obs_jac
            , precision=_HI)
        M_diag = M_diag + jnp.pad(ws_c, ((0, 0), (0, N), (0, N)))
        return M_diag, M_lower

    def kkt_factor(self, rho_vec, sigma):
        return block_tridiag_factor(*self.kkt_blocks(rho_vec, sigma))

    def kkt_solve(self, factor, rhs):
        s = block_tridiag_solve(factor, self._interleave(rhs))
        return self._deinterleave(s)

    # --------------------------------------------------------------- dense

    def to_dense(self):
        """Materialize dense ``(P, q, A, l, u)`` in the reference variable
        layout with *compact* rows (tests/ground-truth only)."""
        n = self.n
        x_basis = jnp.eye(n, dtype=self.q_vec.dtype)
        A = jax.vmap(self.A_matvec, in_axes=1, out_axes=1)(x_basis)
        P_int = block_tridiag_to_dense(self.P_diag, self.P_lower)
        perm = self._perm_to_interleaved()
        P = P_int[jnp.ix_(perm, perm)]
        return P, self.q_vec, A, self.l, self.u

    def _perm_to_interleaved(self):
        """perm[i] = interleaved index of reference-layout variable i."""
        W, N = self.waypoints, self.n_dim
        q_idx = (jnp.arange(W)[:, None] * 2 * N + jnp.arange(N)[None, :]).reshape(-1)
        v_idx = (jnp.arange(W)[:, None] * 2 * N + N + jnp.arange(N)[None, :]).reshape(-1)
        return jnp.concatenate([q_idx, v_idx])

    def to_csr(self):
        """Host-side CSR export in *interleaved* ``[q_t, v_t]`` variable order
        (banded KKT) for the native sparse oracle
        (``native/osqp_oracle.cpp::osqp_oracle_solve_sparse``).

        Returns ``(P_csr, q, A_csr, l, u, kb, perm)`` as numpy data, where
        each ``*_csr`` is an ``(indptr, indices, data)`` triple, ``kb = 4N-1``
        is the KKT half-bandwidth of the block-tridiagonal structure, and
        ``perm`` maps reference-layout variable i → interleaved index
        (``x_ref = x_interleaved[perm]``).
        """
        W, N = self.waypoints, self.n_dim
        qcol = lambda t, j: 2 * N * t + j
        vcol = lambda t, j: 2 * N * t + N + j

        A_rows = []  # list of (cols array, vals array) per row
        dyn = np.asarray(self.dyn_coef)
        for t in range(W - 1):
            for j in range(N):
                A_rows.append((
                    np.array([vcol(t, j), qcol(t + 1, j), qcol(t, j)]),
                    dyn[t, j],
                ))
        pos_c = np.asarray(self.pos_coef)
        for t in range(W):
            for j in range(N):
                A_rows.append((np.array([qcol(t, j)]), pos_c[t, j : j + 1]))
        vel_c = np.asarray(self.vel_coef)
        for t in range(W - 1):
            for j in range(N):
                A_rows.append((np.array([vcol(t, j)]), vel_c[t, j : j + 1]))
        acc = np.asarray(self.acc_coef)
        for t in range(W - 2):
            for j in range(N):
                A_rows.append((
                    np.array([vcol(t + 1, j), vcol(t, j)]), acc[t, j]
                ))
        ws_jac = np.asarray(self.ws_jac)
        obs_jac = np.asarray(self.obs_jac)
        q_cols = np.arange(N)
        for b in range(self.n_balls):
            for t in range(W):
                if self.gripper_flags[b]:
                    for a in range(3):
                        A_rows.append((2 * N * t + q_cols, ws_jac[b, t, a]))
                for o in range(self.n_obstacles):
                    A_rows.append((2 * N * t + q_cols, obs_jac[b, o, t]))

        A_indptr = np.zeros(len(A_rows) + 1, np.int32)
        A_indptr[1:] = np.cumsum([len(c) for c, _ in A_rows])
        A_indices = np.concatenate([c for c, _ in A_rows]).astype(np.int32)
        A_data = np.concatenate([v for _, v in A_rows]).astype(np.float64)

        # P CSR from the block-tridiagonal (diag, lower) pair.
        Pd = np.asarray(self.P_diag)
        Pl = np.asarray(self.P_lower)
        B = 2 * N
        P_rows_cols, P_rows_vals = [], []
        for t in range(W):
            for k in range(B):
                cols, vals = [], []
                if t > 0:  # P[t, t-1] = P_lower[t-1]
                    cols.append(2 * N * (t - 1) + np.arange(B))
                    vals.append(Pl[t - 1, k])
                cols.append(2 * N * t + np.arange(B))
                vals.append(Pd[t, k])
                if t < W - 1:  # P[t, t+1] = P_lower[t].T
                    cols.append(2 * N * (t + 1) + np.arange(B))
                    vals.append(Pl[t, :, k])
                P_rows_cols.append(np.concatenate(cols))
                P_rows_vals.append(np.concatenate(vals))
        P_indptr = np.zeros(W * B + 1, np.int32)
        P_indptr[1:] = np.cumsum([len(c) for c in P_rows_cols])
        P_indices = np.concatenate(P_rows_cols).astype(np.int32)
        P_data = np.concatenate(P_rows_vals).astype(np.float64)

        perm = np.asarray(self._perm_to_interleaved())
        q_int = np.zeros(2 * W * N)
        q_int[perm] = np.asarray(self.q_vec)
        return (
            (P_indptr, P_indices, P_data),
            q_int,
            (A_indptr, A_indices, A_data),
            np.asarray(self.l, np.float64),
            np.asarray(self.u, np.float64),
            4 * N - 1,
            perm,
        )


# --------------------------------------------------------------------------
# Constructors
# --------------------------------------------------------------------------


def smoothness_P_blocks(waypoints: int, n_dim: int, dtype=jnp.float64):
    """The GOMP objective (``gomp-solver.h:61-64``) in block-tridiagonal form:
    zero on positions, tridiag(2, -1) Laplacian across velocities."""
    W, N = waypoints, n_dim
    B = 2 * N
    eyeN = jnp.eye(N, dtype=dtype)
    d = jnp.zeros((B, B), dtype).at[N:, N:].set(2.0 * eyeN)
    lo = jnp.zeros((B, B), dtype).at[N:, N:].set(-1.0 * eyeN)
    return jnp.tile(d, (W, 1, 1)), jnp.tile(lo, (W - 1, 1, 1))


def empty_trajectory_qp(
    waypoints: int,
    n_dim: int,
    gripper_flags: Sequence[bool] = (),
    n_obstacles: int = 0,
    dtype=jnp.float64,
) -> TrajectoryQP:
    """Fresh trajectory QP: dynamics rows wired (l=u=0), smoothness P, all
    other bounds at ±INF, workspace Jacobians zero (mirrors the
    ``ConstraintBuilder`` constructor state, ``constraint-builder.h:30-45``)."""
    W, N = waypoints, n_dim
    nb = len(gripper_flags)
    P_diag, P_lower = smoothness_P_blocks(W, N, dtype)
    z = lambda *s: jnp.zeros(s, dtype)
    neg = lambda *s: jnp.full(s, -INF, dtype)
    pos = lambda *s: jnp.full(s, INF, dtype)
    return TrajectoryQP(
        waypoints=W,
        n_dim=N,
        gripper_flags=tuple(bool(g) for g in gripper_flags),
        n_obstacles=int(n_obstacles),
        P_diag=P_diag,
        P_lower=P_lower,
        q_vec=z(2 * W * N),
        dyn_coef=jnp.broadcast_to(
            jnp.asarray([1.0, -1.0, 1.0], dtype), (W - 1, N, 3)
        ),
        dyn_l=z(W - 1, N),
        dyn_u=z(W - 1, N),
        # Box-row coefficients start at zero: the reference emits a box row's
        # identity coefficient only when position()/velocity() is called
        # (constraint-builder.h:185-201); never-constrained rows stay all-zero.
        pos_coef=z(W, N),
        pos_l=neg(W, N),
        pos_u=pos(W, N),
        vel_coef=z(W - 1, N),
        vel_l=neg(W - 1, N),
        vel_u=pos(W - 1, N),
        acc_coef=jnp.broadcast_to(jnp.asarray([1.0, -1.0], dtype), (W - 2, N, 2)),
        acc_l=neg(W - 2, N),
        acc_u=pos(W - 2, N),
        ws_jac=z(nb, W, 3, N),
        ws_l=neg(nb, W, 3),
        ws_u=pos(nb, W, 3),
        obs_jac=z(nb, n_obstacles, W, N),
        obs_l=neg(nb, n_obstacles, W),
        obs_u=pos(nb, n_obstacles, W),
        p_structure="vel_diag",
    )


def _masked(new, old):
    """Write ``new`` where finite, keep ``old`` where ``new`` is ±INF —
    the reference's optional-bound write semantics
    (``constraint-builder.h:173-183``)."""
    return jnp.where(jnp.abs(new) >= INF_THRESHOLD, old, new)


def with_gomp_boxes(
    qp: TrajectoryQP,
    start_pos,
    end_pos,
    pos_con,
    vel_con,
    acc_con,
) -> TrajectoryQP:
    """Apply the planner's box constraints (``gomp-solver.h:118-139``),
    including the deliberate ``W-3`` endpoint quirk: ``q_0 = start``,
    ``q_1..q_{W-2}`` boxed, ``q_{W-3} = end``, ``v_0..v_{W-4}`` boxed,
    ``v_{W-3} = 0``, ``a_0..a_{W-4}`` boxed, ``a_{W-3} = 0``.

    ``pos_con``/``vel_con``/``acc_con`` are ``(lower, upper)`` pairs of
    ``(N,)`` arrays (±INF = unbounded); vel/acc already dt-scaled by the
    caller (``gomp-solver.h:29-30``).
    """
    W, N = qp.waypoints, qp.n_dim
    dt_ = qp.pos_l.dtype
    start = jnp.asarray(start_pos, dt_)
    end = jnp.asarray(end_pos, dt_)
    pl, pu = (jnp.asarray(b, dt_) for b in pos_con)
    vl, vu = (jnp.asarray(b, dt_) for b in vel_con)
    al, au = (jnp.asarray(b, dt_) for b in acc_con)

    # position() / velocity() calls write the identity coefficient for the
    # rows they touch: q_0..q_{W-2} and v_0..v_{W-3} (v_{W-2} and q_{W-1}
    # are never constrained by initConstraints — their rows stay zero).
    one = jnp.ones((), dt_)
    pos_coef = qp.pos_coef.at[: W - 1].set(one)
    vel_coef = qp.vel_coef.at[: W - 2].set(one)

    pos_l = qp.pos_l.at[0].set(start)
    pos_u = qp.pos_u.at[0].set(start)
    pos_l = pos_l.at[1 : W - 1].set(_masked(pl, pos_l[1 : W - 1]))
    pos_u = pos_u.at[1 : W - 1].set(_masked(pu, pos_u[1 : W - 1]))
    pos_l = pos_l.at[W - 3].set(end)
    pos_u = pos_u.at[W - 3].set(end)

    vel_l = qp.vel_l.at[: W - 3].set(_masked(vl, qp.vel_l[: W - 3]))
    vel_u = qp.vel_u.at[: W - 3].set(_masked(vu, qp.vel_u[: W - 3]))
    vel_l = vel_l.at[W - 3].set(0.0)
    vel_u = vel_u.at[W - 3].set(0.0)

    acc_l = qp.acc_l.at[: W - 3].set(_masked(al, qp.acc_l[: W - 3]))
    acc_u = qp.acc_u.at[: W - 3].set(_masked(au, qp.acc_u[: W - 3]))
    acc_l = acc_l.at[W - 3].set(0.0)
    acc_u = acc_u.at[W - 3].set(0.0)

    return qp.replace(
        pos_coef=pos_coef, vel_coef=vel_coef,
        pos_l=pos_l, pos_u=pos_u, vel_l=vel_l, vel_u=vel_u, acc_l=acc_l, acc_u=acc_u
    )


def pinned_movable_mask(W: int, w_active=None):
    """``(W,)`` bool: which waypoints the GOMP QP can actually move —
    everything except the pinned ``q₀`` (start) and ``q_{wa−3}`` (end, the
    reference quirk, ``gomp-solver.h:131,133``).  Fed to
    :func:`linearize_workspace`'s ``movable`` so relative obstacle cuts
    (sphere tunneling pushes) never demand motion from a pin.  ``w_active``
    may be traced (the padded planner paths)."""
    idx = jnp.arange(W)
    wa = W if w_active is None else jnp.asarray(w_active, jnp.int32)
    return ~((idx == 0) | (idx == wa - 3))


def with_horizon_mask(qp: TrajectoryQP, w_active) -> TrajectoryQP:
    """Restrict a ``W_max``-shaped empty QP to an *active prefix* of
    ``w_active`` waypoints (``w_active`` may be a traced scalar).

    This is the pad-to-max discipline for the time-scaling loop
    (``gomp-solver.h:38-55``): ONE compiled program at ``W_max`` serves every
    shrunken horizon — padding waypoints get zero objective/constraint
    coefficients and ±INF bounds, exactly like a freshly built QP at
    ``w_active`` plus mathematically inert rows (the reference's own
    dummy-row trick, ``constraint-builder.h:112-116``).

    Apply to ``empty_trajectory_qp(W_max, ...)`` BEFORE
    :func:`with_gomp_boxes_masked` / :func:`linearize_workspace` (the latter
    masked via its ``w_active`` argument).
    """
    W, N = qp.waypoints, qp.n_dim
    dt_ = qp.q_vec.dtype
    wa = jnp.asarray(w_active, jnp.int32)
    t = jnp.arange(W)
    act_v = (t < wa).astype(dt_)  # velocity var exists for t < w_active
    act_dyn = (t[: W - 1] < wa - 1).astype(dt_)
    act_acc = (t[: W - 2] < wa - 2).astype(dt_)

    # Smoothness P at horizon w_active: tridiag(2, -1) over active v-blocks.
    P_diag = qp.P_diag * act_v[:, None, None]
    P_lower = qp.P_lower * act_dyn[:, None, None]

    dyn_coef = qp.dyn_coef * act_dyn[:, None, None]
    dyn_l = jnp.where(act_dyn[:, None] > 0, qp.dyn_l, -INF)
    dyn_u = jnp.where(act_dyn[:, None] > 0, qp.dyn_u, INF)
    acc_coef = qp.acc_coef * act_acc[:, None, None]
    return qp.replace(
        P_diag=P_diag, P_lower=P_lower,
        dyn_coef=dyn_coef, dyn_l=dyn_l, dyn_u=dyn_u, acc_coef=acc_coef,
    )


def with_gomp_boxes_masked(
    qp: TrajectoryQP,
    start_pos,
    end_pos,
    pos_con,
    vel_con,
    acc_con,
    w_active,
) -> TrajectoryQP:
    """Traced-horizon version of :func:`with_gomp_boxes`: identical row
    semantics (including the ``W-3`` endpoint quirk) with ``W := w_active``
    a traced scalar inside a ``W_max``-shaped container."""
    W, N = qp.waypoints, qp.n_dim
    dt_ = qp.pos_l.dtype
    wa = jnp.asarray(w_active, jnp.int32)
    start = jnp.asarray(start_pos, dt_)
    end = jnp.asarray(end_pos, dt_)
    pl, pu = (jnp.asarray(b, dt_) for b in pos_con)
    vl, vu = (jnp.asarray(b, dt_) for b in vel_con)
    al, au = (jnp.asarray(b, dt_) for b in acc_con)

    t = jnp.arange(W)[:, None]  # broadcast over N
    one = jnp.ones((), dt_)

    # position rows: coef for q_0..q_{wa-2}
    pos_coef = jnp.where(t <= wa - 2, one, qp.pos_coef)
    pos_coef = jnp.where(t > wa - 2, 0.0, pos_coef)
    box_l = _masked(jnp.broadcast_to(pl, (W, N)), jnp.full((W, N), -INF, dt_))
    box_u = _masked(jnp.broadcast_to(pu, (W, N)), jnp.full((W, N), INF, dt_))
    pos_l = jnp.where((t >= 1) & (t <= wa - 2), box_l, -INF)
    pos_u = jnp.where((t >= 1) & (t <= wa - 2), box_u, INF)
    pos_l = jnp.where(t == 0, start[None, :], pos_l)
    pos_u = jnp.where(t == 0, start[None, :], pos_u)
    pos_l = jnp.where(t == wa - 3, end[None, :], pos_l)
    pos_u = jnp.where(t == wa - 3, end[None, :], pos_u)

    tv = jnp.arange(W - 1)[:, None]
    vel_coef = jnp.where(
        jnp.broadcast_to(tv <= wa - 3, (W - 1, N)), one, 0.0
    )
    vbox_l = _masked(jnp.broadcast_to(vl, (W - 1, N)), jnp.full((W - 1, N), -INF, dt_))
    vbox_u = _masked(jnp.broadcast_to(vu, (W - 1, N)), jnp.full((W - 1, N), INF, dt_))
    vel_l = jnp.where(tv <= wa - 4, vbox_l, -INF)
    vel_u = jnp.where(tv <= wa - 4, vbox_u, INF)
    vel_l = jnp.where(tv == wa - 3, 0.0, vel_l)
    vel_u = jnp.where(tv == wa - 3, 0.0, vel_u)

    ta = jnp.arange(W - 2)[:, None]
    abox_l = _masked(jnp.broadcast_to(al, (W - 2, N)), jnp.full((W - 2, N), -INF, dt_))
    abox_u = _masked(jnp.broadcast_to(au, (W - 2, N)), jnp.full((W - 2, N), INF, dt_))
    acc_l = jnp.where(ta <= wa - 4, abox_l, -INF)
    acc_u = jnp.where(ta <= wa - 4, abox_u, INF)
    acc_l = jnp.where(ta == wa - 3, 0.0, acc_l)
    acc_u = jnp.where(ta == wa - 3, 0.0, acc_u)

    return qp.replace(
        pos_coef=pos_coef, vel_coef=vel_coef,
        pos_l=pos_l, pos_u=pos_u, vel_l=vel_l, vel_u=vel_u,
        acc_l=acc_l, acc_u=acc_u,
    )


def linearize_workspace(
    qp: TrajectoryQP,
    balls,
    obstacles,
    con_3d,
    trajectory,
    w_active=None,
    movable=None,
) -> TrajectoryQP:
    """SCP linearization of workspace + obstacle constraints — the jitted
    equivalent of ``withObstacles`` (``constraint-builder.h:90-122``) plus the
    value-only ``QPSolver::update`` (``osqp-wrapper.h:33-43``): FK and
    Jacobians are evaluated batched over waypoints with ``vmap``, and only
    *values* of fixed-shape arrays change (never shapes — the static-shape
    discipline the reference approximated with dummy rows).

    ``balls``: static sequence of :class:`~osqp_solver_tpu.models.robot.RobotBall`
    with jnp-traceable ``fk``/``jacobian``.  ``obstacles``: sequence of
    :class:`~osqp_solver_tpu.gomp.geometry.HorizontalLine` (length must equal
    ``qp.n_obstacles``).  ``con_3d``: ``(lower, upper)`` pair of 3-vectors.
    Only the position half of ``trajectory`` is read (``tests/test.cpp:403-448``).

    ``movable``: optional ``(W,)`` bool mask of waypoints the QP can move,
    forwarded to each obstacle's ``linearize_rows`` — the planner marks
    its pinned ``q₀``/``q_{W−3}`` endpoints immovable so relative
    (tunneling) cuts never demand motion from a pinned waypoint (see
    :meth:`SphereObstacle.linearize_rows`).  ``None`` (the default, and
    the dense parity builder's behavior) treats every waypoint as movable.
    """
    W, N = qp.waypoints, qp.n_dim
    dt_ = qp.ws_l.dtype
    q_traj = jnp.asarray(trajectory, dt_)[: W * N].reshape(W, N)
    c3l = jnp.asarray(con_3d[0], dt_)
    c3u = jnp.asarray(con_3d[1], dt_)
    # Pad-to-max horizon: waypoints ≥ w_active get inert rows (zero jac,
    # ±INF bounds) — see :func:`with_horizon_mask`.
    if w_active is None:
        act = None
    else:
        act = jnp.arange(W) < jnp.asarray(w_active, jnp.int32)  # (W,)

    ws_jac, ws_l, ws_u = qp.ws_jac, qp.ws_l, qp.ws_u
    obs_jac, obs_l, obs_u = qp.obs_jac, qp.obs_l, qp.obs_u

    for b, ball in enumerate(balls):
        if getattr(ball, "fk_jac_batched", None) is not None:
            # SoA batched evaluator: elementwise over (W,) — avoids the
            # (W, 4, 4) DH-matrix intermediates (robot.py).
            points, jac = ball.fk_jac_batched(q_traj)
            points = jnp.asarray(points, dt_)
            jac = jnp.asarray(jac, dt_)
        else:
            points = jax.vmap(lambda s: jnp.asarray(ball.fk(s), dt_))(q_traj)  # (W,3)
            jac = jax.vmap(lambda s: jnp.asarray(ball.jacobian(s), dt_))(q_traj)
        jq = jnp.einsum("wan,wn->wa", jac, q_traj, precision=_HI)  # (W,3) J·q₀ per axis
        r = ball.radius

        if ball.is_gripper:
            # constraint-builder.h:221-244 per-axis Taylor bounds ± radius.
            low = jnp.where(
                jnp.abs(c3l)[None, :] >= INF_THRESHOLD,
                -INF,
                c3l[None, :] - points + jq,
            )
            upp = jnp.where(
                jnp.abs(c3u)[None, :] >= INF_THRESHOLD,
                INF,
                c3u[None, :] - points + jq,
            )
            low = low + r
            upp = upp - r
            if act is not None:
                jac = jac * act[:, None, None].astype(dt_)
                low = jnp.where(act[:, None], low, -INF)
                upp = jnp.where(act[:, None], upp, INF)
            ws_jac = ws_jac.at[b].set(jac)
            ws_l = ws_l.at[b].set(low)
            ws_u = ws_u.at[b].set(upp)

        for o, line in enumerate(obstacles):
            # Duck-typed obstacle protocol (geometry.py): one linearized
            # row per waypoint — constraint-builder.h:246-267 Z-row for
            # HorizontalLine, supporting-hyperplane row for SphereObstacle;
            # dummy (±INF) rows share coefficients (:108-117).  ``movable``
            # is forwarded only to implementations that accept it (the
            # pre-round-5 4-argument protocol keeps working).
            from .geometry import call_linearize_rows

            ojac, low, upp = call_linearize_rows(
                line, points, jac, jq, r, movable=movable
            )
            if act is not None:
                ojac = ojac * act[:, None].astype(dt_)
                low = jnp.where(act, low, -INF)
                upp = jnp.where(act, upp, INF)
            obs_jac = obs_jac.at[b, o].set(ojac)
            obs_l = obs_l.at[b, o].set(low)
            obs_u = obs_u.at[b, o].set(upp)

    return qp.replace(
        ws_jac=ws_jac, ws_l=ws_l, ws_u=ws_u,
        obs_jac=obs_jac, obs_l=obs_l, obs_u=obs_u,
    )
