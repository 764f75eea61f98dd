"""Horizon-sharded banded QP: separator-only distributed ADMM.

The round-2 redesign of SURVEY.md §5 "sequence parallelism" (VERDICT r1
weak #3 / next #3): instead of replicating the ADMM vector state and
all-gathering the full interior solution every iteration, the *entire*
problem — state, bounds, duals, constraint data — is sharded along the
horizon axis of a mesh, and every per-iteration exchange is O(K·B):

* the constraint matrix is stored as per-waypoint row blocks
  ``z_t = A0[t]·s_t + A1[t]·s_{t+1}`` (``s_t = [q_t, v_t] ∈ R^B`` the
  interleaved waypoint state) — the banded structure fixed by the
  reference's row stencils (``constraint-builder.h:203-219, 72-88``);
* matvecs exchange one ``(B,)`` halo with each neighbour via ``ppermute``;
* the KKT solve is the Schur-complement split of
  :mod:`osqp_solver_tpu.parallel.schur`: chunk-local factor/substitution,
  one ``all_gather`` of ``(K, B)`` separator right-hand sides, a replicated
  tiny ``(K-1)·B`` reduced solve, local back-substitution — the interior
  never leaves its device;
* residual norms / certificates reduce via ``psum``/``pmax`` scalars
  (the ADMM core's reductions are collective-aware via the
  ``collective_axis`` protocol attribute, ``ops/admm.py``).

Chunk layout (SPMD-uniform): the horizon is padded to ``K·Ws`` waypoints;
device ``k`` owns slots ``[k·Ws, (k+1)·Ws)`` — ``Ws−1`` interior waypoints
plus its right separator ``s_k`` in the last slot (device ``K−1``'s
separator slot is padding).  Padded slots carry identity P-diagonal, zero
coupling, zero rows with ±INF bounds — the same inert-row discipline the
reference uses for SCP dummy rows (``constraint-builder.h:112-116``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct
from jax.sharding import Mesh, PartitionSpec as P

from ..gomp.constraints import INF
from ..ops import admm as admm_mod
from ..ops.tridiag import (
    BlockTridiagFactor,
    block_tridiag_factor,
    block_tridiag_solve,
)
from .mesh import HORIZON_AXIS
from .schur import _chunk_factor


# ---------------------------------------------------------------------------
# Single-device banded container
# ---------------------------------------------------------------------------


@struct.dataclass
class BandedQP:
    """Trajectory QP in per-waypoint row-block form (single device).

    State is interleaved ``(W, B)``; every constraint row belongs to a
    waypoint ``t`` and reads only ``(s_t, s_{t+1})``:

        ``z[t] = A0[t] @ s_t + A1[t] @ s_{t+1}``,   ``A1[W-1] = 0``.

    ``P_lower`` is stored with a uniform ``(W, B, B)`` shape —
    ``P_lower[t]`` couples ``(t+1, t)``, the last block must be zero —
    so the container shards along the leading axis without reshaping.
    """

    waypoints: int = struct.field(pytree_node=False)
    block: int = struct.field(pytree_node=False)  # B = 2*N
    rows_per_wp: int = struct.field(pytree_node=False)  # r

    P_diag: jnp.ndarray  # (W, B, B)
    P_lower: jnp.ndarray  # (W, B, B), last block zero
    q_wb: jnp.ndarray  # (W, B)
    A0: jnp.ndarray  # (W, r, B)
    A1: jnp.ndarray  # (W, r, B), last block zero
    l_wr: jnp.ndarray  # (W, r)
    u_wr: jnp.ndarray  # (W, r)

    # ------------------------------------------------------------- protocol

    @property
    def q(self):
        return self.q_wb.reshape(-1)

    @property
    def l(self):
        return self.l_wr.reshape(-1)

    @property
    def u(self):
        return self.u_wr.reshape(-1)

    @property
    def n(self) -> int:
        return self.waypoints * self.block

    @property
    def m(self) -> int:
        return self.waypoints * self.rows_per_wp

    def _s(self, x):
        return x.reshape(self.waypoints, self.block)

    def A_matvec(self, x):
        s = self._s(x)
        s_next = jnp.concatenate([s[1:], jnp.zeros_like(s[:1])])
        z = jnp.einsum("trb,tb->tr", self.A0, s)
        z = z + jnp.einsum("trb,tb->tr", self.A1, s_next)
        return z.reshape(-1)

    def AT_matvec(self, y):
        yv = y.reshape(self.waypoints, self.rows_per_wp)
        out = jnp.einsum("trb,tr->tb", self.A0, yv)
        carry = jnp.einsum("trb,tr->tb", self.A1, yv)  # → state_{t+1}
        out = out.at[1:].add(carry[:-1])
        return out.reshape(-1)

    def P_matvec(self, x):
        s = self._s(x)
        y = jnp.einsum("tij,tj->ti", self.P_diag, s)
        y = y.at[1:].add(jnp.einsum("tij,tj->ti", self.P_lower[:-1], s[:-1]))
        y = y.at[:-1].add(jnp.einsum("tji,tj->ti", self.P_lower[:-1], s[1:]))
        return y.reshape(-1)

    # ------------------------------------------------------------ Ruiz norms

    def A_col_absmax(self):
        c0 = jnp.max(jnp.abs(self.A0), axis=1)  # (W, B)
        c1 = jnp.max(jnp.abs(self.A1), axis=1)
        cols = c0.at[1:].max(c1[:-1])
        return cols.reshape(-1)

    def A_row_absmax(self):
        r = jnp.maximum(
            jnp.max(jnp.abs(self.A0), axis=2), jnp.max(jnp.abs(self.A1), axis=2)
        )
        return r.reshape(-1)

    def P_col_absmax(self):
        d = jnp.max(jnp.abs(self.P_diag), axis=1)  # (W, B)
        lo_col = jnp.max(jnp.abs(self.P_lower), axis=1)  # cols of block t
        lo_row = jnp.max(jnp.abs(self.P_lower), axis=2)  # cols of block t+1
        d = d.at[:-1].max(lo_col[:-1])
        d = d.at[1:].max(lo_row[:-1])
        return d.reshape(-1)

    # -------------------------------------------------------------- scaling

    def scale_data(self, D, E, c):
        W, B, r = self.waypoints, self.block, self.rows_per_wp
        Dv = D.reshape(W, B)
        Ev = E.reshape(W, r)
        D_next = jnp.concatenate([Dv[1:], jnp.zeros_like(Dv[:1])])
        return self.replace(
            P_diag=c * Dv[:, :, None] * self.P_diag * Dv[:, None, :],
            P_lower=c * D_next[:, :, None] * self.P_lower * Dv[:, None, :],
            q_wb=c * Dv * self.q_wb,
            A0=Ev[:, :, None] * self.A0 * Dv[:, None, :],
            A1=Ev[:, :, None] * self.A1 * D_next[:, None, :],
            l_wr=Ev * self.l_wr,
            u_wr=Ev * self.u_wr,
        )

    # ------------------------------------------------------------- KKT path

    def kkt_blocks(self, rho_vec, sigma):
        W, B = self.waypoints, self.block
        rv = rho_vec.reshape(W, self.rows_per_wp)
        diag = self.P_diag + sigma * jnp.eye(B, dtype=self.P_diag.dtype)
        diag = diag + jnp.einsum("tri,tr,trj->tij", self.A0, rv, self.A0)
        c1 = jnp.einsum("tri,tr,trj->tij", self.A1, rv, self.A1)  # → (t+1,t+1)
        diag = diag.at[1:].add(c1[:-1])
        lower = self.P_lower + jnp.einsum(
            "tri,tr,trj->tij", self.A1, rv, self.A0
        )
        return diag, lower[:-1]

    def kkt_factor(self, rho_vec, sigma):
        return block_tridiag_factor(*self.kkt_blocks(rho_vec, sigma))

    def kkt_solve(self, factor, rhs):
        return block_tridiag_solve(factor, self._s(rhs)).reshape(-1)


def banded_from_trajectory(qp) -> Tuple[BandedQP, np.ndarray]:
    """Convert a :class:`~osqp_solver_tpu.gomp.trajectory_qp.TrajectoryQP`
    into banded row-block form.

    Returns ``(banded, row_map)`` where ``row_map[i]`` is the banded flat row
    holding the i-th compact row of the TrajectoryQP (for parity tests and
    dual mapping).  Row-family order inside a waypoint block: dyn(N), pos(N),
    vel(N), acc(N), then per ball gripper-XYZ + obstacle rows; families that
    don't exist at a waypoint (e.g. dyn at t=W−1) are inert zero rows with
    ±INF bounds — the static-shape dummy-row discipline.
    """
    W, N = qp.waypoints, qp.n_dim
    B = 2 * N
    nb = qp.n_balls
    ws_rows = sum(3 if g else 0 for g in qp.gripper_flags) + nb * qp.n_obstacles
    r = 4 * N + ws_rows
    dt_ = qp.q_vec.dtype

    A0 = jnp.zeros((W, r, B), dt_)
    A1 = jnp.zeros((W, r, B), dt_)
    l = jnp.full((W, r), -INF, dt_)
    u = jnp.full((W, r), INF, dt_)
    jj = jnp.arange(N)

    # dyn rows (t < W-1): c0·v_t + c1·q_{t+1} + c2·q_t
    c = qp.dyn_coef  # (W-1, N, 3)
    A0 = A0.at[:-1, jj, N + jj].set(c[..., 0])
    A0 = A0.at[:-1, jj, jj].set(c[..., 2])
    A1 = A1.at[:-1, jj, jj].set(c[..., 1])
    l = l.at[:-1, jj].set(qp.dyn_l)
    u = u.at[:-1, jj].set(qp.dyn_u)

    # pos rows (all t)
    A0 = A0.at[:, N + jj, jj].set(qp.pos_coef)
    l = l.at[:, N + jj].set(qp.pos_l)
    u = u.at[:, N + jj].set(qp.pos_u)

    # vel rows (t < W-1)
    A0 = A0.at[:-1, 2 * N + jj, N + jj].set(qp.vel_coef)
    l = l.at[:-1, 2 * N + jj].set(qp.vel_l)
    u = u.at[:-1, 2 * N + jj].set(qp.vel_u)

    # acc rows (t < W-2): a0·v_{t+1} + a1·v_t
    a = qp.acc_coef  # (W-2, N, 2)
    A0 = A0.at[: W - 2, 3 * N + jj, N + jj].set(a[..., 1])
    A1 = A1.at[: W - 2, 3 * N + jj, N + jj].set(a[..., 0])
    l = l.at[: W - 2, 3 * N + jj].set(qp.acc_l)
    u = u.at[: W - 2, 3 * N + jj].set(qp.acc_u)

    # workspace + obstacle rows
    off = 4 * N
    for b in range(nb):
        if qp.gripper_flags[b]:
            for ax in range(3):
                A0 = A0.at[:, off, :N].set(qp.ws_jac[b, :, ax, :])
                l = l.at[:, off].set(qp.ws_l[b, :, ax])
                u = u.at[:, off].set(qp.ws_u[b, :, ax])
                off += 1
        for o in range(qp.n_obstacles):
            A0 = A0.at[:, off, :N].set(qp.obs_jac[b, o])
            l = l.at[:, off].set(qp.obs_l[b, o])
            u = u.at[:, off].set(qp.obs_u[b, o])
            off += 1

    # Interleave q: reference layout [q..., v...] → (W, B).
    qv = qp.q_vec
    q_wb = jnp.concatenate(
        [qv[: W * N].reshape(W, N), qv[W * N :].reshape(W, N)], axis=1
    )
    P_lower = jnp.concatenate(
        [qp.P_lower, jnp.zeros((1, B, B), dt_)]
    ) if W > 1 else jnp.zeros((1, B, B), dt_)

    banded = BandedQP(
        waypoints=W, block=B, rows_per_wp=r,
        P_diag=qp.P_diag, P_lower=P_lower, q_wb=q_wb,
        A0=A0, A1=A1, l_wr=l, u_wr=u,
    )

    # Compact-row → banded-flat-row map (host-side).
    row_map = []
    for t in range(W - 1):
        row_map.extend(t * r + j for j in range(N))  # dyn
    for t in range(W):
        row_map.extend(t * r + N + j for j in range(N))  # pos
    for t in range(W - 1):
        row_map.extend(t * r + 2 * N + j for j in range(N))  # vel
    for t in range(W - 2):
        row_map.extend(t * r + 3 * N + j for j in range(N))  # acc
    woff = 4 * N
    boff = [0] * nb
    k = 0
    for b in range(nb):
        boff[b] = k
        k += (3 if qp.gripper_flags[b] else 0) + qp.n_obstacles
    for b in range(nb):
        rpw = (3 if qp.gripper_flags[b] else 0) + qp.n_obstacles
        for t in range(W):
            for j in range(rpw):
                row_map.append(t * r + woff + boff[b] + j)
    return banded, np.asarray(row_map)


def interleave_state(x_ref, W: int, N: int):
    """Reference layout [q..., v...] → interleaved flat (W·2N,)."""
    return jnp.concatenate(
        [x_ref[: W * N].reshape(W, N), x_ref[W * N :].reshape(W, N)], axis=1
    ).reshape(-1)


def deinterleave_state(x_int, W: int, N: int):
    s = x_int.reshape(W, 2 * N)
    return jnp.concatenate([s[:, :N].reshape(-1), s[:, N:].reshape(-1)])


# ---------------------------------------------------------------------------
# Horizon-sharded container (lives inside shard_map)
# ---------------------------------------------------------------------------


@struct.dataclass
class ShardedBandedQP(BandedQP):
    """Per-device chunk of a :class:`BandedQP` (must run inside ``shard_map``
    over ``axis``): ``waypoints`` is the local slot count ``Ws`` (``Ws−1``
    interior + the right separator), all leaves are local chunks, and the
    operator protocol exchanges only O(B) halos / O(K·B) separator data.

    ``local_chunks > 1`` switches each device's INTERIOR factor/solve from
    the sequential block-tridiagonal scan to a device-local Schur split
    (``parallel/schur.py``) — two-level decomposition.  The scan at small B
    is a long chain of tiny latency-bound steps on an accelerator, so
    chunking the local interior can recover the device even when the mesh
    axis is short.  The best ``local_chunks`` on a GPU is not measured yet;
    1 (off) on CPU.
    """

    n_chunks: int = struct.field(pytree_node=False, default=2)
    total_waypoints: int = struct.field(pytree_node=False, default=0)
    axis: str = struct.field(pytree_node=False, default=HORIZON_AXIS)
    local_chunks: int = struct.field(pytree_node=False, default=1)

    def _interior_backend(self):
        if self.local_chunks > 1:
            from .schur import schur_factor, schur_solve_cached

            return (
                lambda D, L: schur_factor(D, L, self.local_chunks),
                schur_solve_cached,
            )
        return block_tridiag_factor, block_tridiag_solve

    # collective-aware reductions in ops/admm.py + ops/ruiz.py key off this:
    @property
    def collective_axis(self):
        return self.axis

    @property
    def n_valid_mask(self):
        """Local (n,) bool: True for state entries of real (unpadded)
        waypoints."""
        Ws, B = self.waypoints, self.block
        k = jax.lax.axis_index(self.axis)
        g = k * Ws + jnp.arange(Ws)
        return jnp.repeat(g < self.total_waypoints, B)

    # ---------------------------------------------------------------- halos

    def _from_right(self, v):
        """Right neighbour's ``v`` (device K−1 receives zeros)."""
        K = self.n_chunks
        return jax.lax.ppermute(
            v, self.axis, [(i, i - 1) for i in range(1, K)]
        )

    def _from_left(self, v):
        """Left neighbour's ``v`` (device 0 receives zeros)."""
        K = self.n_chunks
        return jax.lax.ppermute(
            v, self.axis, [(i, i + 1) for i in range(K - 1)]
        )

    # ------------------------------------------------------------ operators

    def A_matvec(self, x):
        s = self._s(x)
        s_ext = jnp.concatenate([s[1:], self._from_right(s[0])[None]])
        z = jnp.einsum("trb,tb->tr", self.A0, s)
        z = z + jnp.einsum("trb,tb->tr", self.A1, s_ext)
        return z.reshape(-1)

    def AT_matvec(self, y):
        yv = y.reshape(self.waypoints, self.rows_per_wp)
        out = jnp.einsum("trb,tr->tb", self.A0, yv)
        carry = jnp.einsum("trb,tr->tb", self.A1, yv)
        out = out.at[1:].add(carry[:-1])
        out = out.at[0].add(self._from_left(carry[-1]))
        return out.reshape(-1)

    def P_matvec(self, x):
        s = self._s(x)
        y = jnp.einsum("tij,tj->ti", self.P_diag, s)
        y = y.at[1:].add(jnp.einsum("tij,tj->ti", self.P_lower[:-1], s[:-1]))
        y = y.at[:-1].add(jnp.einsum("tji,tj->ti", self.P_lower[:-1], s[1:]))
        # cross-chunk terms via the last coupling block
        y = y.at[0].add(self._from_left(self.P_lower[-1] @ s[-1]))
        y = y.at[-1].add(self.P_lower[-1].T @ self._from_right(s[0]))
        return y.reshape(-1)

    # ------------------------------------------------------------ Ruiz norms

    def A_col_absmax(self):
        c0 = jnp.max(jnp.abs(self.A0), axis=1)
        c1 = jnp.max(jnp.abs(self.A1), axis=1)
        cols = c0.at[1:].max(c1[:-1])
        cols = cols.at[0].max(self._from_left(c1[-1]))
        return cols.reshape(-1)

    def P_col_absmax(self):
        d = jnp.max(jnp.abs(self.P_diag), axis=1)
        # P_lower[t] = M[t+1, t]: its columns belong to block t (all local,
        # incl. the cross-chunk block), its rows to block t+1 (shift; the
        # last one lands on the neighbour's first block).
        lo_col = jnp.max(jnp.abs(self.P_lower), axis=1)
        lo_row = jnp.max(jnp.abs(self.P_lower), axis=2)
        d = jnp.maximum(d, lo_col)
        d = d.at[1:].max(lo_row[:-1])
        d = d.at[0].max(self._from_left(lo_row[-1]))
        return d.reshape(-1)

    # -------------------------------------------------------------- scaling

    def scale_data(self, D, E, c):
        W, B, r = self.waypoints, self.block, self.rows_per_wp
        Dv = D.reshape(W, B)
        Ev = E.reshape(W, r)
        D_next = jnp.concatenate([Dv[1:], self._from_right(Dv[0])[None]])
        return self.replace(
            P_diag=c * Dv[:, :, None] * self.P_diag * Dv[:, None, :],
            P_lower=c * D_next[:, :, None] * self.P_lower * Dv[:, None, :],
            q_wb=c * Dv * self.q_wb,
            A0=Ev[:, :, None] * self.A0 * Dv[:, None, :],
            A1=Ev[:, :, None] * self.A1 * D_next[:, None, :],
            l_wr=Ev * self.l_wr,
            u_wr=Ev * self.u_wr,
        )

    # ------------------------------------------------------------- KKT path

    def kkt_blocks(self, rho_vec, sigma):
        W, B = self.waypoints, self.block
        rv = rho_vec.reshape(W, self.rows_per_wp)
        diag = self.P_diag + sigma * jnp.eye(B, dtype=self.P_diag.dtype)
        diag = diag + jnp.einsum("tri,tr,trj->tij", self.A0, rv, self.A0)
        c1 = jnp.einsum("tri,tr,trj->tij", self.A1, rv, self.A1)
        diag = diag.at[1:].add(c1[:-1])
        diag = diag.at[0].add(self._from_left(c1[-1]))
        lower = self.P_lower + jnp.einsum(
            "tri,tr,trj->tij", self.A1, rv, self.A0
        )
        return diag, lower  # lower has Ws blocks; last couples the neighbour

    def kkt_factor(self, rho_vec, sigma):
        K = self.n_chunks
        diag, lower = self.kkt_blocks(rho_vec, sigma)
        Di = diag[:-1]  # (Ws-1, B, B) interior
        sepD = diag[-1]  # my separator diagonal
        Li = lower[:-2] if self.waypoints > 2 else lower[:0]
        Lleft = lower[-2]  # M[s_k, last interior]
        Lright = self._from_left(lower[-1])  # M[first interior, s_{k-1}]
        interior, U, V, C_right, C_left, C_off = _chunk_factor(
            Di, Li, Lleft, Lright, backend=self._interior_backend()
        )
        if K == 1:
            # No separators (the single chunk's separator slot is padding,
            # pinned to zero in kkt_solve) — plain interior factorization.
            return dict(
                interior=interior, U=U, V=V, Lleft=Lleft, Lright=Lright,
                reduced=None,
            )
        gather = lambda v: jax.lax.all_gather(v, self.axis)
        sepD_all = gather(sepD)
        C_right_all = gather(C_right)
        C_left_all = gather(C_left)
        C_off_all = gather(C_off)
        Sdiag = sepD_all[: K - 1] - C_right_all[: K - 1] - C_left_all[1:K]
        Slower = -jnp.swapaxes(C_off_all[1 : K - 1], -1, -2)
        reduced = block_tridiag_factor(Sdiag, Slower)
        return dict(
            interior=interior, U=U, V=V, Lleft=Lleft, Lright=Lright,
            reduced=reduced,
        )

    def kkt_solve(self, f, rhs):
        K = self.n_chunks
        _, interior_solve = self._interior_backend()
        b = self._s(rhs)
        bi, bs = b[:-1], b[-1]
        w = interior_solve(f["interior"], bi)  # local interior
        if K == 1:
            # Separator slot is padding (partition_banded guarantees
            # K·Ws ≥ W+1): interior solve is the whole answer.
            return jnp.concatenate([w, jnp.zeros_like(w[:1])]).reshape(-1)
        r_right = f["Lleft"] @ w[-1]
        r_left = f["Lright"].T @ w[0]
        gather = lambda v: jax.lax.all_gather(v, self.axis)
        bs_all = gather(bs)
        r_right_all = gather(r_right)
        r_left_all = gather(r_left)
        rS = bs_all[: K - 1] - r_right_all[: K - 1] - r_left_all[1:K]
        xs = block_tridiag_solve(f["reduced"], rS)  # replicated tiny solve

        k = jax.lax.axis_index(self.axis)
        B = w.shape[-1]
        zero = jnp.zeros((B,), w.dtype)
        x_right = jnp.where(k < K - 1, xs[jnp.minimum(k, K - 2)], zero)
        x_left = jnp.where(k > 0, xs[jnp.maximum(k - 1, 0)], zero)
        xi = (
            w
            - jnp.einsum("wbr,r->wb", f["U"], x_right)
            - jnp.einsum("wbr,r->wb", f["V"], x_left)
        )
        # interior stays local — only the separator values crossed devices.
        return jnp.concatenate([xi, x_right[None]]).reshape(-1)


# ---------------------------------------------------------------------------
# Partition / solve driver
# ---------------------------------------------------------------------------


def partition_banded(qp: BandedQP, n_chunks: int):
    """Pad the horizon to ``K·Ws`` and reshape every leaf to a leading
    ``(K,)`` chunk axis for ``shard_map``.  Padded slots: identity P-diag,
    zero coupling/rows, ±INF bounds, zero q."""
    K = n_chunks
    W, B, r = qp.waypoints, qp.block, qp.rows_per_wp
    # The LAST device's separator slot must be padding (there are only K−1
    # real separators): require K·Ws ≥ W+1 so global slot K·Ws−1 is padded.
    Ws = max(2, -(-(W + 1) // K))
    Wp = K * Ws
    pad = Wp - W
    dt_ = qp.q_wb.dtype

    eye = jnp.broadcast_to(jnp.eye(B, dtype=dt_), (pad, B, B))
    P_diag = jnp.concatenate([qp.P_diag, eye])
    P_lower = jnp.concatenate([qp.P_lower, jnp.zeros((pad, B, B), dt_)])
    # zero the (real) coupling of the last real waypoint into padding
    if pad:
        P_lower = P_lower.at[W - 1].set(0.0)
    q_wb = jnp.concatenate([qp.q_wb, jnp.zeros((pad, B), dt_)])
    A0 = jnp.concatenate([qp.A0, jnp.zeros((pad, r, B), dt_)])
    A1 = jnp.concatenate([qp.A1, jnp.zeros((pad, r, B), dt_)])
    if pad:
        A1 = A1.at[W - 1].set(0.0)
    l = jnp.concatenate([qp.l_wr, jnp.full((pad, r), -INF, dt_)])
    u = jnp.concatenate([qp.u_wr, jnp.full((pad, r), INF, dt_)])

    def chunk(a):
        return a.reshape((K, Ws) + a.shape[1:])

    return (
        dict(
            P_diag=chunk(P_diag), P_lower=chunk(P_lower), q_wb=chunk(q_wb),
            A0=chunk(A0), A1=chunk(A1), l_wr=chunk(l), u_wr=chunk(u),
        ),
        Ws,
    )


import functools  # noqa: E402


@functools.lru_cache(maxsize=64)
def _sharded_solve_fn(mesh: Mesh, settings, axis: str, Ws: int, B: int,
                      r: int, K: int, W: int, leaf_keys,
                      local_chunks: int = 1):
    """Build (and cache) the jitted shard_map program for one static
    configuration — repeated solves (timing loops, MPC) must not re-trace."""

    def device_fn(leaves, warm):
        local = {k: v[0] for k, v in leaves.items()}
        sq = ShardedBandedQP(
            waypoints=Ws, block=B, rows_per_wp=r,
            n_chunks=K, total_waypoints=W, axis=axis,
            local_chunks=local_chunks, **local,
        )
        res = admm_mod.solve(sq, settings, warm_x=warm[0])
        # x/y/z local shards → leading chunk axis for the out-spec.
        return admm_mod.SolveResult(
            x=res.x[None], y=res.y[None], z=res.z[None],
            status=res.status, iterations=res.iterations,
            prim_res=res.prim_res, dual_res=res.dual_res,
            rho=res.rho, obj_val=res.obj_val,
        )

    out_specs = admm_mod.SolveResult(
        x=P(axis), y=P(axis), z=P(axis),
        status=P(), iterations=P(), prim_res=P(), dual_res=P(),
        rho=P(), obj_val=P(),
    )
    fn = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=({k: P(axis) for k in leaf_keys}, P(axis)),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def solve_banded_sharded(
    qp: BandedQP,
    mesh: Mesh,
    settings: admm_mod.Settings = admm_mod.Settings(),
    warm_x: Optional[jnp.ndarray] = None,
    axis: str = HORIZON_AXIS,
    local_chunks: int = 1,
) -> admm_mod.SolveResult:
    """Full OSQP-semantics ADMM for ONE long-horizon QP, with state, data,
    and KKT all sharded over ``mesh[axis]`` — per-iteration communication is
    O(K·B) separator exchange + O(B) halos + scalar reductions
    (VERDICT r1 next #3: no full-interior ``all_gather`` anywhere).

    ``warm_x`` is in interleaved ``(W·B,)`` layout.  The returned
    ``SolveResult`` has ``x``/``y``/``z`` gathered back to global layout
    (interleaved state, padded rows dropped) for caller convenience —
    production users keep results sharded by composing ``shard_map``
    themselves.
    """
    K = mesh.shape[axis]
    W, B, r = qp.waypoints, qp.block, qp.rows_per_wp
    chunks, Ws = partition_banded(qp, K)
    if warm_x is None:
        warm_x = jnp.zeros(W * B, qp.q_wb.dtype)
    warm_pad = jnp.concatenate(
        [jnp.asarray(warm_x, qp.q_wb.dtype),
         jnp.zeros((K * Ws - W) * B, qp.q_wb.dtype)]
    ).reshape(K, Ws * B)

    jitted = _sharded_solve_fn(
        mesh, settings, axis, Ws, B, r, K, W,
        tuple(sorted(chunks.keys())), local_chunks,
    )
    res = jitted(chunks, warm_pad)
    # Drop horizon padding; rows back to global banded order.
    x = res.x.reshape(K * Ws, B)[:W].reshape(-1)
    z = res.z.reshape(K * Ws, r)[:W].reshape(-1)
    y = res.y.reshape(K * Ws, r)[:W].reshape(-1)
    return res.replace(x=x, y=y, z=z)


# ---------------------------------------------------------------------------
# 2-D (batch, horizon) mesh: independent problems × sharded horizons
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _sharded_solve_2d_fn(mesh: Mesh, settings, baxis: str, haxis: str,
                         Ws: int, B: int, r: int, Kh: int, W: int,
                         leaf_keys, per: int = 1):
    """Jitted 2-D program: problems sharded over ``baxis`` (``per`` problems
    per batch row — on a cluster that axis is laid ACROSS hosts, over
    the network, since no solver collective crosses it), each problem\'s
    horizon sharded over ``haxis`` (within a host, NVLink).  All collectives are
    emitted on ``haxis`` only; the ``per`` local problems run vmapped
    (batched collectives + the solver\'s own masked convergence)."""

    def device_fn(leaves, warm):
        local = {k: v[0, :, 0] for k, v in leaves.items()}  # (per, ...)

        def solve_one(leaf_vals, w):
            sq = ShardedBandedQP(
                waypoints=Ws, block=B, rows_per_wp=r,
                n_chunks=Kh, total_waypoints=W, axis=haxis,
                **dict(zip(sorted(local), leaf_vals)),
            )
            return admm_mod.solve(sq, settings, warm_x=w)

        res = jax.vmap(lambda *a: solve_one(a[:-1], a[-1]))(
            *[local[k] for k in sorted(local)], warm[0, :, 0]
        )
        return admm_mod.SolveResult(
            x=res.x[None, :, None], y=res.y[None, :, None],
            z=res.z[None, :, None],
            status=res.status[None], iterations=res.iterations[None],
            prim_res=res.prim_res[None], dual_res=res.dual_res[None],
            rho=res.rho[None], obj_val=res.obj_val[None],
        )

    out_specs = admm_mod.SolveResult(
        x=P(baxis, None, haxis), y=P(baxis, None, haxis),
        z=P(baxis, None, haxis),
        status=P(baxis), iterations=P(baxis), prim_res=P(baxis),
        dual_res=P(baxis), rho=P(baxis), obj_val=P(baxis),
    )
    fn = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(
            {k: P(baxis, None, haxis) for k in leaf_keys},
            P(baxis, None, haxis),
        ),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def solve_banded_sharded_2d(
    qps: BandedQP,
    mesh: Mesh,
    settings: admm_mod.Settings = admm_mod.Settings(),
    warm_x: Optional[jnp.ndarray] = None,
    batch_axis: Optional[str] = None,
    axis: str = HORIZON_AXIS,
) -> admm_mod.SolveResult:
    """Batch of long-horizon QPs on the full 2-D ``(batch, horizon)`` mesh
    (SURVEY.md §2.3 mesh design): independent problems ride the batch axis,
    each problem's state/data/KKT shard over the horizon axis exactly as in
    :func:`solve_banded_sharded` (separator-only collectives).

    ``qps`` is a :class:`BandedQP` whose leaves carry a leading problem
    axis — any positive multiple of ``mesh.shape[batch_axis]`` (problems
    beyond one-per-row run vmapped inside each shard, with the solver's
    masked convergence); ``warm_x`` is ``(n_problems, W·B)`` interleaved,
    or None.  Returns a batch-leading :class:`SolveResult` in global
    banded layout.
    """
    from .mesh import BATCH_AXIS

    baxis = batch_axis or BATCH_AXIS
    Kb = mesh.shape[baxis]
    Kh = mesh.shape[axis]
    W, B, r = qps.waypoints, qps.block, qps.rows_per_wp
    nb = jax.tree_util.tree_leaves(qps)[0].shape[0]
    per, rem = divmod(nb, Kb)
    assert per >= 1 and rem == 0, (
        f"{nb} problems must be a positive multiple of the {Kb} mesh "
        f"batch rows"
    )

    data_fields = ("P_diag", "P_lower", "q_wb", "A0", "A1", "l_wr", "u_wr")
    parts, Ws = [], None
    for i in range(nb):
        ch, Ws = partition_banded(
            BandedQP(waypoints=W, block=B, rows_per_wp=r,
                     **{k: getattr(qps, k)[i] for k in data_fields}),
            Kh,
        )
        parts.append(ch)
    # (nb, Kh, ...) -> (Kb, per, Kh, ...): row-major problem placement.
    chunks = {
        k: jnp.stack([p[k] for p in parts]).reshape(
            (Kb, per) + parts[0][k].shape
        )
        for k in parts[0]
    }

    if warm_x is None:
        warm_x = jnp.zeros((nb, W * B), qps.q_wb.dtype)
    warm_pad = jnp.concatenate(
        [jnp.asarray(warm_x, qps.q_wb.dtype),
         jnp.zeros((nb, (Kh * Ws - W) * B), qps.q_wb.dtype)],
        axis=1,
    ).reshape(Kb, per, Kh, Ws * B)

    jitted = _sharded_solve_2d_fn(
        mesh, settings, baxis, axis, Ws, B, r, Kh, W,
        tuple(sorted(chunks.keys())), per,
    )
    res = jitted(chunks, warm_pad)
    x = res.x.reshape(nb, Kh * Ws, B)[:, :W].reshape(nb, -1)
    z = res.z.reshape(nb, Kh * Ws, r)[:, :W].reshape(nb, -1)
    y = res.y.reshape(nb, Kh * Ws, r)[:, :W].reshape(nb, -1)
    st = res.status.reshape(nb)
    it = res.iterations.reshape(nb)
    return res.replace(
        x=x, y=y, z=z, status=st, iterations=it,
        prim_res=res.prim_res.reshape(nb), dual_res=res.dual_res.reshape(nb),
        rho=res.rho.reshape(nb), obj_val=res.obj_val.reshape(nb),
    )
