"""Distributed block-tridiagonal solve via Schur-complement reduction.

The "sequence-parallel" analogue for long trajectory horizons
(SURVEY.md §2.3 / §5): the banded KKT system couples only neighbouring
waypoints (``constraint-builder.h:203-219``), so a ``W``-block tridiagonal
system is partitioned over the mesh ``horizon`` axis as::

    [ chunk_0 interior | s_0 | chunk_1 interior | s_1 | ... | chunk_{K-1} ]

with one ``B×B`` separator block ``s_k`` between adjacent chunks.  Each
device factors its interior independently (scan-based block Cholesky), forms
its contributions to the small ``(K-1)·B`` separator Schur system, the
contributions are ``all_gather``-ed over the mesh, every device redundantly solves
the reduced tridiagonal system (it is tiny), and back-substitution is local.
One collective round-trip per solve; interior work scales 1/K.

Layout is uniform across devices (SPMD): arrays carry a leading ``K`` chunk
axis; device ``K-1`` holds dummy separator slots (identity blocks, zero
coupling) so shapes match.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from .. import struct
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.tridiag import block_tridiag_factor, block_tridiag_solve
from .mesh import HORIZON_AXIS


@struct.dataclass
class ChunkedTridiag:
    """Block-tridiagonal system partitioned into K uniform chunks.

    ``Di``/``Li``: per-chunk interior tridiag ``(K, Wl, B, B)`` /
    ``(K, Wl-1, B, B)``; ``sepD`` separator diagonal blocks ``(K, B, B)``
    (slot ``K-1`` is a dummy identity); ``Lleft[k] = M[s_k, last_int_k]``,
    ``Lright[k] = M[first_int_k, s_{k-1}]`` (dummy-zero at the edges).
    ``n_blocks`` (the original W before padding) is static metadata so the
    container can be carried through scans/while-loops without tracing it.
    """

    Di: jnp.ndarray
    Li: jnp.ndarray
    sepD: jnp.ndarray
    Lleft: jnp.ndarray
    Lright: jnp.ndarray
    n_blocks: int = struct.field(pytree_node=False, default=0)


def partition_blocks(diag, lower, n_chunks: int) -> ChunkedTridiag:
    """Split a global ``(W, B, B)`` tridiagonal into K uniform chunks,
    padding the tail with identity blocks so ``W_pad = K·Wl + (K-1)``."""
    W, B, _ = diag.shape
    K = n_chunks
    Wl = -(-(W - (K - 1)) // K)  # ceil interior size
    W_pad = K * Wl + (K - 1)
    pad = W_pad - W
    if pad:
        eye = jnp.broadcast_to(jnp.eye(B, dtype=diag.dtype), (pad, B, B))
        diag = jnp.concatenate([diag, eye])
        zl = jnp.zeros((pad, B, B), dtype=diag.dtype)
        lower = jnp.concatenate([lower, zl]) if W > 1 else zl
    # lower now has W_pad - 1 blocks
    stride = Wl + 1
    idx = jnp.arange(K)
    int_rows = idx[:, None] * stride + jnp.arange(Wl)[None, :]  # (K, Wl)
    Di = diag[int_rows]
    Li = lower[idx[:, None] * stride + jnp.arange(max(Wl - 1, 0))[None, :]]
    sep_rows = idx * stride + Wl  # s_k global index (K-1 real + 1 dummy)
    sepD = jnp.where(
        (idx < K - 1)[:, None, None],
        diag[jnp.minimum(sep_rows, W_pad - 1)],
        jnp.eye(B, dtype=diag.dtype)[None],
    )
    # Lleft[k] = lower[s_k - 1]; Lright[k] = lower[s_{k-1}]
    Lleft = jnp.where(
        (idx < K - 1)[:, None, None],
        lower[jnp.minimum(sep_rows - 1, W_pad - 2)],
        0.0,
    )
    prev_sep = jnp.maximum(idx - 1, 0) * stride + Wl
    Lright = jnp.where(
        (idx > 0)[:, None, None], lower[jnp.minimum(prev_sep, W_pad - 2)], 0.0
    )
    return ChunkedTridiag(Di=Di, Li=Li, sepD=sepD, Lleft=Lleft, Lright=Lright, n_blocks=W)


def partition_rhs(b, n_chunks: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split rhs ``(W, B)`` into interior ``(K, Wl, B)`` + separator ``(K, B)``."""
    W, B = b.shape
    K = n_chunks
    Wl = -(-(W - (K - 1)) // K)
    W_pad = K * Wl + (K - 1)
    if W_pad > W:
        b = jnp.concatenate([b, jnp.zeros((W_pad - W, B), b.dtype)])
    stride = Wl + 1
    idx = jnp.arange(K)
    bi = b[idx[:, None] * stride + jnp.arange(Wl)[None, :]]
    sep_rows = jnp.minimum(idx * stride + Wl, W_pad - 1)
    bs = jnp.where((idx < K - 1)[:, None], b[sep_rows], 0.0)
    return bi, bs


def merge_solution(xi, xs, n_blocks: int):
    """Inverse of the partition: interleave interiors and separators back
    into a global ``(W, B)`` solution."""
    K, Wl, B = xi.shape
    parts = []
    for k in range(K):
        parts.append(xi[k])
        if k < K - 1:
            parts.append(xs[k][None])
    return jnp.concatenate(parts)[:n_blocks]


@struct.dataclass
class SchurFactor:
    """Cached distributed factorization: per-chunk interior Cholesky factors,
    the interface solve matrices U/V, the Schur contributions, and the
    factored reduced separator system.  Computing this once and reusing it
    across ADMM iterations mirrors the qdldl factor cache
    (``osqp-wrapper.h:33-43`` semantics) at multi-device scale."""

    chunks: ChunkedTridiag
    interior: object  # BlockTridiagFactor with leading (K,) chunk axis
    U: jnp.ndarray  # (K, Wl, B, B) interface columns for s_k
    V: jnp.ndarray  # (K, Wl, B, B) interface columns for s_{k-1}
    reduced: object  # BlockTridiagFactor of the (K-1)-separator system
    corr: Tuple  # (C_right, C_left, C_off) gathered (K, B, B) arrays


def _chunk_factor(Di, Li, Lleft, Lright, backend=None):
    """Factor one chunk interior and its interface solve matrices.

    ``backend``: optional ``(factor_fn, solve_fn)`` pair replacing the
    sequential block-tridiagonal scan — e.g. a nested Schur split of the
    interior (two-level decomposition, ``parallel/banded.py``
    ``local_chunks``)."""
    factor_fn, solve_fn = backend or (block_tridiag_factor, block_tridiag_solve)
    factor = factor_fn(Di, Li)
    Wl, B = Di.shape[0], Di.shape[1]

    def solve_cols(rhs_block, position):
        rhs = jnp.zeros((Wl, B, B), Di.dtype).at[position].set(rhs_block)
        return jax.vmap(
            lambda col: solve_fn(factor, col), in_axes=-1, out_axes=-1
        )(rhs)

    U = solve_cols(Lleft.T, Wl - 1)
    V = solve_cols(Lright, 0)
    return factor, U, V, Lleft @ U[-1], Lright.T @ V[0], Lright.T @ U[0]


def schur_factor(diag, lower, n_chunks: int) -> SchurFactor:
    """Factor the partitioned system once (vmap-over-chunks reference
    implementation; the sharded path computes the same pieces per device)."""
    ch = partition_blocks(diag, lower, n_chunks)
    interior, U, V, C_right, C_left, C_off = jax.vmap(_chunk_factor)(
        ch.Di, ch.Li, ch.Lleft, ch.Lright
    )
    K = n_chunks
    Sdiag = ch.sepD[: K - 1] - C_right[: K - 1] - C_left[1:K]
    Slower = -jnp.swapaxes(C_off[1 : K - 1], -1, -2)
    reduced = block_tridiag_factor(Sdiag, Slower)
    return SchurFactor(
        chunks=ch, interior=interior, U=U, V=V, reduced=reduced,
        corr=(C_right, C_left, C_off),
    )


def schur_solve_cached(sf: SchurFactor, b):
    """Solve with a cached :class:`SchurFactor` (per-ADMM-iteration path)."""
    K = sf.chunks.Di.shape[0]
    bi, bs = partition_rhs(b, K)
    w = jax.vmap(block_tridiag_solve)(sf.interior, bi)  # (K, Wl, B)
    r_right = jnp.einsum("kij,kj->ki", sf.chunks.Lleft, w[:, -1])
    r_left = jnp.einsum("kji,kj->ki", sf.chunks.Lright, w[:, 0])
    rS = bs[: K - 1] - r_right[: K - 1] - r_left[1:K]
    xs = block_tridiag_solve(sf.reduced, rS)

    def back(k, w_k, U_k, V_k):
        B = w_k.shape[-1]
        zero = jnp.zeros((B,), w_k.dtype)
        x_right = jnp.where(k < K - 1, xs[jnp.minimum(k, K - 2)], zero)
        x_left = jnp.where(k > 0, xs[jnp.maximum(k - 1, 0)], zero)
        return (
            w_k
            - jnp.einsum("wbr,r->wb", U_k, x_right)
            - jnp.einsum("wbr,r->wb", V_k, x_left)
        )

    xi = jax.vmap(back)(jnp.arange(K), w, sf.U, sf.V)
    return merge_solution(xi, xs, sf.chunks.n_blocks)


def _chunk_local(Di, Li, Lleft, Lright, bi):
    """Per-chunk dense work: factor the interior and push the three RHS
    families through it.  Returns the pieces needed for the Schur system."""
    factor = block_tridiag_factor(Di, Li)
    w = block_tridiag_solve(factor, bi)  # (Wl, B)
    Wl, B = bi.shape

    def solve_cols(rhs_block, position):
        rhs = jnp.zeros((Wl, B, B), Di.dtype).at[position].set(rhs_block)
        return jax.vmap(
            lambda col: block_tridiag_solve(factor, col), in_axes=-1, out_axes=-1
        )(rhs)

    U = solve_cols(Lleft.T, Wl - 1)  # columns for the right separator s_k
    V = solve_cols(Lright, 0)  # columns for the left separator s_{k-1}
    return dict(
        factor=factor,
        w=w,
        U=U,
        V=V,
        # Schur contributions (B, B):
        C_right=Lleft @ U[-1],  # into S_{s_k, s_k} from this chunk
        C_left=Lright.T @ V[0],  # into S_{s_{k-1}, s_{k-1}}
        C_off=Lright.T @ U[0],  # into S_{s_{k-1}, s_k}
        r_right=Lleft @ w[-1],  # rhs corrections
        r_left=Lright.T @ w[0],
    )


def _reduced_system(sepD, bs, C_right, C_left, C_off, r_right, r_left):
    """Assemble and solve the (K-1)-block separator tridiagonal system from
    gathered per-chunk contributions (runs redundantly on every device)."""
    K = sepD.shape[0]
    Sdiag = sepD[: K - 1] - C_right[: K - 1] - C_left[1:K]
    Slower = -jnp.swapaxes(C_off[1 : K - 1], -1, -2)  # S_{s_{k+1}, s_k}
    rS = bs[: K - 1] - r_right[: K - 1] - r_left[1:K]
    factor = block_tridiag_factor(Sdiag, Slower)
    return block_tridiag_solve(factor, rS)


def _back_substitute(local, xs_all, k, K):
    """x_I^k = w − U·x_{s_k} − V·x_{s_{k-1}} (dummy separators are zero)."""
    B = local["w"].shape[-1]
    zero = jnp.zeros((B,), local["w"].dtype)
    x_right = jnp.where(k < K - 1, xs_all[jnp.minimum(k, K - 2)], zero)
    x_left = jnp.where(k > 0, xs_all[jnp.maximum(k - 1, 0)], zero)
    return (
        local["w"]
        - jnp.einsum("wbr,r->wb", local["U"], x_right)
        - jnp.einsum("wbr,r->wb", local["V"], x_left)
    )


def schur_solve_reference(diag, lower, b, n_chunks: int):
    """Single-device reference of the distributed algorithm (vmap over the
    chunk axis instead of shard_map) — bit-identical math, used by tests and
    as the fallback when no mesh is available."""
    K = n_chunks
    ch = partition_blocks(diag, lower, K)
    bi, bs = partition_rhs(b, K)
    local = jax.vmap(_chunk_local)(ch.Di, ch.Li, ch.Lleft, ch.Lright, bi)
    xs = _reduced_system(
        ch.sepD,
        bs,
        local["C_right"],
        local["C_left"],
        local["C_off"],
        local["r_right"],
        local["r_left"],
    )
    xi = jax.vmap(lambda loc, k: _back_substitute(loc, xs, k, K))(
        local, jnp.arange(K)
    )
    return merge_solution(xi, xs, ch.n_blocks)


def schur_solve_sharded(diag, lower, b, mesh: Mesh, axis: str = HORIZON_AXIS):
    """Distributed solve over ``mesh[axis]``: interiors factor in parallel,
    one ``all_gather`` of (K-1)·B-sized Schur pieces, redundant reduced
    solve, local back-substitution."""
    K = mesh.shape[axis]
    ch = partition_blocks(diag, lower, K)
    bi, bs = partition_rhs(b, K)

    def device_fn(Di, Li, sepD, Lleft, Lright, bi_k, bs_k):
        # Each operand arrives with a leading local chunk axis of size 1.
        local = _chunk_local(Di[0], Li[0], Lleft[0], Lright[0], bi_k[0])
        k = jax.lax.axis_index(axis)
        gather = lambda v: jax.lax.all_gather(v, axis)
        xs = _reduced_system(
            gather(sepD[0]),
            gather(bs_k[0]),
            gather(local["C_right"]),
            gather(local["C_left"]),
            gather(local["C_off"]),
            gather(local["r_right"]),
            gather(local["r_left"]),
        )
        xi = _back_substitute(local, xs, k, K)
        my_sep = xs[jnp.minimum(k, K - 2)] * (k < K - 1)
        return xi[None], my_sep[None]

    spec = P(axis)
    fn = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(spec,) * 7,
        out_specs=(spec, spec),
        check_vma=False,
    )
    xi, xs = jax.jit(fn)(ch.Di, ch.Li, ch.sepD, ch.Lleft, ch.Lright, bi, bs)
    return merge_solution(xi, xs[: K - 1], ch.n_blocks)
