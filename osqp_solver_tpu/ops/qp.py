"""QP problem containers and the operator protocol the ADMM core solves.

The JAX-native replacement for OSQP's CSC-sparse problem data
(``/root/reference/src/osqp-wrapper.h:16-31``): problems are pytree
dataclasses with *static shapes*, and every structure the solver needs is
exposed through a small operator protocol so the same ADMM core runs on

* :class:`DenseQP` — dense ``P``/``A`` (batches of small problems; Cholesky
  of the reduced KKT, XLA's batched Cholesky), and
* the block-tridiagonal trajectory QP in
  :mod:`osqp_solver_tpu.gomp.trajectory_qp` (banded KKT, scan solves).

Protocol (duck-typed; all methods jit/vmap-safe, shapes static):

- ``q, l, u``           : flat ``(n,)`` / ``(m,)`` arrays
- ``P_matvec(x)``, ``A_matvec(x)``, ``AT_matvec(y)``
- ``P_col_absmax()``, ``A_col_absmax()``, ``A_row_absmax()``  (Ruiz norms)
- ``scale_data(D, E, c)`` → same type, data scaled (P̄=cDPD, Ā=EAD, q̄=cDq,
  ``l̄``/``ū`` = E·l/u)
- ``kkt_factor(rho_vec, sigma)`` → factor pytree for the reduced KKT
  ``P + σI + Aᵀdiag(ρ)A`` ; ``kkt_solve(factor, rhs)`` → x
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from .. import struct

# Accelerator f32 matmuls may default to reduced precision (bf16 passes,
# TF32); ADMM needs the real thing — exact accumulation keeps factor/solve
# consistent and convergence fast.
_HI = jax.lax.Precision.HIGHEST


@struct.dataclass
class DenseQP:
    """min ½xᵀPx + qᵀx  s.t.  l ≤ Ax ≤ u, with dense P (n,n) and A (m,n)."""

    P: jnp.ndarray
    q: jnp.ndarray
    A: jnp.ndarray
    l: jnp.ndarray
    u: jnp.ndarray

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    # --- operators ----------------------------------------------------------

    def P_matvec(self, x):
        return jnp.matmul(self.P, x, precision=_HI)

    def A_matvec(self, x):
        return jnp.matmul(self.A, x, precision=_HI)

    def AT_matvec(self, y):
        return jnp.matmul(self.A.T, y, precision=_HI)

    # --- Ruiz norms ---------------------------------------------------------

    def P_col_absmax(self):
        return jnp.max(jnp.abs(self.P), axis=0)

    def A_col_absmax(self):
        return jnp.max(jnp.abs(self.A), axis=0) if self.m else jnp.zeros(self.n)

    def A_row_absmax(self):
        return jnp.max(jnp.abs(self.A), axis=1) if self.m else self.l

    # --- scaling ------------------------------------------------------------

    def scale_data(self, D, E, c):
        return DenseQP(
            P=c * (D[:, None] * self.P * D[None, :]),
            q=c * D * self.q,
            A=E[:, None] * self.A * D[None, :],
            l=E * self.l,
            u=E * self.u,
        )

    # --- reduced KKT --------------------------------------------------------

    def kkt_factor(self, rho_vec, sigma):
        """Cholesky of ``P + σI + Aᵀ diag(ρ) A`` (SPD by construction — the
        JAX-native analogue of qdldl's LDLᵀ of the quasi-definite KKT used by
        OSQP, SURVEY.md §2.2)."""
        n = self.n
        M = self.P + sigma * jnp.eye(n, dtype=self.P.dtype)
        M = M + jnp.matmul(self.A.T, rho_vec[:, None] * self.A, precision=_HI)
        return jnp.linalg.cholesky(M)

    def kkt_solve(self, factor, rhs):
        z = jax.scipy.linalg.solve_triangular(factor, rhs, lower=True)
        return jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(factor, -1, -2), z, lower=False
        )


def dense_qp(P, q, A, l, u, dtype=None) -> DenseQP:
    """Build a :class:`DenseQP` from array-likes, upcasting to a common dtype."""
    arrs = [jnp.asarray(v) for v in (P, q, A, l, u)]
    if dtype is not None:
        arrs = [a.astype(dtype) for a in arrs]
    return DenseQP(*arrs)
