"""ctypes bridge to the native C++ OSQP-semantics oracle.

Builds ``native/osqp_oracle.cpp`` on demand with g++ (cached in
``native/build/``) and exposes :func:`solve` with the same semantics as the
JAX ADMM core — used for cross-validation in tests and as the single-thread
CPU baseline anchor (BASELINE.md).  Python↔C++ binding is plain ctypes (no
pybind11 dependency).
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
from typing import NamedTuple, Optional

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "osqp_oracle.cpp"
_BUILD = _ROOT / "native" / "build"
_LIB = _BUILD / "libosqp_oracle.so"

_lib = None


class OracleResult(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    status: int
    iterations: int
    prim_res: float
    dual_res: float


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _stall_checks_eff(stall_checks: int, stall_min_iters: int,
                      check_every: int) -> int:
    """Same patience floor as ``ops.admm.stall_checks_needed``: the stall
    window must span at least ``stall_min_iters`` iterations at the check
    cadence, so solver<->oracle cross-validation stays exact-count."""
    if stall_checks <= 0:
        return stall_checks
    return max(int(stall_checks), -(-int(stall_min_iters) // max(1, int(check_every))))


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        _BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(_LIB), str(_SRC)],
            check=True,
            capture_output=True,
        )
    lib = ctypes.CDLL(str(_LIB))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.osqp_oracle_solve.restype = ctypes.c_int
    lib.osqp_oracle_solve.argtypes = [
        ctypes.c_int, ctypes.c_int,  # n, m
        dp, dp, dp, dp, dp,  # P q A l u
        dp, dp, ip, dp, dp,  # x y iters prim dual
        ctypes.c_int, ctypes.c_int,  # max_iter check_every
        ctypes.c_double, ctypes.c_double,  # eps_abs eps_rel
        ctypes.c_double, ctypes.c_double,  # eps_prim_inf eps_dual_inf
        ctypes.c_double, ctypes.c_double, ctypes.c_double,  # rho sigma alpha
        ctypes.c_int,  # adaptive_rho
        dp, dp,  # warm_x warm_y (nullable)
        ctypes.c_int, ctypes.c_double,  # stall_checks stall_rtol
    ]
    _lib = lib
    return lib


def solve(
    P,
    q,
    A,
    l,
    u,
    max_iter: int = 4000,
    check_every: int = 25,
    eps_abs: float = 1e-3,
    eps_rel: float = 1e-3,
    eps_prim_inf: float = 1e-4,
    eps_dual_inf: float = 1e-4,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    adaptive_rho: bool = True,
    warm_x: Optional[np.ndarray] = None,
    warm_y: Optional[np.ndarray] = None,
    stall_checks: int = 12,
    stall_rtol: float = 0.05,
    stall_min_iters: int = 36,
) -> OracleResult:
    lib = _load()
    P = np.ascontiguousarray(P, dtype=np.float64)
    q = np.ascontiguousarray(q, dtype=np.float64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    l = np.ascontiguousarray(l, dtype=np.float64)
    u = np.ascontiguousarray(u, dtype=np.float64)
    n, m = q.size, l.size
    x = np.zeros(n)
    y = np.zeros(m)
    iters = ctypes.c_int(0)
    pr = ctypes.c_double(0)
    dr = ctypes.c_double(0)
    dp = ctypes.POINTER(ctypes.c_double)

    def ptr(a):
        return a.ctypes.data_as(dp)

    wx = ptr(np.ascontiguousarray(warm_x, np.float64)) if warm_x is not None else None
    wy = ptr(np.ascontiguousarray(warm_y, np.float64)) if warm_y is not None else None
    status = lib.osqp_oracle_solve(
        n, m, ptr(P), ptr(q), ptr(A), ptr(l), ptr(u),
        ptr(x), ptr(y), ctypes.byref(iters), ctypes.byref(pr), ctypes.byref(dr),
        max_iter, check_every, eps_abs, eps_rel, eps_prim_inf, eps_dual_inf,
        rho, sigma, alpha, int(adaptive_rho), wx, wy,
        int(_stall_checks_eff(stall_checks, stall_min_iters, check_every)),
        float(stall_rtol),
    )
    return OracleResult(
        x=x, y=y, status=int(status), iterations=int(iters.value),
        prim_res=float(pr.value), dual_res=float(dr.value),
    )


def _load_sparse():
    lib = _load()
    if getattr(lib, "_sparse_bound", False):
        return lib
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.osqp_oracle_solve_sparse.restype = ctypes.c_int
    lib.osqp_oracle_solve_sparse.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, m, kb
        ip, ip, dp,  # P CSR
        dp,  # q
        ip, ip, dp,  # A CSR
        dp, dp,  # l u
        dp, dp, ip, dp, dp,  # x y iters prim dual
        ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int,
        dp, dp,
        ctypes.c_int, ctypes.c_double,  # stall_checks stall_rtol
    ]
    lib._sparse_bound = True
    return lib


def solve_sparse(
    P_csr,
    q,
    A_csr,
    l,
    u,
    kb: int,
    max_iter: int = 4000,
    check_every: int = 25,
    eps_abs: float = 1e-3,
    eps_rel: float = 1e-3,
    eps_prim_inf: float = 1e-4,
    eps_dual_inf: float = 1e-4,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    adaptive_rho: bool = True,
    warm_x: Optional[np.ndarray] = None,
    warm_y: Optional[np.ndarray] = None,
    stall_checks: int = 12,
    stall_rtol: float = 0.05,
    stall_min_iters: int = 36,
) -> OracleResult:
    """Sparse-A / banded-KKT oracle (qdldl-equivalent cost model) — makes the
    reference example scale (W=802 ⇒ n=9,624) tractable on CPU.

    ``P_csr``/``A_csr``: ``(indptr, indices, data)`` numpy triples (CSR);
    ``kb``: KKT half-bandwidth — ``4N-1`` for the interleaved trajectory
    ordering (see ``TrajectoryQP.to_csr``)."""
    lib = _load_sparse()
    Pi, Pj, Pd = (np.ascontiguousarray(a) for a in P_csr)
    Ai, Aj, Ad = (np.ascontiguousarray(a) for a in A_csr)
    Pi, Pj = Pi.astype(np.int32), Pj.astype(np.int32)
    Ai, Aj = Ai.astype(np.int32), Aj.astype(np.int32)
    Pd = Pd.astype(np.float64)
    Ad = Ad.astype(np.float64)
    q = np.ascontiguousarray(q, np.float64)
    l = np.ascontiguousarray(l, np.float64)
    u = np.ascontiguousarray(u, np.float64)
    n, m = q.size, l.size
    x = np.zeros(n)
    y = np.zeros(m)
    iters = ctypes.c_int(0)
    pr = ctypes.c_double(0)
    dr = ctypes.c_double(0)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)

    def ptr(a):
        return a.ctypes.data_as(dp)

    def iptr(a):
        return a.ctypes.data_as(ip)

    wx = ptr(np.ascontiguousarray(warm_x, np.float64)) if warm_x is not None else None
    wy = ptr(np.ascontiguousarray(warm_y, np.float64)) if warm_y is not None else None
    status = lib.osqp_oracle_solve_sparse(
        n, m, int(kb), iptr(Pi), iptr(Pj), ptr(Pd), ptr(q),
        iptr(Ai), iptr(Aj), ptr(Ad), ptr(l), ptr(u),
        ptr(x), ptr(y), ctypes.byref(iters), ctypes.byref(pr), ctypes.byref(dr),
        max_iter, check_every, eps_abs, eps_rel, eps_prim_inf, eps_dual_inf,
        rho, sigma, alpha, int(adaptive_rho), wx, wy,
        int(_stall_checks_eff(stall_checks, stall_min_iters, check_every)),
        float(stall_rtol),
    )
    return OracleResult(
        x=x, y=y, status=int(status), iterations=int(iters.value),
        prim_res=float(pr.value), dual_res=float(dr.value),
    )
