"""Solver exit codes.

Mirror of ``osqp::OsqpExitCode`` as consumed by the reference
(``/root/reference/src/utils.h:11``, ``gomp-solver.h:40-51,68-76``).  Values
are carried as ``int32`` scalars inside jitted code (one status per problem in
a batch — the JAX-native replacement for OSQP's per-solve exception/exit-code
flow, SURVEY.md §5 "failure detection").
"""
from __future__ import annotations

import enum


class ExitCode(enum.IntEnum):
    """Matches the osqp-cpp ``OsqpExitCode`` member set."""

    kOptimal = 0
    kPrimalInfeasible = 1
    kDualInfeasible = 2
    kOptimalInaccurate = 3
    kPrimalInfeasibleInaccurate = 4
    kDualInfeasibleInaccurate = 5
    kMaxIterations = 6
    kInterrupted = 7
    kTimeLimitReached = 8
    kNonConvex = 9
    kUnknown = 10


def is_ok(code: int) -> bool:
    return code in (ExitCode.kOptimal, ExitCode.kOptimalInaccurate)


def to_string(code) -> str:
    return ExitCode(int(code)).name
