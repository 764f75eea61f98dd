"""Box-bound constraint DSL.

JAX-native re-design of the reference's optional-bound DSL
(``/root/reference/src/constraints/constraints.h:11-67``).  Instead of
``std::optional`` bounds, absent bounds are represented by ``±INF`` entries so
every constraint is a fixed-shape ``(lower, upper)`` array pair — the static
shape discipline JAX/XLA requires.

``INF = 1e30`` matches the reference (``constraints.h:11``) and OSQP's
``OSQP_INFTY``; values with magnitude ``>= INF_THRESHOLD`` are treated as
infinite (no bound).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np

INF = 1e30
# Magnitudes at or above this are "infinite" (loose bound). OSQP treats
# anything >= OSQP_INFTY * 1e-6-ish as infinite; we keep a wide margin so
# that dt- or dt^2-scaled INF bounds remain infinite.
INF_THRESHOLD = 1e25

ArrayLike = Union[np.ndarray, Sequence[float], float]


class Constraint(NamedTuple):
    """Per-dimension lower/upper bounds, shape ``(n,)`` each.

    Mirror of ``constraints::Constraint<N>`` (``constraints.h:18-19``) with
    absent bounds encoded as ``-INF`` / ``+INF``.
    """

    lower: np.ndarray
    upper: np.ndarray

    @property
    def n(self) -> int:
        return int(self.lower.shape[-1])


def of(n: int, val: float) -> np.ndarray:
    """Array of length ``n`` filled with ``val`` (``constraints.h:22-27``)."""
    return np.full((n,), float(val), dtype=np.float64)


def _as_bound(n: int, b: Optional[ArrayLike], default: float) -> np.ndarray:
    if b is None:
        return of(n, default)
    arr = np.asarray(b, dtype=np.float64)
    if arr.ndim == 0:
        arr = np.full((n,), float(arr))
    if arr.shape != (n,):
        raise ValueError(f"bound shape {arr.shape} != ({n},)")
    return arr.copy()


def in_range(n: int, low: Optional[ArrayLike], upp: Optional[ArrayLike]) -> Constraint:
    """``constraints::inRange`` (``constraints.h:29-32``); ``None`` = unbounded."""
    return Constraint(_as_bound(n, low, -INF), _as_bound(n, upp, INF))


def equal(vals: ArrayLike) -> Constraint:
    """``constraints::equal`` (``constraints.h:34-37``)."""
    arr = np.asarray(vals, dtype=np.float64)
    return Constraint(arr.copy(), arr.copy())


def greater_eq(vals: ArrayLike) -> Constraint:
    """``constraints::greaterEq`` (``constraints.h:39-42``)."""
    arr = np.asarray(vals, dtype=np.float64)
    return Constraint(arr.copy(), of(arr.shape[0], INF))


def less_eq(vals: ArrayLike) -> Constraint:
    """``constraints::lessEq`` (``constraints.h:44-47``)."""
    arr = np.asarray(vals, dtype=np.float64)
    return Constraint(of(arr.shape[0], -INF), arr.copy())


def any_constraint(n: int) -> Constraint:
    """``constraints::ANY`` (``constraints.h:49-50``)."""
    return Constraint(of(n, -INF), of(n, INF))


def eq_zero(n: int) -> Constraint:
    """``constraints::EQ_ZERO`` (``constraints.h:52-53``)."""
    return equal(of(n, 0.0))


def scaled(c: Constraint, v: float) -> Constraint:
    """Scale both bounds by ``v`` preserving infinities (``constraints.h:55-67``).

    The reference's absent (optional) bounds are unaffected by scaling; here the
    equivalent is: entries with magnitude ``>= INF_THRESHOLD`` keep their value.
    """

    def _scale(b: np.ndarray) -> np.ndarray:
        return np.where(np.abs(b) >= INF_THRESHOLD, b, b * v)

    return Constraint(_scale(c.lower), _scale(c.upper))


def is_loose(bound: np.ndarray) -> np.ndarray:
    """Elementwise mask: bound magnitude is effectively infinite."""
    return np.abs(np.asarray(bound)) >= INF_THRESHOLD
