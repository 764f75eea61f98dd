"""Frozen dataclasses registered as JAX pytrees.

Solver state, problem containers and results are immutable records whose
array fields are pytree leaves and whose structural fields (sizes, layout
tags, geometry flags) are static.  ``@dataclass`` makes such a record;
``field(pytree_node=False)`` marks a static field; ``.replace(**changes)``
returns an updated copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static (part of the
    tree structure, hashed into jit cache keys) instead of a leaf."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass registered with ``jax.tree_util`` and given
    ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
