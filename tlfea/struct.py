"""Frozen dataclasses registered as JAX pytrees.

`@dataclass` makes a frozen dataclass whose fields are pytree leaves, except
those declared `field(pytree_node=False)`: those are static metadata (part
of the tree structure, hence of every jit cache key) and must be hashable.
Instances get `.replace(**changes)`.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["dataclass", "field"]


def field(pytree_node: bool = True, **kwargs):
    """`dataclasses.field`, plus `pytree_node=False` for a static field."""
    metadata = dict(kwargs.pop("metadata", None) or {}, pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
