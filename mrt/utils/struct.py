"""Frozen dataclasses registered as JAX pytrees.

`dataclass` makes a frozen dataclass whose fields are pytree children,
except those declared with `field(pytree_node=False)`: these are static
metadata, part of the treedef (so they must be hashable, and a change
of value compiles a new program).  Instances get `.replace(**updates)`.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node=True, **kwargs):
    """A dataclass field; `pytree_node=False` makes it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    """Frozen dataclass + pytree registration (children in field
    order, static fields in the treedef)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(
            f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data,
                                     meta_fields=meta)
    cls.replace = _replace
    return cls
