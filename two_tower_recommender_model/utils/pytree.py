"""Frozen dataclasses registered as JAX pytrees."""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Make `cls` a frozen dataclass and register it as a pytree node.

    Fields declared with `static_field()` are pytree metadata: hashable values
    that are part of the jit cache key. Every other field is a child, so
    arrays and nested pytrees (or None) flow through `jit`, `scan` and
    `tree.map`. The class gains `replace(**changes)`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)


def static_field(**kwargs):
    """A dataclass field that `pytree_dataclass` treats as metadata."""
    return dataclasses.field(metadata={"static": True}, **kwargs)
