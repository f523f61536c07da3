"""Flat-path pytree utilities.

Checkpoints address parameters by flattened dotted paths
(``decoder.blocks.attn.wqkv``).  Models in this framework build their
parameters as nested ``dict``s, so flatten/unflatten is simple and
deterministic.  Names are validated against a conservative charset so they
can double as file-system path components without escaping.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Mapping

__all__ = ["flatten_with_paths", "unflatten_from_paths", "validate_name", "tree_map_with_path"]

_SEP = "."
_NAME_RE = re.compile(r"^[A-Za-z0-9_\-]+$")


def validate_name(key: str) -> None:
    if not _NAME_RE.match(key):
        raise ValueError(
            f"pytree key {key!r} contains characters outside [A-Za-z0-9_-]; "
            "checkpoint paths must be filesystem-safe"
        )


def flatten_with_paths(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Flatten a nested dict into ``{dotted.path: leaf}`` (sorted keys)."""
    out: dict[str, Any] = {}
    _flatten_into(out, tree, prefix)
    return out


def _flatten_into(out: dict[str, Any], node: Any, path: str) -> None:
    # A module-level function, not a closure: a recursive closure is a
    # reference cycle that would keep ``out`` (and every card tensor in it)
    # alive until the garbage collector runs.
    if isinstance(node, Mapping):
        for k in sorted(node):
            validate_name(str(k))
            _flatten_into(out, node[k], f"{path}{_SEP}{k}" if path else str(k))
    else:
        out[path] = node


def unflatten_from_paths(flat: Mapping[str, Any]) -> dict:
    """Inverse of :func:`flatten_with_paths`."""
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"path conflict at {p!r} in {path!r}")
        if parts[-1] in node:
            raise ValueError(f"duplicate path {path!r}")
        node[parts[-1]] = leaf
    return root


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """Map ``fn(path, leaf)`` over a nested dict, preserving structure."""
    flat = flatten_with_paths(tree)
    return unflatten_from_paths({p: fn(p, v) for p, v in flat.items()})
