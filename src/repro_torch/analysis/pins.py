"""Regression pins: structural facts a past chaos-found bug depends on
(port of ``repro/analysis/pins.py``).

Each pin encodes, as an AST predicate, the *shape* of a fix that a
runtime test can only re-verify by winning the original race.  The lock
checker already pins the locking half of the delta-pin fixes (``guarded by``
on ``_pinned_chains``/``_pending_roots`` means deleting a ``with`` block
fails lint); the pins here cover ordering facts no lock annotation can
express:

* **gc-read-order**: in ``CheckpointManager._gc``, the in-flight
  root set must be read *before* the committed step list.  The reverse
  order has a commit-then-discard window where a just-committed delta is
  in neither set and its base gets collected under a live manifest.
* **gc-newest-first**: the GC deletion loop iterates
  ``sorted(steps, reverse=True)``.  Oldest-first deletion interrupted by
  a crash leaves a surviving manifest referencing a deleted ancestor.

A pin that stops matching (method renamed, call restructured) fails
loudly rather than silently un-pinning — update the pin together with
the code it guards.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from .core import Checker, Diagnostic, FileContext

__all__ = ["RegressionPins"]


def _norm(path: str) -> str:
    return os.path.abspath(path).replace(os.sep, "/")


def _find_method(
    tree: ast.Module, cls_name: str, meth_name: str
) -> ast.FunctionDef | None:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            for stmt in node.body:
                if isinstance(stmt, ast.FunctionDef) and stmt.name == meth_name:
                    return stmt
    return None


def _first_self_call(fn: ast.FunctionDef, attr: str) -> ast.Call | None:
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == attr
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
        ):
            return node
    return None


class RegressionPins(Checker):
    name = "regression-pin"

    def check_file(self, ctx: FileContext) -> Iterable[Diagnostic]:
        if not _norm(ctx.path).endswith("repro_torch/ckpt/manager.py"):
            return
        gc = _find_method(ctx.tree, "CheckpointManager", "_gc")
        if gc is None:
            yield Diagnostic(
                ctx.path, 1, 0, self.name,
                "CheckpointManager._gc not found — the GC race pins "
                "anchor here; re-point them at the new GC entry",
            )
            return

        # Pin: inflight read happens-before steps read.
        inflight = _first_self_call(gc, "_inflight_roots")
        steps = _first_self_call(gc, "steps")
        if inflight is None or steps is None:
            yield Diagnostic(
                ctx.path, gc.lineno, gc.col_offset, self.name,
                "_gc must read self._inflight_roots() and self.steps() — "
                "one of the two reads the read-order fix depends on "
                "is gone",
            )
        elif inflight.lineno > steps.lineno:
            yield Diagnostic(
                ctx.path, steps.lineno, steps.col_offset, self.name,
                "_gc reads self.steps() before self._inflight_roots() — "
                "read-order fix reverted: a save that commits between "
                "the two reads is in neither set and its base chain gets "
                "collected under a live manifest",
            )

        # Pin: deletion loop walks steps newest-first.
        newest_first = False
        for node in ast.walk(gc):
            if not (isinstance(node, ast.For) and isinstance(node.iter, ast.Call)):
                continue
            call = node.iter
            if not (isinstance(call.func, ast.Name) and call.func.id == "sorted"):
                continue
            for kw in call.keywords:
                if (
                    kw.arg == "reverse"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                ):
                    newest_first = True
        if not newest_first:
            yield Diagnostic(
                ctx.path, gc.lineno, gc.col_offset, self.name,
                "_gc has no `for … in sorted(…, reverse=True)` deletion "
                "loop — newest-first fix reverted: a crash mid-GC "
                "deleting oldest-first strands a manifest whose ancestor "
                "is already gone",
            )
