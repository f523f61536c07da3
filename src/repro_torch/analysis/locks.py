"""Lock-discipline checker (port of ``repro/analysis/locks.py``).

An attribute assignment annotated ``#: guarded by self.<lock>`` (class
body, ``__init__`` or ``__post_init__``) declares that every other touch
of that attribute on ``self`` must happen

* lexically inside a ``with self.<lock>:`` block, or
* in a method whose ``def`` line carries ``# repro: holds[self.<lock>]``
  (the caller-holds-the-lock contract used by ``*_locked`` helpers).

``__init__``/``__post_init__`` are exempt: construction happens-before
publication, there is no concurrent reader yet.

Scope and known approximations (see DESIGN.md §11): only ``self.<attr>``
accesses are checked — cross-object accesses (``other._ring``) and
``getattr``/``setattr`` indirection are invisible to this pass; a closure
defined under the lock is treated as running under it.  Deliberate
unlocked reads (GIL-atomic dict peeks) carry a ``# repro: allow`` with
the reason inline.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from .core import Checker, Diagnostic, FileContext

__all__ = ["LockDiscipline"]


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> ``"X"``, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _annotation_for(ctx: FileContext, node: ast.stmt) -> str | None:
    """Lock name if the statement carries a ``guarded by`` comment on its
    first or last line."""
    for ln in {node.lineno, getattr(node, "end_lineno", node.lineno)}:
        lock = ctx.guarded_lines.get(ln)
        if lock is not None:
            return lock
    return None


def _collect_guarded(ctx: FileContext, cls: ast.ClassDef) -> dict[str, str]:
    """attr name -> lock attr name, from annotated assignments."""
    guarded: dict[str, str] = {}

    def visit_assign(stmt: ast.stmt, in_init: bool) -> None:
        lock = _annotation_for(ctx, stmt)
        if lock is None:
            return
        targets: list[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        for t in targets:
            if in_init:
                attr = _self_attr(t)
                if attr is not None:
                    guarded[attr] = lock
            elif isinstance(t, ast.Name):  # class-level / dataclass field
                guarded[t.id] = lock

    for stmt in cls.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            visit_assign(stmt, in_init=False)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt.name in (
            "__init__",
            "__post_init__",
        ):
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    visit_assign(sub, in_init=True)
    return guarded


def _held_on_entry(ctx: FileContext, fn: ast.stmt) -> set[str]:
    held: set[str] = set()
    for ln in (fn.lineno, fn.lineno - 1):
        lock = ctx.holds_lines.get(ln)
        if lock is not None:
            held.add(lock)
    return held


def _with_locks(node: ast.With) -> set[str]:
    locks: set[str] = set()
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr is not None:
            locks.add(attr)
    return locks


class LockDiscipline(Checker):
    name = "lock-discipline"

    def check_file(self, ctx: FileContext) -> Iterable[Diagnostic]:
        diags: list[Diagnostic] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                diags.extend(self._check_class(ctx, node))
        return diags

    def _check_class(
        self, ctx: FileContext, cls: ast.ClassDef
    ) -> Iterator[Diagnostic]:
        guarded = _collect_guarded(ctx, cls)
        if not guarded:
            return
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name in ("__init__", "__post_init__"):
                continue
            held = _held_on_entry(ctx, stmt)
            for sub in stmt.body:
                yield from self._walk(ctx, cls.name, guarded, sub, held)

    def _walk(
        self,
        ctx: FileContext,
        cls_name: str,
        guarded: dict[str, str],
        node: ast.AST,
        held: set[str],
    ) -> Iterator[Diagnostic]:
        if isinstance(node, ast.ClassDef):
            return  # nested class: its `self` is a different object
        if isinstance(node, ast.With):
            for item in node.items:
                yield from self._walk(ctx, cls_name, guarded, item.context_expr, held)
                if item.optional_vars is not None:
                    yield from self._walk(
                        ctx, cls_name, guarded, item.optional_vars, held
                    )
            inner = held | _with_locks(node)
            for sub in node.body:
                yield from self._walk(ctx, cls_name, guarded, sub, inner)
            return
        attr = _self_attr(node)
        if attr is not None:
            lock = guarded.get(attr)
            if lock is not None and lock not in held:
                yield Diagnostic(
                    ctx.path,
                    node.lineno,
                    node.col_offset,
                    self.name,
                    f"{cls_name}.{attr} is guarded by self.{lock} but accessed "
                    f"without it — wrap in `with self.{lock}:` or mark the "
                    f"method `# repro: holds[self.{lock}]`",
                )
            # fall through: subscripts/calls on the attribute still walk below
        for child in ast.iter_child_nodes(node):
            yield from self._walk(ctx, cls_name, guarded, child, held)
