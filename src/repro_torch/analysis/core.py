"""Shared infrastructure for the project-invariant linter (port of
``repro/analysis/core.py``).

The analyzer is pure stdlib (``ast`` + ``tokenize``) and never imports the
code it checks, so it runs in well under a second even though the tree it
scans pulls in torch at import time.  Everything here is plumbing shared by
the checkers in :mod:`repro_torch.analysis`:

* :class:`Diagnostic` — one finding, formatted ``path:line:col: rule: msg``.
* :class:`FileContext` — a parsed file plus its comment map, suppression
  map, and annotation maps (``guarded by`` / ``holds``).
* :class:`Checker` — the per-file + whole-project hook pair.
* :func:`run` — walk files, run checkers, apply suppressions.

Annotation / suppression grammar (see DESIGN.md §11):

``# repro: allow[<rule>[,<rule>…]] -- <reason>``
    Suppress the named rule(s) on this line (trailing comment) or on the
    line directly below (standalone comment).  The ``-- <reason>`` part is
    mandatory: a reasonless ``allow`` is itself reported (rule
    ``bad-suppression``) so suppressions stay auditable.

``#: guarded by self.<lock>``
    Trailing an attribute assignment in a class body, ``__init__`` or
    ``__post_init__``: every other touch of that attribute must happen
    under ``with self.<lock>:`` or in a method marked ``holds``.

``# repro: holds[self.<lock>]``
    Trailing a ``def`` line (or the line directly above it): the method's
    contract is that its caller already holds ``self.<lock>``.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Iterator

__all__ = [
    "Diagnostic",
    "FileContext",
    "Checker",
    "Project",
    "collect_files",
    "parse_file",
    "run",
]

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([^\]]*)\](\s*--\s*(\S.*))?")
_GUARDED_RE = re.compile(r"#:\s*guarded by self\.(\w+)")
_HOLDS_RE = re.compile(r"#\s*repro:\s*holds\[self\.(\w+)\]")


@dataclass(frozen=True, order=True)
class Diagnostic:
    """One finding.  Sort order is (path, line, col, rule)."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"

    def as_dict(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
        }


@dataclass
class FileContext:
    """A parsed source file plus everything checkers need from its comments."""

    path: str
    source: str
    tree: ast.Module
    #: line -> full comment text (from tokenize, so strings are never
    #: mistaken for comments).
    comments: dict[int, str] = field(default_factory=dict)
    #: line -> set of rule names suppressed on that line.
    suppressions: dict[int, set[str]] = field(default_factory=dict)
    #: line -> lock attr name, from ``#: guarded by self.<lock>``.
    guarded_lines: dict[int, str] = field(default_factory=dict)
    #: line -> lock attr name, from ``# repro: holds[self.<lock>]``.
    holds_lines: dict[int, str] = field(default_factory=dict)
    #: malformed suppressions found while scanning comments.
    comment_diags: list[Diagnostic] = field(default_factory=list)

    def suppressed(self, line: int, rule: str) -> bool:
        """True if ``rule`` is allowed on ``line`` (trailing comment or a
        standalone comment on the line directly above)."""
        for ln in (line, line - 1):
            rules = self.suppressions.get(ln)
            if rules and (rule in rules or "*" in rules):
                return True
        return False


class Checker:
    """Base class.  Subclasses set ``name`` and override one or both hooks."""

    name = "?"

    def check_file(self, ctx: FileContext) -> Iterable[Diagnostic]:
        return ()

    def finalize(self, project: "Project") -> Iterable[Diagnostic]:
        return ()


@dataclass
class Project:
    """All scanned files, for checkers that need the cross-file view."""

    files: list[FileContext]

    def find(self, *suffix: str) -> FileContext | None:
        """First scanned file whose path ends with ``os.sep.join(suffix)``."""
        want = os.sep.join(suffix)
        for ctx in self.files:
            if ctx.path.endswith(want):
                return ctx
        return None

    def locate_sibling(self, *suffix: str) -> str | None:
        """Find a file relative to the scanned tree even when it was not
        itself scanned: walk up from the first scanned file looking for
        ``suffix`` (e.g. ``("DESIGN.md",)``)."""
        ctx = self.find(*suffix)
        if ctx is not None:
            return ctx.path
        if not self.files:
            return None
        probe = os.path.dirname(os.path.abspath(self.files[0].path))
        want = os.path.join(*suffix)
        for _ in range(8):
            cand = os.path.join(probe, want)
            if os.path.isfile(cand):
                return cand
            parent = os.path.dirname(probe)
            if parent == probe:
                break
            probe = parent
        return None


def _scan_comments(ctx: FileContext) -> None:
    try:
        tokens = tokenize.generate_tokens(io.StringIO(ctx.source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            line = tok.start[0]
            text = tok.string
            ctx.comments[line] = text
            m = _ALLOW_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                if not rules or m.group(3) is None:
                    ctx.comment_diags.append(
                        Diagnostic(
                            ctx.path,
                            line,
                            tok.start[1],
                            "bad-suppression",
                            "allow[...] needs rule name(s) and a reason: "
                            "`# repro: allow[<rule>] -- <why>`",
                        )
                    )
                else:
                    ctx.suppressions.setdefault(line, set()).update(rules)
            m = _GUARDED_RE.search(text)
            if m:
                ctx.guarded_lines[line] = m.group(1)
            m = _HOLDS_RE.search(text)
            if m:
                ctx.holds_lines[line] = m.group(1)
    except tokenize.TokenError:
        pass  # syntactically valid files can still trip tokenize at EOF


def parse_file(path: str) -> FileContext | Diagnostic:
    """Parse one file; a syntax error becomes a diagnostic, not a crash."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError) as e:
        line = getattr(e, "lineno", 0) or 0
        return Diagnostic(path, line, 0, "parse-error", str(e))
    ctx = FileContext(path=path, source=source, tree=tree)
    _scan_comments(ctx)
    return ctx


def collect_files(paths: Iterable[str]) -> Iterator[str]:
    """Yield ``.py`` files under ``paths`` (dirs walked, ``__pycache__``
    skipped), in sorted order for deterministic output."""
    seen: set[str] = set()
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(
                    d for d in dirnames if d != "__pycache__" and not d.startswith(".")
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        full = os.path.join(dirpath, fn)
                        if full not in seen:
                            seen.add(full)
                            yield full
        elif p.endswith(".py"):
            if p not in seen:
                seen.add(p)
                yield p


def run(paths: Iterable[str], checkers: Iterable[Checker]) -> list[Diagnostic]:
    """Walk ``paths``, run every checker, apply suppressions, sort."""
    checkers = list(checkers)
    files: list[FileContext] = []
    diags: list[Diagnostic] = []
    for path in collect_files(paths):
        parsed = parse_file(path)
        if isinstance(parsed, Diagnostic):
            diags.append(parsed)
            continue
        files.append(parsed)
        diags.extend(parsed.comment_diags)
        for checker in checkers:
            for d in checker.check_file(parsed):
                if not parsed.suppressed(d.line, d.rule):
                    diags.append(d)
    project = Project(files=files)
    by_path = {ctx.path: ctx for ctx in files}
    for checker in checkers:
        for d in checker.finalize(project):
            ctx = by_path.get(d.path)
            if ctx is not None and ctx.suppressed(d.line, d.rule):
                continue
            diags.append(d)
    return sorted(set(diags))
