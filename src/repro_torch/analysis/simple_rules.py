"""Single-file checkers: clock discipline, single decode point, exception
discipline (port of ``repro/analysis/simple_rules.py``).

Each encodes an invariant that previously lived only in docstrings:

* ``clock-discipline`` — wall-clock reads (``time.time()``,
  ``datetime.now()``, argless ``time.localtime()``) are forbidden outside
  ``core/clock.py`` (the injectable commit/GC clock) and ``obs/trace.py``
  (epoch stamps on trace export).  Everything else either calls
  ``clock.now()`` or measures durations via ``repro_torch.obs``.
* ``decode-point`` — shard/atom payload IO (``load_tensor``,
  ``codec.decode_file``, ``open_memmap``, ``np.fromfile``/``np.memmap``,
  ``mmap.mmap``, binary-mode ``open``) is forbidden outside the read/write
  layer in ``core/`` (``tensor_io``, ``codec``, ``atoms``, ``dist_ckpt``,
  ``engine``).  This is the codec invariant: bytes are decoded in
  exactly one place, so a new codec tag can never be half-supported.
* ``except-discipline`` — ``except Exception`` / bare ``except`` needs a
  ``# repro: allow[except-discipline] -- <reason>`` tag or a narrower type.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from .core import Checker, Diagnostic, FileContext

__all__ = ["ClockDiscipline", "DecodePoint", "ExceptDiscipline"]

_CLOCK_ALLOWED = ("repro_torch/core/clock.py", "repro_torch/obs/trace.py")
_DECODE_ALLOWED = (
    "repro_torch/core/tensor_io.py",
    "repro_torch/core/codec.py",
    "repro_torch/core/atoms.py",
    "repro_torch/core/dist_ckpt.py",
    "repro_torch/core/engine.py",
)


def _norm(path: str) -> str:
    return os.path.abspath(path).replace(os.sep, "/")


def _import_map(tree: ast.Module) -> dict[str, str]:
    """Local name -> dotted origin, for ``import x as y`` and
    ``from x import y as z``."""
    names: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                names[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                names[alias.asname or alias.name] = f"{node.module}.{alias.name}"
    return names


def _call_origin(node: ast.Call, names: dict[str, str]) -> str | None:
    """Dotted origin of the called object, resolved through imports.
    ``time.time()`` -> ``time.time``; ``dt.now()`` after ``from datetime
    import datetime as dt`` -> ``datetime.datetime.now``."""
    parts: list[str] = []
    cur = node.func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    base = names.get(cur.id, cur.id)
    return ".".join([base] + list(reversed(parts)))


class ClockDiscipline(Checker):
    name = "clock-discipline"

    _BANNED = {
        "time.time": "time.time()",
        "datetime.datetime.now": "datetime.now()",
        "datetime.datetime.utcnow": "datetime.utcnow()",
    }

    def check_file(self, ctx: FileContext) -> Iterable[Diagnostic]:
        if _norm(ctx.path).endswith(_CLOCK_ALLOWED):
            return
        names = _import_map(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            origin = _call_origin(node, names)
            if origin is None:
                continue
            what = self._BANNED.get(origin)
            if what is None and origin == "time.localtime" and not node.args:
                what = "argless time.localtime()"
            if what is not None:
                yield Diagnostic(
                    ctx.path,
                    node.lineno,
                    node.col_offset,
                    self.name,
                    f"{what} outside core/clock.py — commit/GC stamps go "
                    "through clock.now(), durations through obs.timed()/"
                    "obs.span()",
                )


class DecodePoint(Checker):
    name = "decode-point"

    _BANNED_ORIGINS = {
        "numpy.load",
        "numpy.fromfile",
        "numpy.memmap",
        "numpy.lib.format.open_memmap",
        "mmap.mmap",
        "repro_torch.core.tensor_io.load_tensor",
        "repro_torch.core.tensor_io.save_tensor",
        "repro_torch.core.tensor_io.open_memmap",
        "repro_torch.core.codec.decode_file",
    }
    # Bare-name calls after `from ... import load_tensor` resolve through
    # the import map; these cover re-exported/relative-import spellings.
    _BANNED_TAILS = ("load_tensor", "save_tensor", "open_memmap", "decode_file")

    def check_file(self, ctx: FileContext) -> Iterable[Diagnostic]:
        if _norm(ctx.path).endswith(_DECODE_ALLOWED):
            return
        names = _import_map(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            origin = _call_origin(node, names)
            bad = None
            if origin is not None:
                if origin in self._BANNED_ORIGINS:
                    bad = origin
                else:
                    tail = origin.rsplit(".", 1)[-1]
                    if tail in self._BANNED_TAILS:
                        bad = tail
            if bad is None and origin == "open" and self._binary_mode(node):
                bad = "binary-mode open()"
            if bad is not None:
                yield Diagnostic(
                    ctx.path,
                    node.lineno,
                    node.col_offset,
                    self.name,
                    f"{bad} outside the read layer — shard/atom payload IO "
                    "lives in core/ (tensor_io, codec, atoms, dist_ckpt, "
                    "engine) so decode happens in exactly one place",
                )

    @staticmethod
    def _binary_mode(node: ast.Call) -> bool:
        mode: ast.expr | None = None
        if len(node.args) >= 2:
            mode = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        return (
            isinstance(mode, ast.Constant)
            and isinstance(mode.value, str)
            and "b" in mode.value
        )


class ExceptDiscipline(Checker):
    name = "except-discipline"

    def check_file(self, ctx: FileContext) -> Iterable[Diagnostic]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = self._broad_name(node.type)
            if broad is not None:
                yield Diagnostic(
                    ctx.path,
                    node.lineno,
                    node.col_offset,
                    self.name,
                    f"{broad} — narrow the type, or justify with "
                    "`# repro: allow[except-discipline] -- <reason>`",
                )

    @staticmethod
    def _broad_name(tp: ast.expr | None) -> str | None:
        if tp is None:
            return "bare except:"
        exprs = tp.elts if isinstance(tp, ast.Tuple) else [tp]
        for e in exprs:
            if isinstance(e, ast.Name) and e.id in ("Exception", "BaseException"):
                return f"except {e.id}"
        return None
