"""Project-invariant static analysis (``python -m repro_torch.analysis``),
the port of ``repro.analysis`` pointed at ``src/repro_torch``.

Pure stdlib, never imports the code under check (nor the JAX package's
copy of this linter): the concurrency, clock, codec and catalog
conventions of the checkpoint stack are checked statically instead of
waiting for a chaos seed to execute the broken path.  DESIGN.md §11
documents the rules and the annotation / suppression grammar, which reads
the same in both trees; tests/test_torch_analysis.py holds one known-bad
fixture per rule, parity with the reference linter, plus the live-tree
self-check.

Rules
-----
``lock-discipline``
    ``#: guarded by self.<lock>`` attributes only touched under
    ``with self.<lock>:`` or in ``# repro: holds[self.<lock>]`` methods.
``clock-discipline``
    Wall-clock reads only in ``core/clock.py`` / ``obs/trace.py``.
``decode-point``
    Shard/atom payload IO only in the ``core/`` read layer.
``catalog``
    ``fault_point``/``obs.span``/… names match their catalogs, both ways.
``except-discipline``
    ``except Exception`` needs an ``allow`` tag with a reason.
``regression-pin``
    AST-shape pins for the checkpoint GC ordering fixes.
"""

from __future__ import annotations

from .catalog_rules import CatalogCompleteness
from .core import Checker, Diagnostic, FileContext, Project, parse_file, run
from .locks import LockDiscipline
from .pins import RegressionPins
from .simple_rules import ClockDiscipline, DecodePoint, ExceptDiscipline

__all__ = [
    "Checker",
    "Diagnostic",
    "FileContext",
    "Project",
    "all_checkers",
    "analyze",
    "parse_file",
    "run",
]


def all_checkers() -> list[Checker]:
    """Fresh checker instances (CatalogCompleteness carries scan state)."""
    return [
        LockDiscipline(),
        ClockDiscipline(),
        DecodePoint(),
        CatalogCompleteness(),
        ExceptDiscipline(),
        RegressionPins(),
    ]


def analyze(paths: list[str], rules: list[str] | None = None) -> list[Diagnostic]:
    """Run the (optionally filtered) checker set over ``paths``."""
    checkers = all_checkers()
    if rules:
        checkers = [c for c in checkers if c.name in rules]
    return run(paths, checkers)
