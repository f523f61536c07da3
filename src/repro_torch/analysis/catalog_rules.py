"""Catalog-completeness checker (port of ``repro/analysis/catalog_rules.py``).

Cross-file accounting for the two name registries the runtime relies on:

* ``fault_point(name)`` names vs :data:`repro_torch.chaos.points.CATALOG`
* ``obs.span/timed/event("…")`` names vs :mod:`repro_torch.obs.catalog`
  (``SPANS``/``TIMED``/``EVENTS``), plus literal ``obs.add``/``obs.gauge``
  counter names vs ``COUNTERS`` (membership only — dynamic counter
  families can't be proven covered by a literal scan)

in both directions: an unregistered call-site name is flagged at the call
site, a catalog row with no remaining call site is flagged at the row.
Span/timed/event names must also appear in the DESIGN.md §9 taxonomy, so
the prose table and the code can't drift.

The coverage direction (catalog → call site, DESIGN sync) only runs when
the scan covers the whole ``repro_torch`` package — linting a single file must
not report every catalog row as stale.

This replaces the runtime half of the old regex test: the extraction here
is AST-based, so multi-line calls (``obs.span("serve.fetch", tier=…)``)
are seen, and non-literal span/timed/event/fault-point names are
themselves diagnostics — static accounting only works if names are
literals.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable

from .core import Checker, Diagnostic, FileContext, Project, parse_file

__all__ = ["CatalogCompleteness"]

_EXEMPT = ("repro_torch/chaos/points.py",)
_EXEMPT_DIRS = ("repro_torch/obs/", "repro_torch/analysis/")

_OBS_GROUPS = {"span": "SPANS", "timed": "TIMED", "event": "EVENTS"}
_COUNTER_FUNCS = ("add", "gauge")


def _norm(path: str) -> str:
    return os.path.abspath(path).replace(os.sep, "/")


def _dict_keys(tree: ast.Module, name: str) -> dict[str, int] | None:
    """Keys (and linenos) of a module-level dict literal assigned to
    ``name`` — handles both ``X = {...}`` and ``X: dict[...] = {...}``."""
    for node in tree.body:
        target: ast.expr | None = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        else:
            continue
        if (
            isinstance(target, ast.Name)
            and target.id == name
            and isinstance(node.value, ast.Dict)
        ):
            out: dict[str, int] = {}
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out[k.value] = k.lineno
            return out
    return None


class CatalogCompleteness(Checker):
    name = "catalog"

    def __init__(self) -> None:
        #: group -> name -> first (path, line) call site
        self.sites: dict[str, dict[str, tuple[str, int]]] = {
            "fault_point": {},
            "SPANS": {},
            "TIMED": {},
            "EVENTS": {},
            "COUNTERS": {},
        }

    def _record(self, group: str, name: str, path: str, line: int) -> None:
        self.sites[group].setdefault(name, (path, line))

    def check_file(self, ctx: FileContext) -> Iterable[Diagnostic]:
        norm = _norm(ctx.path)
        if norm.endswith(_EXEMPT) or any(d in norm for d in _EXEMPT_DIRS):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            group: str | None = None
            literal_required = True
            if isinstance(fn, ast.Name) and fn.id == "fault_point":
                group = "fault_point"
            elif (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "obs"
            ):
                if fn.attr in _OBS_GROUPS:
                    group = _OBS_GROUPS[fn.attr]
                elif fn.attr in _COUNTER_FUNCS:
                    group = "COUNTERS"
                    literal_required = False  # dynamic counter families exist
            if group is None:
                continue
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self._record(group, arg.value, ctx.path, node.lineno)
            elif literal_required:
                yield Diagnostic(
                    ctx.path,
                    node.lineno,
                    node.col_offset,
                    self.name,
                    f"{ast.unparse(fn)}(...) name must be a string literal "
                    "so the catalogs stay statically checkable",
                )

    def _load_catalog(
        self, project: Project, suffix: tuple[str, ...], var: str
    ) -> tuple[str, dict[str, int]] | None:
        ctx = project.find(*suffix)
        if ctx is not None:
            keys = _dict_keys(ctx.tree, var)
            return (ctx.path, keys) if keys is not None else None
        path = project.locate_sibling(*suffix)
        if path is None:
            return None
        parsed = parse_file(path)
        if isinstance(parsed, Diagnostic):
            return None
        keys = _dict_keys(parsed.tree, var)
        return (path, keys) if keys is not None else None

    def finalize(self, project: Project) -> Iterable[Diagnostic]:
        # Treat the scan as whole-tree when the registries AND a known
        # call-site module were all scanned — linting one file must not report every
        # catalog row as stale.
        full_tree = all(
            project.find(*s) is not None
            for s in (
                ("repro_torch", "chaos", "points.py"),
                ("repro_torch", "obs", "catalog.py"),
                ("repro_torch", "ckpt", "saver.py"),
            )
        )
        fault = self._load_catalog(project, ("repro_torch", "chaos", "points.py"), "CATALOG")
        obs_catalogs = {
            var: self._load_catalog(project, ("repro_torch", "obs", "catalog.py"), var)
            for var in ("SPANS", "TIMED", "EVENTS", "COUNTERS")
        }

        def check_group(
            group: str, catalog: tuple[str, dict[str, int]] | None, registry: str,
            coverage: bool,
        ) -> Iterable[Diagnostic]:
            if catalog is None:
                return
            cat_path, keys = catalog
            for name, (path, line) in sorted(self.sites[group].items()):
                if name not in keys:
                    yield Diagnostic(
                        path, line, 0, self.name,
                        f'"{name}" is not in {registry} — register it '
                        "(or fix the typo)",
                    )
            if not (full_tree and coverage):
                return
            for name, line in sorted(keys.items()):
                if name not in self.sites[group]:
                    yield Diagnostic(
                        cat_path, line, 0, self.name,
                        f'{registry} entry "{name}" has no call site left — '
                        "remove the stale row",
                    )

        yield from check_group(
            "fault_point", fault, "chaos.points.CATALOG", coverage=True
        )
        for var, coverage in (
            ("SPANS", True), ("TIMED", True), ("EVENTS", True), ("COUNTERS", False),
        ):
            yield from check_group(
                var, obs_catalogs[var], f"obs.catalog.{var}", coverage=coverage
            )

        # DESIGN.md §9 sync: every registered span/timed/event name must
        # appear in the design doc's taxonomy.
        if full_tree:
            design = project.locate_sibling("DESIGN.md")
            if design is not None:
                try:
                    with open(design, "r", encoding="utf-8") as f:
                        text = f.read()
                except OSError:
                    text = ""
                for var in ("SPANS", "TIMED", "EVENTS"):
                    catalog = obs_catalogs[var]
                    if catalog is None:
                        continue
                    cat_path, keys = catalog
                    for name, line in sorted(keys.items()):
                        if name not in text:
                            yield Diagnostic(
                                cat_path, line, 0, self.name,
                                f'"{name}" is registered but missing from the '
                                "DESIGN.md §9 taxonomy",
                            )
