"""CLI: ``python -m repro_torch.analysis [paths…] [--format text|json] [--rule R]``
(port of ``repro/analysis/__main__.py``).

Exit codes: 0 clean, 1 diagnostics found, 2 usage error.  With no paths,
lints ``src/repro_torch`` if it exists (repo root), else the current directory.
``--format json`` emits a machine-readable list for editors/CI.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import all_checkers, analyze


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Project-invariant static analysis (see DESIGN.md §11).",
    )
    parser.add_argument("paths", nargs="*", help="files or directories to lint")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt"
    )
    parser.add_argument(
        "--rule",
        action="append",
        default=None,
        help="run only this rule (repeatable)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print rule names and exit"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for c in all_checkers():
            print(c.name)
        return 0

    paths = args.paths
    if not paths:
        default = os.path.join("src", "repro_torch")
        paths = [default] if os.path.isdir(default) else ["."]
    for p in paths:
        if not os.path.exists(p):
            print(f"repro_torch.analysis: no such path: {p}", file=sys.stderr)
            return 2

    known = {c.name for c in all_checkers()} | {"bad-suppression", "parse-error"}
    for r in args.rule or ():
        if r not in known:
            print(
                f"repro_torch.analysis: unknown rule {r!r} (see --list-rules)",
                file=sys.stderr,
            )
            return 2

    diags = analyze(paths, args.rule)
    if args.fmt == "json":
        print(json.dumps([d.as_dict() for d in diags], indent=2))
    else:
        for d in diags:
            print(d.render())
        n = len(diags)
        scanned = ", ".join(paths)
        if n:
            print(f"repro_torch.analysis: {n} finding(s) in {scanned}", file=sys.stderr)
        else:
            print(f"repro_torch.analysis: clean ({scanned})")
    return 1 if diags else 0


if __name__ == "__main__":
    sys.exit(main())
