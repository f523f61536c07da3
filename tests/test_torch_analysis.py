"""The port's project lint (``repro_torch.analysis``) against the reference's
(``repro.analysis``).

* Every case of ``tests/test_analysis.py``, with its fixtures under
  ``repro_torch/…``: one known-bad fixture per rule asserting the exact
  diagnostic, the suppressions asserting silence, revert-the-fix pins and
  the guarded-lock block on copies of the port's own ``ckpt/manager.py``,
  the live-tree self-check over ``src/repro_torch`` and the CLI.
* Parity: the reference's linter on the ``repro/…`` copy of each fixture
  and the port's on the ``repro_torch/…`` copy give the same (rule, line,
  col, message).  The port's pin messages leave out the reference's
  change-history number; nothing else differs.
* One case per annotation the port had dropped and now carries again:
  stripping it from a copy of the port's file fails the lint.

Pure stdlib on both sides: neither linter imports the code it checks.
"""

import ast
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import all_checkers, analyze
from repro_torch.analysis.__main__ import main as cli_main

REPO = Path(__file__).resolve().parent.parent
SRC_PORT = REPO / "src" / "repro_torch"
STDLIB = set(sys.stdlib_module_names) | {"__future__"}


def _ref_analyze():
    from repro.analysis import analyze as ref

    return ref


def _write(root, relpath, source):
    f = root / relpath
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(source)
    return f


def _lint_snippet(tmp_path, source, rules=None, relpath="repro_torch/mod.py"):
    return analyze([str(_write(tmp_path, relpath, source))], rules)


# ---------------------------------------------------------------------------
# fixtures (the reference test file's, verbatim)


LOCKED_CLASS = '''
import threading

class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []  #: guarded by self._lock

    def ok(self):
        with self._lock:
            self._items.append(1)

    def helper_locked(self):  # repro: holds[self._lock]
        return len(self._items)

    def bad(self):
        return list(self._items)
'''

AUGASSIGN_CLASS = '''
import threading

class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  #: guarded by self._lock

    def bump(self):
        self._n += 1
'''

WALL_CLOCK = (
    "import time as t\n"
    "from datetime import datetime\n"
    "a = t.time()\n"
    "b = datetime.now()\n"
    "c = t.localtime()\n"
    "d = t.localtime(123.0)\n"  # explicit epoch: allowed
    "e = t.perf_counter()\n"  # monotonic: allowed
)

RAW_PAYLOAD_IO = (
    "import numpy as np\n"
    "from repro_torch.core.tensor_io import load_tensor\n"
    "a = np.fromfile('x.bin', dtype='float32')\n"
    "b = load_tensor('x.npy', dtype='float32')\n"
    "fh = open('x.npy', 'rb')\n"
    "meta = open('meta.json')\n"  # text mode: allowed
)

BROAD_HANDLERS = (
    "try:\n    pass\nexcept Exception:\n    pass\n"
    "try:\n    pass\nexcept:\n    pass\n"
    "try:\n    pass\nexcept (ValueError, BaseException):\n    pass\n"
    "try:\n    pass\nexcept ValueError:\n    pass\n"  # narrow: allowed
)

REASONLESS_ALLOW = (
    "try:\n"
    "    pass\n"
    "except Exception:  # repro: allow[except-discipline]\n"
    "    pass\n"
)

# (fixture id, relpath under the package, source) — every one silent
SUPPRESSED = [
    (
        "lock",
        "mod.py",
        LOCKED_CLASS.replace(
            "        return list(self._items)",
            "        return list(self._items)  # repro: allow[lock-discipline]"
            " -- snapshot read, GIL-atomic",
        ),
    ),
    (
        "clock",
        "mod.py",
        "import time\n"
        "# repro: allow[clock-discipline] -- log file mtime stamp only\n"
        "t = time.time()\n",
    ),
    ("clock-module", "core/clock.py", "import time\nnow = time.time()\n"),
    ("read-layer", "core/dist_ckpt.py", "import numpy as np\na = np.fromfile('x.bin', dtype='u1')\n"),
    (
        "decode",
        "mod.py",
        "import numpy as np\n"
        "a = np.fromfile('x.bin', dtype='u1')  "
        "# repro: allow[decode-point] -- scratch file, not a shard\n",
    ),
    (
        "except",
        "mod.py",
        "try:\n"
        "    pass\n"
        "except Exception:  # repro: allow[except-discipline] -- report, don't crash\n"
        "    pass\n",
    ),
]


# ---------------------------------------------------------------------------
# lock-discipline


def test_lock_discipline_catches_unlocked_access(tmp_path):
    diags = _lint_snippet(tmp_path, LOCKED_CLASS)
    assert [d.rule for d in diags] == ["lock-discipline"]
    d = diags[0]
    assert "Box._items is guarded by self._lock" in d.message
    # only the access in bad() fires — with-block and holds-method are fine
    assert d.line == LOCKED_CLASS.splitlines().index("        return list(self._items)") + 1


def test_lock_discipline_init_is_exempt_and_augassign_checked(tmp_path):
    diags = _lint_snippet(tmp_path, AUGASSIGN_CLASS)
    assert [d.rule for d in diags] == ["lock-discipline"]
    assert "C._n" in diags[0].message


@pytest.mark.parametrize("case", SUPPRESSED, ids=[c[0] for c in SUPPRESSED])
def test_suppression_or_allowed_module_silences(tmp_path, case):
    _, rel, src = case
    assert _lint_snippet(tmp_path, src, relpath=f"repro_torch/{rel}") == []


# ---------------------------------------------------------------------------
# clock-discipline


def test_clock_discipline_flags_wall_clock(tmp_path):
    diags = _lint_snippet(tmp_path, WALL_CLOCK)
    assert [(d.rule, d.line) for d in diags] == [
        ("clock-discipline", 3),
        ("clock-discipline", 4),
        ("clock-discipline", 5),
    ]


@pytest.mark.parametrize("rel", ["repro_torch/core/other.py", "repro/core/clock.py"])
def test_clock_discipline_allows_only_the_ports_clock_module(tmp_path, rel):
    # the reference's path is not an allowed module of the port's linter
    assert len(_lint_snippet(tmp_path, "import time\nnow = time.time()\n", relpath=rel)) == 1


# ---------------------------------------------------------------------------
# decode-point


def test_decode_point_flags_raw_payload_io(tmp_path):
    diags = _lint_snippet(tmp_path, RAW_PAYLOAD_IO)
    assert [(d.rule, d.line) for d in diags] == [
        ("decode-point", 3),
        ("decode-point", 4),
        ("decode-point", 5),
    ]
    assert "read layer" in diags[0].message


# ---------------------------------------------------------------------------
# catalog


def _mini_tree(root, foo_source, pkg="repro_torch"):
    """A minimal package-shaped tree: registries + one call-site module."""
    _write(root, f"{pkg}/chaos/points.py",
           'CATALOG: dict[str, str] = {\n'
           '    "saver.shard": "mid-save",\n'
           '    "gone.point": "no call site",\n'
           '}\n')
    _write(root, f"{pkg}/obs/catalog.py",
           'SPANS: dict[str, str] = {"save.shard": "one shard"}\n'
           "TIMED: dict[str, str] = {}\n"
           "EVENTS: dict[str, str] = {}\n"
           "COUNTERS: dict[str, str] = {}\n")
    _write(root, f"{pkg}/ckpt/saver.py",
           f'from {pkg}.chaos.points import fault_point\n'
           f'import {pkg}.obs as obs\n'
           'fault_point("saver.shard")\n'
           'with obs.span("save.shard"):\n'
           "    pass\n")
    _write(root, f"{pkg}/foo.py", foo_source.replace("repro_torch.", f"{pkg}."))
    return root / pkg


UNREGISTERED = (
    'from repro_torch.chaos.points import fault_point\n'
    'import repro_torch.obs as obs\n'
    'fault_point(\n    "saver.typo",\n)\n'  # multi-line: a regex would miss it
    'obs.event("unregistered.event")\n'
)
NON_LITERAL = (
    'from repro_torch.chaos.points import fault_point\n'
    'name = "saver.shard"\n'
    "fault_point(name)\n"
)


def test_catalog_flags_unregistered_and_stale_names(tmp_path):
    diags = analyze([str(_mini_tree(tmp_path, UNREGISTERED))], ["catalog"])
    msgs = [d.message for d in diags]
    assert any('"saver.typo" is not in chaos.points.CATALOG' in m for m in msgs)
    assert any('"unregistered.event" is not in obs.catalog.EVENTS' in m for m in msgs)
    assert any('"gone.point" has no call site left' in m for m in msgs)
    assert len(diags) == 3


def test_catalog_requires_literal_names(tmp_path):
    diags = analyze([str(_mini_tree(tmp_path, NON_LITERAL))], ["catalog"])
    assert any(d.rule == "catalog" and "string literal" in d.message for d in diags)


def test_catalog_reference_shaped_tree_is_not_a_whole_port_scan(tmp_path):
    # the port's linter looks for repro_torch/...: a repro/ tree gets no
    # coverage pass, so its stale row is not reported
    diags = analyze([str(_mini_tree(tmp_path, UNREGISTERED, pkg="repro"))], ["catalog"])
    assert not any("has no call site left" in d.message for d in diags)


@pytest.mark.parametrize("which", ["solo", "port-catalog"])
def test_catalog_single_file_scan_skips_coverage(tmp_path, which):
    # linting one file must not report every catalog row as stale
    if which == "solo":
        f = tmp_path / "solo.py"
        f.write_text("x = 1\n")
    else:
        f = _write(tmp_path, "repro_torch/obs/catalog.py",
                   _untagged(SRC_PORT / "obs" / "catalog.py", "allow[catalog]"))
    assert analyze([str(f)], ["catalog"]) == []


# ---------------------------------------------------------------------------
# except-discipline


def test_except_discipline_flags_broad_handlers(tmp_path):
    diags = _lint_snippet(tmp_path, BROAD_HANDLERS)
    assert [d.rule for d in diags] == ["except-discipline"] * 3
    assert "except Exception" in diags[0].message
    assert "bare except" in diags[1].message


def test_reasonless_allow_is_itself_flagged(tmp_path):
    diags = _lint_snippet(tmp_path, REASONLESS_ALLOW)
    assert sorted(d.rule for d in diags) == ["bad-suppression", "except-discipline"]


# ---------------------------------------------------------------------------
# regression pins: undo a shipped fix in a copy of the port's tree


READ_ORDER = (
    "        inflight = self._inflight_roots()\n        steps = self.steps()",
    "        steps = self.steps()\n        inflight = self._inflight_roots()",
)
NEWEST_FIRST = ("for s in sorted(steps, reverse=True):", "for s in sorted(steps):")
PIN_LOCK_BLOCK = (
    """        with self._pin_lock:
            # pins die with their save
            self._pinned_chains = {r: c for r, c in self._pinned_chains.items() if r in inflight}""",
    """        # pins die with their save
        self._pinned_chains = {r: c for r, c in self._pinned_chains.items() if r in inflight}""",
)


def _transformed_copy(root, rel, old, new, pkg="repro_torch", src=SRC_PORT):
    real = (src / rel).read_text()
    assert real.count(old) == 1, f"pin anchor drifted in {rel}: {old!r}"
    return _write(root, f"{pkg}/{rel}", real.replace(old, new))


def test_pin_gc_read_order_revert_fails_lint(tmp_path):
    out = _transformed_copy(tmp_path, "ckpt/manager.py", *READ_ORDER)
    diags = analyze([str(out)], ["regression-pin"])
    assert [d.rule for d in diags] == ["regression-pin"]
    assert "read-order fix reverted" in diags[0].message
    # and the shipped file passes
    assert analyze([str(SRC_PORT / "ckpt/manager.py")], ["regression-pin"]) == []


def test_pin_gc_newest_first_revert_fails_lint(tmp_path):
    out = _transformed_copy(tmp_path, "ckpt/manager.py", *NEWEST_FIRST)
    diags = analyze([str(out)], ["regression-pin"])
    assert any("newest-first" in d.message for d in diags)


def test_pin_anchors_only_on_the_ports_manager(tmp_path):
    # a reference-shaped path is not the port's manager: no pin applies
    out = _transformed_copy(tmp_path, "ckpt/manager.py", *NEWEST_FIRST, pkg="repro")
    assert analyze([str(out)], ["regression-pin"]) == []


def test_deleting_guarded_lock_block_fails_lint(tmp_path):
    # the delta-base pin set must only be touched under _pin_lock;
    # stripping the gc-side lock block must trip the checker.
    out = _transformed_copy(tmp_path, "ckpt/manager.py", *PIN_LOCK_BLOCK)
    diags = analyze([str(out)], ["lock-discipline"])
    assert diags and all(d.rule == "lock-discipline" for d in diags)
    assert any("_pinned_chains" in d.message for d in diags)


# ---------------------------------------------------------------------------
# parity with the reference linter


def _key(d, pkg, where):
    """(rule, line, col, message) with the package name swapped; with
    ``where="text"`` the dotted name written at (line, col) stands for the
    position, for copies of two different files."""
    msg = re.sub(r"PR \d+ ", "", d.message) if pkg == "repro" else d.message
    msg = msg.replace("repro_torch", "repro")
    if where == "text":
        line = Path(d.path).read_text().splitlines()[d.line - 1]
        return (d.rule, re.match(r"[\w.]*", line[d.col:]).group(0), msg)
    return (d.rule, d.line, d.col, msg)


def _both(tmp_path, build, where="line"):
    """``build(root, pkg) -> path`` writes one fixture; returns the
    reference's and the port's keyed diagnostics on their own copies."""
    ref = _ref_analyze()
    r = [_key(d, "repro", where) for d in ref([str(build(tmp_path / "ref", "repro"))])]
    p = [_key(d, "repro_torch", where)
         for d in analyze([str(build(tmp_path / "port", "repro_torch"))])]
    return r, p


def _snippet(rel, src):
    return lambda root, pkg: _write(root, f"{pkg}/{rel}", src.replace("repro_torch.", f"{pkg}."))


def _manager(old, new):
    src_of = {"repro": REPO / "src" / "repro", "repro_torch": SRC_PORT}
    # the reference's pin-lock block is written differently; the other
    # anchors read the same in both managers
    ref_pin = (
        """        with self._pin_lock:
            # pins die with their save: drop entries whose save finished
            self._pinned_chains = {
                r: c for r, c in self._pinned_chains.items() if r in inflight
            }""",
        """        # pins die with their save: drop entries whose save finished
        self._pinned_chains = {
            r: c for r, c in self._pinned_chains.items() if r in inflight
        }""",
    )

    def build(root, pkg):
        o, n = ref_pin if (pkg == "repro" and (old, new) == PIN_LOCK_BLOCK) else (old, new)
        return _transformed_copy(root, "ckpt/manager.py", o, n, pkg=pkg, src=src_of[pkg])

    return build


PARITY = {
    "lock": _snippet("mod.py", LOCKED_CLASS),
    "lock-augassign": _snippet("mod.py", AUGASSIGN_CLASS),
    "clock": _snippet("mod.py", WALL_CLOCK),
    "clock-other-core": _snippet("core/other.py", "import time\nnow = time.time()\n"),
    "decode": _snippet("mod.py", RAW_PAYLOAD_IO),
    "except": _snippet("mod.py", BROAD_HANDLERS),
    "reasonless-allow": _snippet("mod.py", REASONLESS_ALLOW),
    "catalog": lambda root, pkg: _mini_tree(root, UNREGISTERED, pkg=pkg),
    "catalog-literal": lambda root, pkg: _mini_tree(root, NON_LITERAL, pkg=pkg),
    "pin-read-order": _manager(*READ_ORDER),
    "pin-newest-first": _manager(*NEWEST_FIRST),
    "pin-lock-block": _manager(*PIN_LOCK_BLOCK),
    **{f"silent-{cid}": _snippet(rel, src) for cid, rel, src in SUPPRESSED},
}


@pytest.mark.parametrize("fixture", sorted(PARITY))
def test_diagnostics_equal_the_reference_linters(tmp_path, fixture):
    # the two managers are different files: positions compare by the code there
    ref, port = _both(tmp_path, PARITY[fixture], "text" if fixture.startswith("pin-") else "line")
    assert sorted(port) == sorted(ref)
    if not fixture.startswith("silent-"):
        assert port, "a known-bad fixture must produce findings"


def test_rules_equal_the_reference_linters():
    from repro.analysis import all_checkers as ref_checkers

    assert [c.name for c in all_checkers()] == [c.name for c in ref_checkers()]


# ---------------------------------------------------------------------------
# the annotations the port had dropped, restored: stripping one fails


def _untagged(path, tag_text, replacement=""):
    """``path``'s source with the ``# repro:`` comment cut from every line
    that holds ``tag_text`` (and ``replacement`` put in its place)."""
    src = path.read_text()
    lines = [ln for ln in src.splitlines() if tag_text in ln]
    assert lines, f"{tag_text!r} not found in {path}"
    for ln in lines:
        src = src.replace(ln, ln[: ln.index("  # repro:")] + replacement, 1)
    return src


RESTORED = [
    # (id, file, tag text to strip, text put in its place, rule, message fragments, count)
    ("engine-reap-holds", "core/engine.py", "def _reap_locked(self) -> None:  # repro: holds[self._lock]",
     None, "lock-discipline", ("BufferArena._pending", "BufferArena._retained",
                               "BufferArena._free", "BufferArena._pooled_ids"), 6),
    ("engine-index-peek", "core/engine.py", "misses retry under the lock", "",
     "lock-discipline", ("CheckpointEngine._indexes",), 1),
    ("snapshot-evict-holds", "hot/snapshot.py", "def _evict_locked(self) -> None:  # repro: holds[self._lock]",
     None, "lock-discipline", ("HotTier._ring", "HotTier.evictions"), 5),
    ("saver-base-exception", "ckpt/saver.py", "stashed and re-raised via check()", "",
     "except-discipline", ("except BaseException",), 1),
    ("drain-base-exception", "hot/drain.py", "stashed and re-raised via check()", "",
     "except-discipline", ("except BaseException",), 1),
]


@pytest.mark.parametrize("case", RESTORED, ids=[c[0] for c in RESTORED])
@pytest.mark.parametrize("form", ["stripped", "free-text"])
def test_stripping_a_restored_tag_fails_lint(tmp_path, case, form):
    _, rel, tag, repl, rule, fragments, count = case
    src = (SRC_PORT / rel).read_text()
    if repl is None:
        # a holds tag: drop it, or write it in words the grammar does not read
        head = tag[: tag.index("  #")]
        new = head if form == "stripped" else head + "  # holds self._lock"
        assert src.count(tag) == 1
        src = src.replace(tag, new)
    else:
        src = _untagged(SRC_PORT / rel, tag, "" if form == "stripped" else "  # stashed")
    out = _write(tmp_path, f"repro_torch/{rel}", src)
    diags = analyze([str(out)])
    assert len(diags) == count
    assert {d.rule for d in diags} == {rule}
    for frag in fragments:
        assert any(frag in d.message for d in diags), frag
    assert analyze([str(SRC_PORT / rel)]) == []


def _port_copy(tmp_path):
    dst = tmp_path / "repro_torch"
    shutil.copytree(SRC_PORT, dst, ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def test_untagged_dryrun_catalog_rows_are_stale_in_a_whole_tree_scan(tmp_path):
    dst = _port_copy(tmp_path)
    assert analyze([str(dst)]) == []
    cat = dst / "obs" / "catalog.py"
    cat.write_text(_untagged(SRC_PORT / "obs" / "catalog.py", "allow[catalog]"))
    diags = analyze([str(dst)])
    assert [(d.rule, Path(d.path).name) for d in diags] == [("catalog", "catalog.py")] * 4
    assert sorted(d.message.split('"')[1] for d in diags) == [
        "dryrun.analyze", "dryrun.cell", "dryrun.compile", "dryrun.lower"]


def _calls_under_lock(tree, method, lock):
    """(calls of ``self.<method>()``, those lexically inside ``with
    self.<lock>:``) over a module."""
    total, held = 0, 0

    def walk(node, locked):
        nonlocal total, held
        if isinstance(node, ast.With):
            inner = locked or any(
                isinstance(i.context_expr, ast.Attribute) and i.context_expr.attr == lock
                for i in node.items
            )
            for sub in node.body:
                walk(sub, inner)
            return
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == method):
            total += 1
            held += locked
        for child in ast.iter_child_nodes(node):
            walk(child, locked)

    walk(tree, False)
    return total, held


@pytest.mark.parametrize("rel, method", [("core/engine.py", "_reap_locked"),
                                         ("hot/snapshot.py", "_evict_locked")])
def test_holds_methods_are_only_called_under_their_lock(rel, method):
    """The restored ``holds`` contracts are true: every caller holds the lock."""
    tree = ast.parse((SRC_PORT / rel).read_text())
    total, held = _calls_under_lock(tree, method, "_lock")
    assert total >= 1 and held == total


# ---------------------------------------------------------------------------
# live tree + CLI + isolation


def test_live_tree_is_clean():
    """The port lints clean: the gate that keeps its annotations honest."""
    assert analyze([str(SRC_PORT)]) == []


def test_cli_json_format(tmp_path, capsys):
    f = tmp_path / "bad.py"
    f.write_text("import time\nt = time.time()\n")
    rc = cli_main([str(f), "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out[0]["rule"] == "clock-discipline"
    assert out[0]["line"] == 2

    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    assert cli_main([str(ok)]) == 0


def test_cli_rejects_unknown_rule_and_path(tmp_path, capsys):
    assert cli_main(["--rule", "nope", str(tmp_path)]) == 2
    assert cli_main([str(tmp_path / "missing")]) == 2
    err = capsys.readouterr().err
    assert "repro_torch.analysis: unknown rule 'nope'" in err
    assert "repro_torch.analysis: no such path" in err


def test_cli_defaults_to_the_port_and_lists_rules(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert cli_main([]) == 0
    assert capsys.readouterr().out.strip() == "repro_torch.analysis: clean (src/repro_torch)"
    assert cli_main(["--list-rules"]) == 0
    assert capsys.readouterr().out.split() == [c.name for c in all_checkers()]


def test_linter_is_stdlib_only():
    for f in sorted((SRC_PORT / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert roots <= STDLIB, (f.name, roots)
