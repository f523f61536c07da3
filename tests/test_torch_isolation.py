"""The port stands alone, and its CUDA path never falls back.

* An AST scan of every file under ``src/repro_torch/`` and of
  ``chip_smoke.py``: no import of ``jax``, ``ml_dtypes`` or ``repro`` (the
  JAX package; ``repro_torch`` is the port).
* Without a card, the CUDA path raises: the kernel launcher refuses
  non-CUDA tensors, ``--device cuda`` raises, and ``chip_smoke.py`` exits
  non-zero without printing a result.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", "")
        ) == "import_module" and node.args:
            # importlib.import_module("pkg.mod") or f"pkg.{name}": the leading text
            first = node.args[0]
            if isinstance(first, ast.JoinedStr) and first.values:
                first = first.values[0]
            if isinstance(first, ast.Constant):
                roots.add(str(first.value).split(".")[0])
    return roots


def test_scan_covers_the_port():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/kernels/flash_attention/kernel.py" in names
    for module in ("obs/trace.py", "obs/sinks.py", "chaos/points.py", "hot/snapshot.py",
                   "hot/drain.py", "hot/recovery.py", "elastic/planner.py", "elastic/resume.py",
                   "serve/registry.py", "serve/peer.py", "serve/fleet.py", "chaos/schedule.py",
                   "chaos/invariants.py", "chaos/harness.py", "chaos/sweep.py",
                   "dist/collectives.py", "dist/__init__.py", "dist/sharding.py",
                   "train/steps.py", "train/trainer.py", "launch/train.py",
                   "analysis/__init__.py",
                   "analysis/__main__.py", "analysis/core.py", "analysis/simple_rules.py",
                   "analysis/locks.py", "analysis/catalog_rules.py", "analysis/pins.py"):
        assert f"src/repro_torch/{module}" in names, module
    assert len(names) > 30


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_nothing_of_jax_or_the_reference(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_kernel_refuses_non_cuda_tensors():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="not CUDA"):
        kernel.flash_attention_fwd(q, q, q, causal=True, window=0, scale=0.25)


def test_wrapper_has_no_fallback_off_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    routed to the plain version."""
    q = torch.zeros(1, 8, 2, 16, device="meta")
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        flash_attention(q, q, q)
    assert flash_attention.launches == launches


def test_cuda_device_is_required_when_asked_for():
    if torch.cuda.is_available():
        assert serve.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            serve.resolve_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            serve.main(["--arch", "smollm-360m", "--reduced"])
    assert serve.resolve_device("cpu").type == "cpu"


def _smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=300, check=False, env=dict(os.environ, PYTHONPATH=""),
    )


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
