"""The kernels' lazy build under racing threads.

The parallel checkpoint engine launches block-quant kernels from several
worker threads at once, so a kernel's first ``build()`` can be entered by
many threads together.  Each build must run the compiler once, write its
library through a temporary file of its own, and hand every thread the same
loaded library.  The compiler here is a stand-in script (this container has
no ``nvcc``) that counts its runs and sleeps, to widen the race.
"""

import importlib
import stat
import sys
import threading
import types

import pytest

pytest.importorskip("torch")

import repro_torch.kernels.nvcc as nvcc  # noqa: E402

KERNELS = ["block_quant", "flash_attention", "ssd_scan"]

FAKE_NVCC = """#!{python}
import pathlib, sys, time
count = pathlib.Path({count!r})
with open(count, "a") as f:
    f.write("x")
time.sleep(0.3)
out = sys.argv[sys.argv.index("-o") + 1]
pathlib.Path(out).write_bytes(b"fake library " + out.encode())
"""


class _FakeLib:
    """What ``ctypes.CDLL`` gives: a library whose functions take argtypes."""

    def __init__(self, path):
        self.path = path
        self._fns = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self._fns.setdefault(name, types.SimpleNamespace())


@pytest.mark.parametrize("name", KERNELS)
def test_build_compiles_once_under_racing_threads(tmp_path, monkeypatch, name):
    kernel = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    count = tmp_path / "count"
    script = tmp_path / "nvcc"
    script.write_text(FAKE_NVCC.format(python=sys.executable, count=str(count)))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    loaded = []
    monkeypatch.setattr(nvcc, "_nvcc", lambda: str(script))
    monkeypatch.setattr(nvcc, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(nvcc.ctypes, "CDLL", lambda path: loaded.append(path) or _FakeLib(path))
    monkeypatch.setattr(kernel, "_LIB", None)
    monkeypatch.setattr(kernel, "_REPORT", None)

    barrier = threading.Barrier(8)
    got, errors = [None] * 8, []

    def worker(i):
        try:
            barrier.wait(10)
            got[i] = kernel.build()
        except BaseException as e:  # re-raised by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    assert count.read_text() == "x", "the compiler ran more than once"
    assert len(loaded) == 1, loaded
    libs = {id(lib) for lib, _ in got}
    assert len(libs) == 1, "threads got different libraries"
    lib, report = got[0]
    assert report["compiled"] and lib.path == report["library"]
    built = list((tmp_path / "build").iterdir())
    assert [p.name for p in built] == [report["library"].rsplit("/", 1)[1]], built
    assert kernel.build() == (lib, report)  # later calls come from memory


def test_temporary_names_differ_per_build(tmp_path, monkeypatch):
    """Two builds of one source in one process never share a temporary
    file: each names its own, and both leave one finished library."""
    count = tmp_path / "count"
    script = tmp_path / "nvcc"
    script.write_text(FAKE_NVCC.format(python=sys.executable, count=str(count)))
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(nvcc, "_nvcc", lambda: str(script))
    monkeypatch.setattr(nvcc, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(nvcc.ctypes, "CDLL", _FakeLib)
    source = tmp_path / "k.cu"
    source.write_text("// a kernel\n")
    outs, barrier = [], threading.Barrier(2)

    def build():
        barrier.wait(10)
        outs.append(nvcc.compile_and_load(source, "k"))

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(outs) == 2 and count.read_text() == "xx"
    (lib,) = list((tmp_path / "build").iterdir())
    # each run wrote its own temporary, so the library is one whole file
    assert lib.read_bytes().startswith(b"fake library ") and b".tmp.so" in lib.read_bytes()
    assert not [p for p in (tmp_path / "build").iterdir() if p.name.endswith(".tmp.so")]
