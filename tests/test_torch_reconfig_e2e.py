"""End-to-end reconfiguration through the port's training launcher (paper
§4.2, Fig. 6/7; the cases of ``tests/test_reconfig_e2e.py``).

``python -m repro_torch.launch.train --device cpu`` with the reference's
flags (reduced smollm, batch 4, seq 32, a save at step 5, ``--sync-save``)
but without ``--host-devices``: one device runs the logical model, and
``--mesh`` sets the checkpoint geometry.  Five Targets resume one Source
saved under data=2,model=2, and three Sources converge on data=2,model=2.
Each resume must restore step 5 in the expected mode and then track the
port's own uninterrupted 10-step data=2,model=2 run within the reference's
2e-2.  (The reference cannot run these cases in this container: its
training under a mesh fails with jax 0.9, so the port holds itself to its
own baseline.)

Independent launcher runs go out together, one thread each, so the file
stays well inside a minute and a half.

The multi-rank cases run the Source as 4 ranks (``--host-devices 4
--mesh data=2,model=2``: 4 processes in a gloo group, each holding, saving
and restoring only its own shards) and resume it as 2 ranks under another
mesh (``--host-devices 2``), each tracking the same baseline within 2e-2.

``test_moe_arch_reconfig`` is the reference's Fig. 10 case: reduced
mixtral trained under expert parallelism (data=1,model=4), resumed under
expert-TP (data=2,model=2, ``--no-ep``) through RESHARD_STREAM, with
finite losses below 20 (~15 s: the resume reads the Source's save, so the
two runs go one after the other).
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-2  # tests/test_reconfig_e2e.py: the paper's accepted divergence

BASE = [
    sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
    "--arch", "smollm-360m", "--reduced",
    "--batch", "4", "--seq", "32", "--save-interval", "5",
    "--sync-save", "--log-json", "--total-steps", "200",
]

# One Source → several Targets (Fig. 6): (mesh, extra flags, expected mode)
TARGETS = [
    ("data=2,model=2", [], "direct"),
    ("data=4,model=1", [], "reshard_stream"),
    ("data=1,model=2", ["--zero", "1", "--no-fsdp"], "reshard_stream"),
    ("data=2,model=4", [], "reshard_stream"),
    ("pipe=2,data=2,model=2", [], "reshard_stream"),
]
# Several Sources → one Target, data=2,model=2 (Fig. 7): (mesh, flags)
SOURCES = [
    ("data=4,model=1", []),
    ("data=1,model=4", []),
    ("data=2,model=2", ["--zero", "1", "--no-fsdp"]),
]


# The reference's MoE case (tests/test_reconfig_e2e.py::test_moe_arch_reconfig)
# without --host-devices: one Source under EP, one Target under expert-TP.
MOE = [
    sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
    "--arch", "mixtral-8x22b", "--reduced", "--batch", "4", "--seq", "16",
    "--sync-save", "--log-json",
]
MOE_SOURCE = ["--mesh", "data=1,model=4", "--steps", "4", "--save-interval", "4"]
MOE_TARGET = ["--mesh", "data=2,model=2", "--steps", "6", "--save-interval", "100", "--no-ep"]


def _start(args, base=BASE):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen(base + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _finish(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-2000:]
    steps, restored = {}, None
    for line in out.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("event") == "step":
                steps[rec["step"]] = rec["loss"]
            elif rec.get("event") == "restored":
                restored = rec
    return steps, restored


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The MoE Source under EP, then its resume under expert-TP."""
    ck = tmp_path_factory.mktemp("moe")
    src = _finish(_start(MOE_SOURCE + ["--ckpt-dir", str(ck)], base=MOE))
    tgt = _finish(_start(MOE_TARGET + ["--ckpt-dir", str(ck)], base=MOE))
    return src, tgt


def test_moe_arch_reconfig(moe_runs):
    """UCP is arch-agnostic (Fig. 10): MoE with EP → expert-TP reconfig."""
    (src_steps, _), (steps, restored) = moe_runs
    assert sorted(src_steps) == [1, 2, 3, 4]
    assert restored is not None and restored["mode"] == "reshard_stream", restored
    assert restored["step"] == 4
    assert sorted(steps) == [5, 6]
    losses = list(src_steps.values()) + list(steps.values())
    assert losses and all(loss == loss and loss < 20 for loss in losses)


def _all(arg_lists):
    procs = [_start(a) for a in arg_lists]
    return [_finish(p) for p in procs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted baseline, the Sources, then every resumed run."""
    src = tmp_path_factory.mktemp("src")
    multi = [tmp_path_factory.mktemp(f"multi{i}") for i in range(len(SOURCES))]
    first = _all(
        [["--mesh", "data=2,model=2", "--steps", "10", "--save-interval", "100"],
         ["--mesh", "data=2,model=2", "--steps", "5", "--ckpt-dir", str(src)]]
        + [["--mesh", mesh, "--steps", "5", "--ckpt-dir", str(d), *flags]
           for (mesh, flags), d in zip(SOURCES, multi)]
    )
    baseline = first[0][0]
    assert sorted(baseline) == list(range(1, 11))
    resumed = _all(
        [["--mesh", mesh, "--steps", "10", "--ckpt-dir", str(src), "--save-interval", "100",
          *flags] for mesh, flags, _ in TARGETS]
        + [["--mesh", "data=2,model=2", "--steps", "8", "--ckpt-dir", str(d),
            "--save-interval", "100"] for d in multi]
    )
    return baseline, resumed[: len(TARGETS)], resumed[len(TARGETS):]


@pytest.mark.parametrize("case", range(len(TARGETS)), ids=[t[0] for t in TARGETS])
def test_single_source_to_target(runs, case):
    baseline, single, _ = runs
    steps, restored = single[case]
    assert restored is not None and restored["step"] == 5
    assert restored["mode"] == TARGETS[case][2], restored["reason"]
    assert sorted(steps) == list(range(6, 11))
    for s in range(6, 11):
        assert abs(steps[s] - baseline[s]) < TOL, (
            f"step {s}: resumed {steps[s]:.4f} vs baseline {baseline[s]:.4f}"
        )


@pytest.mark.parametrize("case", range(len(SOURCES)),
                         ids=[" ".join([m, *f]) for m, f in SOURCES])
def test_multiple_sources_to_single_target(runs, case):
    baseline, _, multi = runs
    steps, restored = multi[case]
    assert restored is not None and restored["step"] == 5
    assert restored["mode"] == "reshard_stream", restored["reason"]
    assert sorted(steps) == list(range(6, 9))
    for s in range(6, 9):
        assert abs(steps[s] - baseline[s]) < TOL


# Multi-rank: a 4-rank Source, resumed as 2 ranks under another mesh.
RANK_TARGETS = [("data=2,model=1", "reshard_stream"), ("data=1,model=2", "reshard_stream")]


@pytest.fixture(scope="module")
def rank_runs(runs, tmp_path_factory):
    baseline = runs[0]
    ck = tmp_path_factory.mktemp("ranks")
    (source,) = _all([["--host-devices", "4", "--mesh", "data=2,model=2", "--steps", "5",
                       "--ckpt-dir", str(ck)]])
    resumed = _all([["--host-devices", "2", "--mesh", mesh, "--steps", "10", "--ckpt-dir",
                     str(ck), "--save-interval", "100"] for mesh, _ in RANK_TARGETS])
    return baseline, source, resumed


def test_four_rank_source_tracks_the_baseline(rank_runs):
    baseline, (steps, restored), _ = rank_runs
    assert restored is None and sorted(steps) == list(range(1, 6))
    for s in range(1, 6):
        assert abs(steps[s] - baseline[s]) < TOL


@pytest.mark.parametrize("case", range(len(RANK_TARGETS)), ids=[t[0] for t in RANK_TARGETS])
def test_four_ranks_resume_as_two(rank_runs, case):
    baseline, _, resumed = rank_runs
    steps, restored = resumed[case]
    assert restored is not None and restored["step"] == 5
    assert restored["mode"] == RANK_TARGETS[case][1], restored["reason"]
    assert sorted(steps) == list(range(6, 11))
    for s in range(6, 11):
        assert abs(steps[s] - baseline[s]) < TOL, (
            f"step {s}: resumed {steps[s]:.4f} vs baseline {baseline[s]:.4f}"
        )
