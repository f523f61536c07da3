"""The port's elastic planning and in-process recovery, held against the JAX
package (mirrors phase 3 of ``examples/elastic_resume.py``):

* ``propose_mesh``, ``state_bytes_per_chip`` and ``param_count`` equal
  the reference's for every config at 1-16 healthy devices, under one
  explicit memory budget passed to both (the port carries no device's
  memory size: without a budget or a CUDA device to read it from, it
  raises);
* ``rebuild_on`` → ``hot_recover`` on a reduced smollm on the CPU: a rank
  whose buddy survives is lost, HOT_DIRECT continues the uninterrupted
  loss curve bit for bit, HOT_RESHARD under the proposed one-device mesh
  continues it within 1e-5, and losing a whole buddy group falls through
  to RESHARD_STREAM from the drained step — no checkpoint file opened by
  the hot restores;
* the train CLI with ``--hot-interval 2 --trace PATH --device cpu`` runs,
  drains to disk, and its Chrome trace validates (in both packages).
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.elastic.planner as RP  # noqa: E402
import repro.obs as ref_obs  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.core.layout import MeshSpec  # noqa: E402
from repro_torch.core.plan import ResumeMode  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths  # noqa: E402
from repro_torch.elastic import (  # noqa: E402
    ElasticEvent, hot_recover, param_count, propose_mesh, rebuild_on, state_bytes_per_chip,
)
from repro_torch.elastic.planner import device_budget  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
BUDGETS = (12.8e9, 2e9)  # bytes per device, given to both packages


@pytest.mark.parametrize("arch", TC.list_configs())
def test_planner_equals_reference(arch):
    cfg, rcfg = TC.get_config(arch), RC.get_config(arch)
    assert param_count(cfg) == RP.param_count(rcfg)
    for budget in BUDGETS:
        for healthy in range(1, 17):
            for md in ("float32", "bfloat16"):
                got = propose_mesh(cfg, healthy, moment_dtype=md, hbm_budget=budget)
                want = RP.propose_mesh(rcfg, healthy, moment_dtype=md, hbm_budget=budget)
                assert got.to_json() == want.to_json(), (healthy, budget, md)
                assert state_bytes_per_chip(cfg, got, moment_dtype=md) == \
                    RP.state_bytes_per_chip(rcfg, R.MeshSpec(want.axes), moment_dtype=md)


def test_planner_needs_a_budget():
    cfg = TC.get_config("smollm-360m")
    with pytest.raises(ValueError, match="hbm_budget"):
        propose_mesh(cfg, 4)
    with pytest.raises(ValueError, match="pass hbm_budget"):
        propose_mesh(cfg, 4, device="cpu")
    with pytest.raises(ValueError, match="pass hbm_budget"):
        device_budget("cpu")


CFG = TC.reduced(TC.get_config("smollm-360m"))
TCFG = TC.TrainConfig(warmup_steps=2, total_steps=20)


def _trainer(mesh, ckpt_dir=None, policy=None):
    return Trainer.create(CFG, TC.ParallelismConfig(), TCFG, MeshSpec.from_dict(mesh),
                          batch_size=4, seq_len=32, ckpt_dir=ckpt_dir, policy=policy,
                          device="cpu")


def _equal_states(a, b):
    for ta, tb in ((a.params, b.params), (a.exp_avg, b.exp_avg), (a.exp_avg_sq, b.exp_avg_sq)):
        fb = flatten_with_paths(tb)
        for name, t in flatten_with_paths(ta).items():
            region = tuple(slice(0, min(x, y)) for x, y in zip(t.shape, fb[name].shape))
            if not torch.equal(t[region], fb[name][region]):
                return False
    return True


def test_rebuild_on_hot_recover_continues_the_loss_curve(tmp_path, monkeypatch):
    policy = CheckpointPolicy(hot_interval=2, disk_interval=4, codec="int8:b256",
                              hot_replication=1, hot_max_snapshots=2, async_save=False)
    run = _trainer({"data": 2, "model": 2}, tmp_path / "ck", policy)
    state4, _ = run.run(run.init_state(), 0, 4)
    mgr = run.manager
    assert mgr.steps() == [4] and [s.step for s in mgr.hot.snapshots()] == [2, 4]
    plain = _trainer({"data": 2, "model": 2})
    _, uninterrupted = plain.run(state4, 4, 2)
    want = [h["loss"] for h in uninterrupted]

    import repro_torch.core.dist_ckpt as dc

    opened = []
    real_open = dc.DistCheckpoint.open.__func__
    monkeypatch.setattr(dc.DistCheckpoint, "open",
                        classmethod(lambda cls, root: opened.append(root) or real_open(cls, root)))
    with obs.enabled() as tracer:
        # rank 1 dies; its buddy (rank 0) still holds its fragments
        event = ElasticEvent(healthy_devices=3, reason="failure", failed_ranks=(1,))
        state, info = hot_recover(mgr, event, "cpu")
        assert (info.mode, info.step) == (ResumeMode.HOT_DIRECT, 4)
        assert _equal_states(state, state4)
        _, hist = plain.run(state, 4, 2)
        assert [h["loss"] for h in hist] == want  # the same state, the same steps

        one = rebuild_on(ElasticEvent(1, "failure"), CFG, TC.ParallelismConfig(), TCFG,
                         batch_size=4, seq_len=32, ckpt_dir=str(tmp_path / "ck"),
                         device="cpu", hbm_budget=BUDGETS[0])
        assert one.mesh.to_json() == MeshSpec.from_dict({"data": 1, "model": 1}).to_json()
        state, info = hot_recover(mgr, ElasticEvent(1, "failure"), "cpu", target_plan=one.plan)
        assert (info.mode, info.step) == (ResumeMode.HOT_RESHARD, 4)
        # neither hot restore opened a checkpoint (GC after a run reads manifests)
        assert tracer.counters().get("engine.handle.miss", 0) == 0 and opened == []
        assert _equal_states(state, state4)
        _, hist = one.run(state, 4, 2)
        assert all(abs(h["loss"] - w) <= 1e-5 for h, w in zip(hist, want)), (hist, want)

        # the whole buddy group {0, 1} is gone: every snapshot lost coverage
        state, info = hot_recover(mgr, ElasticEvent(2, "failure", (0, 1)), "cpu",
                                  target_plan=one.plan)
        assert (info.mode, info.step) == (ResumeMode.RESHARD_STREAM, 4)
        assert opened, "the fall-through reads the drained step"
        _, hist = one.run(state, 4, 2)
        assert all(math.isfinite(h["loss"]) for h in hist)
    events = [e["name"] for e in tracer.event_records()]
    assert "restore.hot_skip" in events
    mgr.close()
    one.manager.close()


def test_train_cli_hot_interval_and_trace(tmp_path):
    trace = tmp_path / "trace.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m", "--reduced",
         "--device", "cpu", "--mesh", "data=2,model=2", "--steps", "4", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"), "--hot-interval", "2",
         "--save-interval", "4", "--codec", "int8:b256", "--sync-save", "--trace", str(trace),
         "--log-json"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=False,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    steps = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    assert [s["step"] for s in steps] == [1, 2, 3, 4]
    assert (tmp_path / "ck" / "step_00000004" / "COMMIT").exists()
    assert not (tmp_path / "ck" / "step_00000002").exists()  # captured, not drained
    doc = json.loads(trace.read_text())
    n = obs.validate_chrome_trace(doc)
    assert ref_obs.validate_chrome_trace(doc) == n
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"train.step", "hot.capture", "hot.drain", "drain.shard", "manager.save"} <= names
    counters = doc["otherData"]["counters"]
    assert counters["hot.captures"] == 2 and counters["codec.encode_shards"] > 0
