"""The port's chaos harness (``repro_torch.chaos``), held against the JAX
package (``tests/test_chaos.py`` case by case): fault points, scheduled
replay, the ladder invariant, and the previously fixed races re-expressed
as explicit chaos schedules, on the CPU.

The replay tests revert a specific fix with monkeypatch and assert that
the exact schedule that found the bug fails again, which proves the
schedule pins the race, not an accident of timing:

* GC against an in-flight save: ``pending_roots()`` keeps a mid-write save
  out of wreckage removal;
* the delta base TOCTOU: the base loader pins the resolved chain under the
  lock GC deletes under (``check_chain_committed`` is the loud backstop);
* GC deletes newest-first, so a crash mid-GC never leaves a surviving
  committed delta referencing a collected ancestor;
* the published step outlives ``keep_last``.

Across packages: ``generate_schedule(seed)`` gives the reference's JSON for
seeds 0-24, and for seeds 0-4 a whole harness run gives the reference's
report: ``ok``, ``config``, ``schedule``, ``events_completed``,
``violations``, and the kind, name and step of each timeline entry (as a
multiset: entries of threads that overlap in time land in either order; the
port's ``engine.index_build`` spans are left out, since its manager drops
each restore's caches and so builds more indexes), with the faults that
fired and the invariant checks in the reference's order.
"""

import collections
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.chaos.schedule import generate_schedule as ref_generate  # noqa: E402
from repro.chaos.sweep import run_seed as ref_run_seed  # noqa: E402

import repro_torch.ckpt.saver as saver_mod  # noqa: E402
from repro_torch.chaos import (  # noqa: E402
    CATALOG,
    ChaosController,
    FaultError,
    FaultSpec,
    Schedule,
    check_invariants,
    fault_point,
    generate_schedule,
)
from repro_torch.chaos.harness import ChaosHarness, ChaosReport, _is_fault  # noqa: E402
from repro_torch.chaos.invariants import InvariantViolation, diff_snapshots  # noqa: E402
from repro_torch.chaos.sweep import emit_regression_test, run_seed, shrink, sweep  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.saver import AsyncSaver, snapshot_state, write_distributed  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DimSpec,
    DistCheckpoint,
    MeshSpec,
    STATE_KINDS,
    StateKind,
    uniform_param_spec,
)
from repro_torch.core import clock  # noqa: E402
from repro_torch.dist.sharding import ShardingPlan  # noqa: E402
from repro_torch.serve import FleetReplica, PublicationRegistry  # noqa: E402
from repro_torch.train.optimizer import TrainState  # noqa: E402

MESH_2X2 = MeshSpec.from_dict({"data": 2, "model": 2})
MESH_1X1 = MeshSpec.from_dict({"data": 1, "model": 1})
DEV = "cpu"


def _specs():
    return {
        "w": uniform_param_spec("w", (8, 6), [DimSpec(("data",)), DimSpec(("model",))]),
        "u": uniform_param_spec("u", (6, 4), [DimSpec(("model",)), DimSpec()]),
        "b": uniform_param_spec("b", (4,), [DimSpec()]),  # fully replicated
    }


def _random_state(specs, seed=0):
    rng = np.random.default_rng(seed)
    return {
        n: {k: rng.normal(size=s.runtime_shape).astype(np.float32) for k in STATE_KINDS}
        for n, s in specs.items()
    }


def _train_state(snap, step):
    def tree(kind):
        return {n: torch.from_numpy(snap[n][kind].copy()) for n in snap}

    return TrainState(params=tree(StateKind.FP32), exp_avg=tree(StateKind.EXP_AVG),
                      exp_avg_sq=tree(StateKind.EXP_AVG_SQ), step=step)


def _mutate(snap, seed):
    """Sparse update: one param's FP32 leaf changes, the rest stay put (so
    delta saves have both written and inherited shards)."""
    rng = np.random.default_rng(seed)
    name = sorted(snap)[seed % len(snap)]
    snap[name][StateKind.FP32] = snap[name][StateKind.FP32] + rng.normal(
        scale=0.01, size=snap[name][StateKind.FP32].shape
    ).astype(np.float32)


def _manager(root, plan, **kw):
    return CheckpointManager(root, plan, policy=CheckpointPolicy(**kw))


@pytest.fixture()
def setup(tmp_path):
    specs = _specs()
    return (tmp_path, ShardingPlan(mesh=MESH_2X2, param_specs=specs),
            ShardingPlan(mesh=MESH_1X1, param_specs=specs))


# ---------------------------------------------------------------------------
# fault points + schedules


def test_catalog_matches_callsites():
    """Every fault_point() call site of the port is in CATALOG and the other
    way round: with fan-out ported, the port calls every point."""
    src = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
    seen = set()
    for py in src.rglob("*.py"):
        if "chaos" in py.parts:
            continue
        seen |= set(re.findall(r'fault_point\(\s*"([^"]+)"', py.read_text()))
    assert seen == set(CATALOG)


def test_fault_point_is_noop_when_inactive():
    fault_point("saver.shard", step=1)  # no controller: must not raise
    fault_point("manager.gc.begin")


def test_schedule_generation_is_deterministic():
    a = generate_schedule(42, n_faults=8)
    b = generate_schedule(42, n_faults=8)
    assert a == b
    assert generate_schedule(43, n_faults=8) != a


def test_schedule_json_roundtrip_and_prefix():
    s = generate_schedule(7, n_faults=5)
    assert Schedule.from_json(s.to_json()) == s
    assert s.prefix(2).faults == s.faults[:2]
    assert s.prefix(2).seed == s.seed


def test_schedule_rejects_unknown_points_and_actions():
    with pytest.raises(ValueError, match="unknown fault point"):
        FaultSpec(point="no.such.point")
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultSpec(point="saver.shard", action="explode")
    with pytest.raises(ValueError, match="hit must be"):
        FaultSpec(point="saver.shard", hit=0)


def test_controller_requires_env_handlers():
    sched = Schedule(0, (FaultSpec("saver.shard", action="lose_ranks", args=(1,)),))
    with pytest.raises(ValueError, match="chaos_lose_ranks"):
        ChaosController(sched, env=object())


def test_controller_counts_hits_from_arming():
    """The second fault's hit counter restarts when it arms: the property
    that makes prefix replay (and so shrinking) sound."""
    sched = Schedule(0, (
        FaultSpec("manager.gc.begin", hit=2),
        FaultSpec("manager.gc.begin", hit=2),
    ))
    fired = []
    with ChaosController(sched) as ctrl:
        for i in range(4):
            try:
                fault_point("manager.gc.begin")
            except FaultError:
                fired.append(i)
    assert fired == [1, 3]
    assert ctrl.exhausted


# ---------------------------------------------------------------------------
# invariants


def test_invariants_clean_manager_passes(setup):
    tmp, plan, tgt_plan = setup
    mgr = _manager(tmp / "ckpt", plan, keep_last=2, save_interval=10, async_save=False,
                   io_workers=1)
    mgr.save(_train_state(_random_state(plan.param_specs), 10), 10)
    assert check_invariants(mgr) == []
    mgr.close()


def test_invariants_flag_torn_checkpoint(setup):
    tmp, plan, tgt_plan = setup
    mgr = _manager(tmp / "ckpt", plan, keep_last=2, save_interval=10, async_save=False,
                   io_workers=1)
    mgr.save(_train_state(_random_state(plan.param_specs), 10), 10)
    next(mgr.step_dir(10).glob("ranks/rank_*/*.npy")).unlink()  # torn after commit
    viol = check_invariants(mgr)
    assert viol and all(v.check == "disk" for v in viol)
    with pytest.raises(InvariantViolation):
        check_invariants(mgr, strict=True)
    mgr.close()


def test_diff_snapshots_is_bit_exact():
    a = _random_state(_specs(), seed=1)
    b = {n: {k: v.copy() for k, v in kv.items()} for n, kv in a.items()}
    assert diff_snapshots(a, b) == []
    b["w"][StateKind.FP32][0, 0] += np.float32(1e-7)
    diffs = diff_snapshots(a, b)
    assert diffs and "w" in diffs[0]
    # tensors compare by their host values
    t = {n: {k: torch.from_numpy(v) for k, v in kv.items()} for n, kv in a.items()}
    assert diff_snapshots(t, a) == []


# ---------------------------------------------------------------------------
# background-error surfacing (async saver / hot drainer)


def test_async_save_crash_surfaces_on_wait(setup):
    tmp, plan, tgt_plan = setup
    mgr = _manager(tmp / "ckpt", plan, keep_last=2, save_interval=10, async_save=True,
                   io_workers=1)
    snap = _random_state(plan.param_specs)
    with ChaosController(Schedule(0, (FaultSpec("saver.shard", action="crash", hit=1),))):
        mgr.save(_train_state(snap, 10), 10)
        with pytest.raises(RuntimeError, match="async checkpoint save failed") as ei:
            mgr.wait()
    assert _is_fault(ei.value)
    assert mgr.wait() == []  # errors drained: the next wait is clean
    mgr.close()


def test_async_save_crash_surfaces_on_close(setup):
    tmp, plan, tgt_plan = setup
    mgr = _manager(tmp / "ckpt", plan, keep_last=2, save_interval=10, async_save=True,
                   io_workers=1)
    snap = _random_state(plan.param_specs)
    with ChaosController(Schedule(0, (FaultSpec("saver.pre_commit", action="crash", hit=1),))):
        mgr.save(_train_state(snap, 10), 10)
        with pytest.raises(RuntimeError, match="async checkpoint save failed"):
            mgr.close()
    assert mgr.steps() == []  # a crash before COMMIT: discovery ignores it


def test_drain_crash_surfaces_on_wait(setup):
    tmp, plan, tgt_plan = setup
    mgr = _manager(tmp / "ckpt", plan, keep_last=2, save_interval=10, hot_interval=10,
                   disk_interval=10, async_save=True, io_workers=1)
    snap = _random_state(plan.param_specs)
    with ChaosController(Schedule(0, (FaultSpec("drain.shard", action="crash", hit=1),))):
        mgr.save(_train_state(snap, 10), 10)
        with pytest.raises(RuntimeError, match="hot snapshot drain failed") as ei:
            mgr.wait()
    assert _is_fault(ei.value)
    res = mgr.restore_latest(DEV, target_plan=tgt_plan)  # the hot tier still serves
    assert res is not None and res[1].step == 10
    mgr.close()


# ---------------------------------------------------------------------------
# race replays


def _paused_mid_save(tmp, plan):
    """An async save of step 10 whose writer parks mid-shards on a gate."""
    mgr = _manager(tmp / "ckpt", plan, keep_last=2, save_interval=10, async_save=True,
                   io_workers=1)
    sched = Schedule(0, (FaultSpec("saver.shard", action="pause", hit=10, args=("mid-save",)),))
    return mgr, ChaosController(sched)


def test_replay_gc_vs_inflight_save(setup):
    """GC runs while an older async save is mid-write: ``pending_roots``
    keeps its uncommitted directory out of wreckage removal."""
    tmp, plan, tgt_plan = setup
    snap = _random_state(plan.param_specs)
    mgr, ctrl = _paused_mid_save(tmp, plan)
    with ctrl:
        mgr.save(_train_state(snap, 10), 10)
        ctrl.wait_paused("mid-save")
        mgr.save(_train_state(snap, 20), 20, block=True)
        assert mgr.steps() == [20]
        ctrl.release("mid-save")
        mgr.wait()
    assert mgr.steps() == [10, 20]
    assert check_invariants(mgr) == []
    mgr.close()


def test_replay_gc_vs_inflight_save_fails_without_fix(setup, monkeypatch):
    tmp, plan, tgt_plan = setup
    snap = _random_state(plan.param_specs)
    mgr, ctrl = _paused_mid_save(tmp, plan)
    monkeypatch.setattr(AsyncSaver, "pending_roots", lambda self: set())  # revert the fix
    with ctrl:
        mgr.save(_train_state(snap, 10), 10)
        ctrl.wait_paused("mid-save")
        mgr.save(_train_state(snap, 20), 20, block=True)
        ctrl.release("mid-save")
        err = None
        try:
            mgr.wait()
        except RuntimeError as e:
            err = e
    assert err is not None or check_invariants(mgr), (
        "reverting pending_roots() must reproduce the GC-vs-in-flight race"
    )
    try:
        mgr.close()
    except RuntimeError:
        pass


def _paused_mid_delta(tmp, plan, snap):
    """A committed full step 10, then an async delta save of step 20 frozen
    right after its base (step 10) resolved, before any shard write."""
    mgr = _manager(tmp / "ckpt", plan, keep_last=1, save_interval=10, async_save=True,
                   io_workers=1, save_mode="delta", full_interval=8)
    mgr.save(_train_state(snap, 10), 10, block=True)  # seq 0: a forced full save
    _mutate(snap, 1)
    sched = Schedule(0, (FaultSpec("saver.shard", action="pause", hit=1, args=("mid-delta",)),))
    return mgr, ChaosController(sched)


def test_replay_delta_base_toctou(setup):
    """GC wants the base of a queued delta while the delta is mid-write: the
    pinned chain survives until the commit."""
    tmp, plan, tgt_plan = setup
    snap = _random_state(plan.param_specs)
    mgr, ctrl = _paused_mid_delta(tmp, plan, snap)
    ref20 = {n: {k: v.copy() for k, v in kv.items()} for n, kv in snap.items()}
    with ctrl:
        mgr.save(_train_state(snap, 20), 20)  # a delta over step 10
        ctrl.wait_paused("mid-delta")
        write_distributed(_random_state(plan.param_specs, seed=9), plan, 30, mgr.step_dir(30),
                          engine=mgr.engine)
        mgr.gc()
        assert 10 in mgr.steps(), "the pinned base must survive mid-delta GC"
        ctrl.release("mid-delta")
        mgr._async.wait()  # drain without GC: assert the committed chain
    assert set(mgr.steps()) == {10, 20, 30}
    assert check_invariants(mgr) == []
    res = mgr.restore(DEV, step=20, target_plan=tgt_plan, verify=True)
    assert res is not None
    assert diff_snapshots(snapshot_state(res[0]), ref20) == []
    mgr.close()


def test_replay_delta_base_toctou_fails_without_fix(setup, monkeypatch):
    tmp, plan, tgt_plan = setup
    snap = _random_state(plan.param_specs)

    def leaky_base_loader(self, step):
        # the loader before the fix: no pin, outside GC's deletion lock
        def load():
            older = [s for s in self.steps() if s < step]
            if not older:
                return None
            try:
                return DistCheckpoint.open(self.step_dir(older[-1]))
            except (OSError, ValueError, KeyError):
                return None
        return load

    monkeypatch.setattr(CheckpointManager, "_base_loader", leaky_base_loader)
    monkeypatch.setattr(saver_mod, "check_chain_committed", lambda c: None)  # the backstop
    mgr, ctrl = _paused_mid_delta(tmp, plan, snap)
    with ctrl:
        mgr.save(_train_state(snap, 20), 20)
        ctrl.wait_paused("mid-delta")
        write_distributed(_random_state(plan.param_specs, seed=9), plan, 30, mgr.step_dir(30),
                          engine=mgr.engine)
        mgr.gc()
        assert 10 not in mgr.steps(), "unpinned base collected (fix reverted)"
        ctrl.release("mid-delta")
        mgr._async.wait()
    viol = check_invariants(mgr)
    assert any("live base collected" in str(v) for v in viol), (
        "reverting base pinning must commit a delta over a collected base"
    )
    mgr.close()


def test_gc_crash_mid_loop_deletes_newest_first(setup):
    """A crash between two GC deletions never leaves a surviving committed
    delta referencing a deleted ancestor: deletion is newest-first (found
    by the reference's chaos seed 23)."""
    tmp, plan, tgt_plan = setup
    snap = _random_state(plan.param_specs)
    mgr = _manager(tmp / "ckpt", plan, keep_last=1, save_interval=10, async_save=False,
                   io_workers=1, save_mode="delta", full_interval=3)
    for step in (10, 20, 30):
        mgr.save(_train_state(snap, step), step)
        _mutate(snap, step)
    with ChaosController(Schedule(0, (FaultSpec("manager.gc.delete", action="crash", hit=2),))):
        with pytest.raises(FaultError):
            mgr.save(_train_state(snap, 40), 40)  # crash after one deletion
    assert set(mgr.steps()) == {10, 20, 40}
    assert check_invariants(mgr) == []
    assert mgr.restore(DEV, step=20, target_plan=tgt_plan, verify=True) is not None
    mgr.close()


def test_published_step_outlives_keep_last(setup):
    """A crash between commit and announce leaves the fleet reading the
    older publication: GC keeps that step past keep_last."""
    tmp, plan, tgt_plan = setup
    snap = _random_state(plan.param_specs)
    registry = PublicationRegistry()
    mgr = _manager(tmp / "ckpt", plan, keep_last=1, save_interval=10, async_save=False,
                   io_workers=1, registry=registry)
    mgr.save(_train_state(snap, 10), 10)  # publishes step 10
    ref10 = {n: kv[StateKind.FP32].copy() for n, kv in snap.items()}
    assert registry.current().step == 10
    sched = Schedule(0, tuple(
        FaultSpec("registry.publish.begin", action="crash", hit=1) for _ in range(3)
    ))
    with ChaosController(sched):
        for step in (20, 30, 40):
            _mutate(snap, step)
            with pytest.raises(FaultError):
                mgr.save(_train_state(snap, step), step)
    assert registry.current().step == 10
    assert set(mgr.steps()) == {10, 40}, "the published step must survive GC"
    replica = FleetReplica("r1", registry, tgt_plan, DEV)
    assert replica.sync()
    for name, t in replica.flat_params().items():
        np.testing.assert_array_equal(t.numpy(), ref10[name])
    mgr.close()


# ---------------------------------------------------------------------------
# clock injection


def test_clock_is_injectable():
    try:
        clock.set_source(lambda: 1000.0)
        assert clock.now() == 1000.0
        clock.skew(-600)
        assert clock.now() == 400.0
    finally:
        clock.reset()


def test_commit_stamps_route_through_clock(setup):
    tmp, plan, tgt_plan = setup
    try:
        clock.set_source(lambda: 12345.0)
        write_distributed(_random_state(plan.param_specs), plan, 1, tmp / "step_1")
        assert DistCheckpoint.open(tmp / "step_1").manifest.created_at == 12345.0
    finally:
        clock.reset()


def test_clock_skew_cannot_change_gc_newest(setup):
    """Discovery and GC order by step directory NAME: a checkpoint whose
    commit stamp says "two hours ago" is still the newest if its step is."""
    tmp, plan, tgt_plan = setup
    snap = _random_state(plan.param_specs)
    mgr = _manager(tmp / "ckpt", plan, keep_last=1, save_interval=10, async_save=False,
                   io_workers=1)
    try:
        mgr.save(_train_state(snap, 10), 10)
        clock.skew(-7200)
        _mutate(snap, 1)
        mgr.save(_train_state(snap, 20), 20)
        assert mgr.steps() == [20]
        assert mgr.latest_step() == 20
        assert check_invariants(mgr) == []
    finally:
        clock.reset()
        mgr.close()


# ---------------------------------------------------------------------------
# the harness end to end


def test_chaos_seed_smoke():
    """A few full seeded runs: a real manager, real faults, the ladder
    invariant checked after every event."""
    result = sweep([0, 1, 2], events=6, device=DEV)
    assert result.ok, result.describe()


def test_chaos_seed_23_regression(tmp_path):
    """Shrunk from the reference's fallen sweep seed 23: a crash between two
    GC deletions of a doomed delta chain stranded committed deltas on a
    deleted base (fixed by newest-first deletion)."""
    schedule = Schedule(seed=23, faults=(
        FaultSpec(point="drain.shard", action="skew_clock", hit=1, args=(-7200,)),
        FaultSpec(point="peer.fetch", action="crash", hit=4, args=()),
        FaultSpec(point="registry.publish.deliver", action="crash", hit=2, args=()),
        FaultSpec(point="manager.gc.delete", action="crash", hit=2, args=()),
    ))
    report = ChaosHarness(23, tmp_path / "run", events=12, schedule=schedule, device=DEV).run()
    assert report.ok, report.describe()


def test_shrink_returns_passing_report_unchanged():
    rep = run_seed(7, events=4, device=DEV)
    assert rep.ok, rep.describe()
    assert shrink(rep, device=DEV) is rep


def test_emitted_regression_test_is_valid_python():
    rep = ChaosReport(
        ok=False, seed=5, config={}, events_completed=2,
        schedule=Schedule(5, (
            FaultSpec("saver.shard", action="crash", hit=2),
            FaultSpec("manager.gc.delete", action="lose_ranks", args=(1,)),
        )),
        violations=["[disk] step 20: torn"], error=None, log=[],
    )
    src = emit_regression_test(rep)
    compile(src, "<emitted>", "exec")
    assert "seed=5" in src and "saver.shard" in src and "tmp_path" in src
    assert 'device="cpu"' in src and "repro_torch.chaos" in src


# ---------------------------------------------------------------------------
# across packages


def test_schedules_equal_the_reference():
    for seed in range(25):
        assert generate_schedule(seed).to_json() == ref_generate(seed).to_json(), seed


def _entries(report):
    return collections.Counter(
        (e["kind"], e["name"], e.get("attrs", {}).get("step"))
        for e in report.timeline if e["name"] != "engine.index_build")


def _points(report):
    """The ``chaos.point`` events by the fault point they name."""
    return collections.Counter(e.get("attrs", {}).get("point") for e in report.timeline
                               if e["name"] == "chaos.point")


def _entries_differ(port, ref) -> str:
    """The differing timeline entries, and the fault points of the
    ``chaos.point`` events where the two reports part (port, reference)."""
    a, b = _entries(port), _entries(ref)
    keys = sorted(set(a) | set(b), key=str)
    pa, pb = _points(port), _points(ref)
    points = sorted(set(pa) | set(pb), key=str)
    return (f"entries (port, reference): "
            f"{ {k: (a[k], b[k]) for k in keys if a[k] != b[k]} }; chaos.point by point: "
            f"{ {p: (pa[p], pb[p]) for p in points if pa[p] != pb[p]} }")


def _ordered(report):
    return [(e["name"], tuple(sorted((k, str(v)) for k, v in e.get("attrs", {}).items())))
            for e in report.timeline if e["name"] in ("chaos.fault", "chaos.invariant_check")]


@pytest.mark.parametrize("seed", range(5))
def test_harness_report_equals_the_reference(seed):
    port, ref = run_seed(seed, events=12, device=DEV), ref_run_seed(seed, events=12)
    assert (port.ok, port.config, port.schedule.to_json(), port.events_completed,
            port.violations) == (ref.ok, ref.config, ref.schedule.to_json(),
                                 ref.events_completed, ref.violations)
    assert _entries(port) == _entries(ref), _entries_differ(port, ref)
    assert _ordered(port) == _ordered(ref)
    assert port.ok, port.describe()
