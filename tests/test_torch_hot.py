"""The port's hot in-memory tier, held against the JAX package
(``tests/test_hot_tier.py`` case by case, the same inputs drawn from a seed
with numpy):

* ``buddy_group``, ``place_holders``, ``binomial_parent`` and
  ``fanout_ladder`` equal the reference's over hypothesis layouts, and a
  capture's replica accounting equals the reference's;
* after a rank failure, HOT_DIRECT and HOT_RESHARD states are bit-identical
  to the reference's ``state_from_hot`` and to the port's disk restore;
* recovery falls through when coverage is lost (an older complete
  snapshot still serves), refuses structural changes, and ``min_step``
  prefers a newer disk step;
* ring eviction by count and by bytes keeps the reference's snapshots;
* a drained step is byte-identical to ``write_distributed`` and to the
  reference's drain of the same snapshot, raw and ``int8:b256`` (encoded
  on the CPU: a host state keeps the plain codec), and restores in the
  reference; the drain survives the eviction of its queued snapshot and
  refuses an incomplete one;
* captures after a failure place replicas on survivors; ``verify``
  catches rot in memory; a restore's ``verify`` catches rot on disk;
* a crash mid-drain, driven through ``chaos.points.activate`` by a small
  controller, leaves an uncommitted directory: recovery serves the step
  from memory, and the next committed save's GC removes the wreckage.
"""

from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
import repro.hot as RH  # noqa: E402
from repro.ckpt.restore import state_from_dist as ref_state_from_dist  # noqa: E402
from repro.core.codec import CodecPolicy as RefCodecPolicy  # noqa: E402

import repro_torch.chaos as chaos  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.hot as H  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.restore import state_from_source  # noqa: E402
from repro_torch.ckpt.saver import write_distributed  # noqa: E402
from repro_torch.core.codec import CodecPolicy  # noqa: E402
from repro_torch.core.plan import ResumeMode, TargetSpec  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths  # noqa: E402
from repro_torch.core.tensor_io import IntegrityError  # noqa: E402
from repro_torch.dist.sharding import ShardingPlan, make_plan, vocab_multiple  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402

JMESH = None


def _jmesh():
    global JMESH
    if JMESH is None:
        JMESH = jax.make_mesh((1, 1), ("data", "model"))
    return JMESH


def _spec(pkg, name, shape, dims):
    return pkg.uniform_param_spec(name, shape, [pkg.DimSpec(tuple(d)) for d in dims])


def _specs_2x2(pkg):
    return {
        "w": _spec(pkg, "w", (8, 6), [("data",), ("model",)]),
        "u": _spec(pkg, "u", (6, 4), [("model",), ()]),
        "b": _spec(pkg, "b", (4,), [()]),  # fully replicated
    }


def _tgt_specs(pkg):
    return {
        "w": _spec(pkg, "w", (8, 6), [("data",), ()]),
        "u": _spec(pkg, "u", (6, 4), [(), ("data",)]),
        "b": _spec(pkg, "b", (4,), [()]),
    }


MESH_2X2 = {"data": 2, "model": 2}


def _plans(specs_fn, mesh_d):
    return (ShardingPlan(mesh=T.MeshSpec.from_dict(mesh_d), param_specs=specs_fn(T)),
            RS.ShardingPlan(mesh=R.MeshSpec.from_dict(mesh_d), param_specs=specs_fn(R)))


def _random_state(specs, seed=0):
    rng = np.random.default_rng(seed)
    return {
        n: {k: rng.normal(size=s.runtime_shape).astype(np.float32) for k in T.STATE_KINDS}
        for n, s in specs.items()
    }


def _to_ref(snap):
    return {n: {R.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snap.items()}


def _tree_bytes(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.glob("ranks/**/*.npy"))}


def _port_flat(state):
    return {(f, n): t.numpy() for f, tree in (("params", state.params), ("exp_avg", state.exp_avg),
                                              ("exp_avg_sq", state.exp_avg_sq))
            for n, t in flatten_with_paths(tree).items()}


def _ref_flat(state):
    from repro.core.pytree import flatten_with_paths as rflat

    return {(f, n): np.asarray(a) for f, tree in (("params", state.params),
                                                  ("exp_avg", state.exp_avg),
                                                  ("exp_avg_sq", state.exp_avg_sq))
            for n, a in rflat(jax.device_get(tree)).items()}


def _same_flat(a, b):
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


# ---------------------------------------------------------------------------
# Replica placement
# ---------------------------------------------------------------------------


@st.composite
def _layout_case(draw):
    data, model = draw(st.integers(1, 4)), draw(st.integers(1, 3))
    rows, cols = draw(st.integers(1, 12)), draw(st.integers(1, 9))
    axes = [(), ("data",), ("model",), ("data", "model")]
    dims = (draw(st.sampled_from(axes)), draw(st.sampled_from([(), ("model",)])))
    if set(dims[0]) & set(dims[1]):
        dims = (dims[0], ())
    world = data * model
    owner = draw(st.integers(0, world - 1))
    replication = draw(st.integers(0, 3))
    group = draw(st.sampled_from([None, 1, 2, 3]))
    exclude = draw(st.frozensets(st.integers(0, world - 1), max_size=world - 1))
    natural = draw(st.booleans())
    return {"data": data, "model": model}, (rows, cols), dims, owner, replication, group, \
        exclude, natural


@settings(max_examples=60, deadline=None)
@given(_layout_case())
def test_placement_equals_reference(case):
    mesh_d, shape, dims, owner, replication, group, exclude, natural = case
    lt = _spec(T, "w", shape, dims).layout_for(T.StateKind.FP32, T.MeshSpec.from_dict(mesh_d))
    lr = _spec(R, "w", shape, dims).layout_for(R.StateKind.FP32, R.MeshSpec.from_dict(mesh_d))
    got = H.place_holders(lt, owner, H.ReplicationPolicy(replication, group),
                          natural_replication=natural, exclude=exclude)
    want = RH.place_holders(lr, owner, RH.ReplicationPolicy(replication, group),
                            natural_replication=natural, exclude=exclude)
    assert got == want
    world = lt.mesh.size
    size = group or replication + 1
    assert H.buddy_group(owner, world, size) == RH.buddy_group(owner, world, size)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 4096))
def test_fanout_ladder_equals_reference(index):
    assert H.fanout_ladder(index) == RH.fanout_ladder(index)
    assert H.binomial_parent(index) == RH.binomial_parent(index)


def test_buddy_placement_skips_natural_dp_replicas():
    plan, rplan = _plans(_specs_2x2, MESH_2X2)
    pol = H.ReplicationPolicy(replication=1)
    lb = plan.param_specs["b"].layout_for(T.StateKind.FP32, plan.mesh)
    assert set(H.place_holders(lb, 0, pol)) == {0, 1, 2, 3}
    lw = plan.param_specs["w"].layout_for(T.StateKind.FP32, plan.mesh)
    for owner in range(4):
        holders = H.place_holders(lw, owner, pol)
        assert holders[0] == owner and len(holders) == 2
    snap = _random_state(plan.param_specs)
    tier, rtier = H.HotTier(replication=1), RH.HotTier(replication=1)
    _, stats = tier.capture(snap, plan, 1)
    _, rstats = rtier.capture(_to_ref(snap), rplan, 1)
    assert stats.natural_fragments > 0 and stats.mirrored_bytes > 0
    assert stats.resident_bytes > stats.stored_bytes
    assert vars(stats) == vars(rstats)
    tier.clear(), rtier.clear()


def test_place_holders_ring_extension_and_average():
    spec = _spec(T, "w", (6,), [("data",)])
    mesh = T.MeshSpec.from_dict({"data": 3})
    holders = H.place_holders(spec.layout_for(T.StateKind.FP32, mesh), 2,
                              H.ReplicationPolicy(replication=1))
    assert holders[0] == 2 and len(holders) == 2
    lr = _spec(T, "r", (4,), [()]).layout_for(T.StateKind.FP32, mesh)
    holders = H.place_holders(lr, 0, H.ReplicationPolicy(1), natural_replication=False)
    assert len(holders) == 2  # owner + one buddy, not all 3 naturals


# ---------------------------------------------------------------------------
# Capture → recover (bit-identity, failures, tier fall-through)
# ---------------------------------------------------------------------------


def test_hot_direct_and_reshard_bit_identical_after_rank_failure(tmp_path):
    plan, rplan = _plans(_specs_2x2, MESH_2X2)
    snap = _random_state(plan.param_specs, seed=3)
    write_distributed(snap, plan, 7, tmp_path / "disk", workers=4)
    disk = T.DistCheckpoint.open(tmp_path / "disk")
    tier, rtier = H.HotTier(replication=1), RH.HotTier(replication=1)
    tier.capture(snap, plan, 7)
    rtier.capture(_to_ref(snap), rplan, 7)
    # one failure per buddy group, no natural replica pair dies whole
    assert tier.fail_ranks({0, 3}) == {} == rtier.fail_ranks({0, 3})
    tplan, trplan = _plans(_tgt_specs, {"data": 4, "model": 1})
    for name, (p, rp) in (("direct", (plan, rplan)), ("reshard", (tplan, trplan))):
        hp = H.plan_hot_recovery(tier, TargetSpec(p.mesh, p.param_specs))
        rhp = RH.plan_hot_recovery(rtier, R.TargetSpec(rp.mesh, rp.param_specs))
        assert hp is not None and hp.step == 7
        want = ResumeMode.HOT_DIRECT if name == "direct" else ResumeMode.HOT_RESHARD
        assert hp.mode == want and rhp.mode.value == want.value
        s_hot = _port_flat(H.state_from_hot(hp.snapshot, p, "cpu", verify=True))
        s_disk = _port_flat(state_from_source(disk, p, "cpu")) if name == "direct" else None
        s_ref = _ref_flat(RH.state_from_hot(rhp.snapshot, rp, _jmesh(), verify=True))
        _same_flat(s_hot, s_ref)
        if s_disk is not None:
            _same_flat(s_hot, s_disk)
        else:  # the port's disk RESHARD_STREAM of the same state
            from repro_torch.ckpt.restore import state_from_stream
            from repro_torch.core.plan import stream_transforms

            tr = stream_transforms(disk.manifest, TargetSpec(p.mesh, p.param_specs))
            _same_flat(s_hot, _port_flat(state_from_stream(disk, p, "cpu", tr)))
    tier.clear(), rtier.clear()


def test_hot_recovery_falls_through_when_coverage_lost():
    plan, rplan = _plans(_specs_2x2, MESH_2X2)
    target = TargetSpec(plan.mesh, plan.param_specs)
    tier, rtier = H.HotTier(replication=1), RH.HotTier(replication=1)
    snap = _random_state(plan.param_specs)
    tier.capture(snap, plan, 5)
    rtier.capture(_to_ref(snap), rplan, 5)
    dead, rdead = tier.fail_ranks({0, 1}), rtier.fail_ranks({0, 1})
    assert dead and dead == rdead, "losing a full buddy group must lose fragments"
    assert H.plan_hot_recovery(tier, target) is None
    tier2 = H.HotTier(replication=1, max_snapshots=4)
    tier2.capture(_random_state(plan.param_specs, 1), plan, 5)
    tier2.capture(_random_state(plan.param_specs, 2), plan, 10)
    tier2.snapshots()[-1].fail_ranks({0, 1})  # the newest snapshot only loses coverage
    hp = H.plan_hot_recovery(tier2, target)
    assert hp is not None and hp.step == 5
    tier.clear(), tier2.clear(), rtier.clear()


def test_hot_reshard_rejects_structural_changes():
    plan, _ = _plans(_specs_2x2, MESH_2X2)
    tier = H.HotTier(replication=3)
    tier.capture(_random_state(plan.param_specs), plan, 5)
    changed = dict(plan.param_specs)
    changed["w"] = _spec(T, "w", (10, 6), [("data",), ()])
    assert H.plan_hot_recovery(tier, TargetSpec(plan.mesh, changed)) is None
    tier.clear()


def test_min_step_prefers_newer_disk_checkpoint():
    plan, _ = _plans(_specs_2x2, MESH_2X2)
    tier = H.HotTier()
    tier.capture(_random_state(plan.param_specs), plan, 5)
    target = TargetSpec(plan.mesh, plan.param_specs)
    assert H.plan_hot_recovery(tier, target, min_step=5) is not None
    assert H.plan_hot_recovery(tier, target, min_step=6) is None
    tier.clear()


# ---------------------------------------------------------------------------
# Ring buffer budget
# ---------------------------------------------------------------------------


def _square(pkg):
    return {"w": _spec(pkg, "w", (64, 64), [("data",), ()])}


def test_ring_buffer_count_and_byte_budget_eviction():
    plan, rplan = _plans(_square, {"data": 2})
    for kw in ({"max_snapshots": 3}, {"max_snapshots": 10, "max_bytes": 2 * 2 * 3 * 64 * 64 * 4},
               {"max_snapshots": 10, "max_bytes": 1}):
        tier, rtier = H.HotTier(replication=1, **kw), RH.HotTier(replication=1, **kw)
        for step in (1, 2, 3, 4, 5):
            snap = _random_state(plan.param_specs, step)
            tier.capture(snap, plan, step)
            rtier.capture(_to_ref(snap), rplan, step)
        assert [s.step for s in tier.snapshots()] == [s.step for s in rtier.snapshots()]
        assert tier.evictions == rtier.evictions and tier.resident_nbytes == rtier.resident_nbytes
        tier.clear(), rtier.clear()
    tier = H.HotTier(replication=1, max_snapshots=3)
    for step in (1, 2, 3, 4, 5):
        tier.capture(_random_state(plan.param_specs, step), plan, step)
    assert [s.step for s in tier.snapshots()] == [3, 4, 5] and tier.evictions == 2
    tier.clear()


# ---------------------------------------------------------------------------
# Drain (background promotion to disk)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", ["raw", "int8:b256"])
def test_drain_every_nth_snapshot_byte_identical(tmp_path, tag):
    plan, rplan = _plans(_specs_2x2, MESH_2X2)
    codec = CodecPolicy.moments(tag) if tag != "raw" else None
    rcodec = RefCodecPolicy.moments(tag) if tag != "raw" else None
    tier, rtier = H.HotTier(replication=1), RH.HotTier(replication=1)
    drainer, rdrainer = H.HotDrainer(every=2), RH.HotDrainer(every=2)
    states = {}
    for i, step in enumerate((5, 10, 15, 20), start=1):
        states[step] = _random_state(plan.param_specs, seed=step)
        hs, _ = tier.capture(states[step], plan, step)
        rhs, _ = rtier.capture(_to_ref(states[step]), rplan, step)
        root = f"step_{step:08d}"
        assert drainer.maybe_drain(hs, tmp_path / "port" / root, codec=codec) == (i % 2 == 0)
        rdrainer.maybe_drain(rhs, tmp_path / "ref" / root, codec=rcodec)
    assert sorted(r.step for r in drainer.wait()) == [10, 20]
    assert sorted(r.step for r in rdrainer.wait()) == [10, 20]
    drainer.close(), rdrainer.close()
    for step in (10, 20):
        root = tmp_path / "port" / f"step_{step:08d}"
        ck = T.DistCheckpoint.open(root)
        assert ck.is_committed and ck.validate() == []
        write_distributed(states[step], plan, step, tmp_path / f"direct{step}", workers=1,
                          codec=codec)
        got = _tree_bytes(root)
        for other in (tmp_path / f"direct{step}", tmp_path / "ref" / f"step_{step:08d}"):
            want = _tree_bytes(other)
            assert got.keys() == want.keys() and got
            for rel in want:
                assert got[rel] == want[rel], f"step {step} {other.name}: {rel} differs"
        j, rj = ck.manifest.to_json(), R.DistCheckpoint.open(
            tmp_path / "ref" / f"step_{step:08d}").manifest.to_json()
        j.pop("created_at"), rj.pop("created_at")
        assert j == rj
        # and the drained step restores in the reference
        ref_ck = R.DistCheckpoint.open(root)
        assert ref_ck.validate() == []
        restored = _ref_flat(ref_state_from_dist(ref_ck, rplan, _jmesh()))
        assert np.array_equal(restored[("params", "w")], states[step]["w"][T.StateKind.FP32])
    assert not (tmp_path / "port" / "step_00000005" / "COMMIT").exists()
    tier.clear(), rtier.clear()


def test_drain_survives_ring_eviction_of_queued_snapshot(tmp_path):
    plan, _ = _plans(_specs_2x2, MESH_2X2)
    tier = H.HotTier(replication=1)
    snap = _random_state(plan.param_specs, seed=21)
    drainer = H.HotDrainer(every=1)
    hs, _ = tier.capture(snap, plan, 5)
    assert drainer.maybe_drain(hs, tmp_path / "step_00000005")
    hs.release(tier.engine)  # ring eviction before the background write ran
    assert [r.step for r in drainer.wait()] == [5]
    drainer.close()
    ck = T.DistCheckpoint.open(tmp_path / "step_00000005")
    assert ck.is_committed and ck.validate() == []
    write_distributed(snap, plan, 5, tmp_path / "ref", workers=1)
    ref, got = _tree_bytes(tmp_path / "ref"), _tree_bytes(tmp_path / "step_00000005")
    assert got.keys() == ref.keys() and got, "eviction must not empty the drain"
    for rel in ref:
        assert got[rel] == ref[rel], rel
    with pytest.raises(ValueError, match="empty hot snapshot"):
        H.persist_snapshot(hs, tmp_path / "again")
    tier.clear()


def test_post_failure_capture_places_replicas_on_survivors():
    plan, _ = _plans(_specs_2x2, MESH_2X2)
    tier = H.HotTier(replication=1)
    tier.fail_ranks({1})
    hs, _ = tier.capture(_random_state(plan.param_specs), plan, 5)
    for _, _, frag in hs.fragments():
        assert 1 not in frag.holders and len(frag.holders) >= 2, frag
    assert tier.fail_ranks({0}) == {}
    assert hs.is_complete()
    tier.clear()


def _tiny(pkg):
    return {"w": _spec(pkg, "w", (8,), [("data",)])}


def test_drain_refuses_incomplete_snapshot(tmp_path):
    plan, _ = _plans(_tiny, {"data": 2})
    tier = H.HotTier(replication=0)  # no redundancy: any loss is fatal
    hs, _ = tier.capture(_random_state(plan.param_specs), plan, 1)
    tier.fail_ranks({0})
    with pytest.raises(ValueError, match="incomplete hot snapshot"):
        H.persist_snapshot(hs, tmp_path / "ck")
    tier.clear()


# ---------------------------------------------------------------------------
# Integrity
# ---------------------------------------------------------------------------


def test_hot_snapshot_verify_catches_in_memory_rot():
    plan, _ = _plans(_tiny, {"data": 2})
    tier = H.HotTier(replication=1)
    hs, _ = tier.capture(_random_state(plan.param_specs), plan, 1)
    assert hs.verify() == []
    frag = hs._frags[next(iter(hs._frags))]
    frag.data[0] += 1.0  # a replica rotting in host memory
    problems = hs.verify()
    assert problems and "digest" in problems[0]
    with pytest.raises(IntegrityError):
        H.state_from_hot(hs, plan, "cpu", verify=True)
    tier.clear()


@pytest.fixture(scope="module")
def smollm():
    cfg = TC.reduced(TC.get_config("smollm-360m"))
    mesh = T.MeshSpec.from_dict({"data": 1, "model": 1})
    parallel = TC.ParallelismConfig()
    lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh))
    plan = make_plan(cfg, lm.registry, parallel, mesh)
    return plan, init_state(lm.init(torch.Generator().manual_seed(0)))


def test_restore_verify_flag_raises_on_corruption(tmp_path, smollm):
    plan, state = smollm
    mgr = CheckpointManager(tmp_path / "ck", plan, policy=CheckpointPolicy(async_save=False))
    mgr.save(state, 10)
    mgr.restore("cpu", verify=True)  # a clean checkpoint verifies
    victim = next(iter(sorted((tmp_path / "ck").glob("step_*/ranks/**/*.npy"))))
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    mgr.engine.invalidate(mgr.step_dir(10))
    with pytest.raises(IntegrityError):
        mgr.restore("cpu", verify=True)
    mgr.restore("cpu")  # without the flag, corruption passes (documented opt-in)
    mgr.close()


# ---------------------------------------------------------------------------
# Crash mid-drain → hot recovery → GC
# ---------------------------------------------------------------------------


class _CrashAfter:
    """A minimal controller: every ``point`` hit past the ``n``-th raises
    :class:`FaultError` (a crash mid-drain)."""

    def __init__(self, point: str, n: int):
        self.point, self.n, self.hits = point, n, 0

    def on_point(self, name, ctx):
        if name == self.point:
            self.hits += 1
            if self.hits > self.n:
                raise chaos.FaultError(f"injected crash at {name} hit {self.hits}")


def test_crash_mid_save_discovery_hot_recovery_and_gc(tmp_path, smollm):
    plan, state = smollm
    mgr = CheckpointManager(tmp_path / "ck", plan, policy=CheckpointPolicy(
        hot_interval=5, save_interval=5, async_save=False))
    mgr.save(state, 5)  # a committed disk checkpoint via the drain
    mgr.wait()
    assert mgr.latest_step() == 5
    crash = _CrashAfter("drain.shard", 3)
    chaos.activate(crash)
    try:
        mgr.save(state, 10)
        with pytest.raises(RuntimeError, match="drain failed") as err:
            mgr.wait()
    finally:
        chaos.deactivate(crash)
    assert isinstance(err.value.__cause__, chaos.FaultError)
    crashed = mgr.step_dir(10)
    assert crashed.exists() and not (crashed / "COMMIT").exists()
    assert 0 < len(list(crashed.glob("ranks/**/*.npy"))) <= 3  # partial
    assert mgr.latest_step() == 5  # discovery skips the uncommitted step
    opened = []
    real_open = T.DistCheckpoint.open.__func__

    def spy(cls, root):
        opened.append(root)
        return real_open(cls, root)

    T.DistCheckpoint.open = classmethod(spy)
    try:
        restored, info = mgr.restore_latest("cpu", verify=True)
    finally:
        T.DistCheckpoint.open = classmethod(real_open)
    assert info.mode == ResumeMode.HOT_DIRECT and info.step == 10 and opened == []
    for name, t in flatten_with_paths(state.params).items():
        assert torch.equal(flatten_with_paths(restored.params)[name], t), name
    mgr.save(state, 15)
    mgr.wait()
    assert mgr.latest_step() == 15
    assert not crashed.exists(), "GC must remove the crashed partial save"
    mgr.close()
