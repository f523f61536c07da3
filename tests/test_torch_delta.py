"""Delta (incremental) checkpoints in the port, held against the JAX package
(mirrors ``tests/test_delta_ckpt.py`` case by case; the hot-drainer cases
wait for the hot tier, ROADMAP queue 1 item 7):

* a delta step directory holds only the changed shards, the rest are
  flattened manifest references, and ``SaveResult`` counts both;
* a chain of depth 2 and 5 restores bit-equal to a full save of the same
  state under DIRECT, RESHARD_STREAM and VIA_UCP (reduced smollm-360m and
  mamba2-130m, data=2,model=2);
* a crash before COMMIT leaves the chain servable; ``gc()`` keeps every
  base a kept delta references until a rebase frees it, and pins the base
  of an in-flight delta; with no base (or an incompatible one) a delta
  falls back to a full save and says why;
* a coded delta diffs on pre-encode digests, and serial and parallel
  writers give the same chain, byte for byte;
* across packages: a chain the port writes is the reference's, byte for
  byte, and restores in it; the reference's chain restores in the port; a
  port delta on a reference-written base commits and restores in both.
"""

import json
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
from repro.ckpt.saver import write_distributed as ref_write  # noqa: E402
from repro.core.codec import CodecPolicy as RefCodecPolicy  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.restore import state_from_source, state_from_stream  # noqa: E402
from repro_torch.ckpt.saver import snapshot_state, write_distributed  # noqa: E402
from repro_torch.core.codec import CodecPolicy  # noqa: E402
from repro_torch.core.dist_ckpt import DistCheckpoint  # noqa: E402
from repro_torch.core.plan import ResumeMode  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.optimizer import TrainState, init_state  # noqa: E402

MESH = {"data": 2, "model": 2}
KINDS = (("params", T.StateKind.FP32), ("exp_avg", T.StateKind.EXP_AVG),
         ("exp_avg_sq", T.StateKind.EXP_AVG_SQ))


def _plan(arch, mesh_d=MESH, parallel=None):
    cfg = TC.reduced(TC.get_config(arch))
    mesh = T.MeshSpec.from_dict(mesh_d)
    parallel = parallel or TC.ParallelismConfig()
    lm = build_model(cfg, vocab_multiple=TS.vocab_multiple(parallel, mesh))
    return TS.make_plan(cfg, lm.registry, parallel, mesh), lm


def _reshard_plan(arch):
    return _plan(arch, {"data": 1, "model": 1}, TC.ParallelismConfig(zero=1, fsdp=False))[0]


@pytest.fixture()
def setup(tmp_path):
    plan, lm = _plan("smollm-360m")
    state = init_state(lm.init(torch.Generator().manual_seed(0)))
    return tmp_path, plan, state


def _bump(state: TrainState, idx: int) -> TrainState:
    """Change one parameter leaf (a sparse update: everything else is kept)."""
    flat = flatten_with_paths(state.params)
    name = sorted(flat)[idx % len(flat)]
    flat[name] = flat[name] + (1.0 + idx)
    return TrainState(unflatten_from_paths(flat), state.exp_avg, state.exp_avg_sq, state.step)


def _same(a, b) -> None:
    """Leaves bit-equal over the region both shapes hold (runtime padding
    differs between layouts)."""
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert fa.keys() == fb.keys()
    for name, x in fa.items():
        y = fb[name]
        region = tuple(slice(0, min(p, q)) for p, q in zip(x.shape, y.shape))
        assert x.dtype == y.dtype and torch.equal(x[region], y[region]), name


def _params_equal(a: TrainState, b: TrainState) -> None:
    _same(a.params, b.params)


def _mgr(root, plan, **kw):
    kw.setdefault("async_save", False)
    return CheckpointManager(root, plan, policy=CheckpointPolicy(**kw))


def test_delta_save_writes_only_changed_shards(setup):
    tmp, plan, state = setup
    mgr = _mgr(tmp / "ck", plan, save_mode="delta", full_interval=100, keep_last=100)
    mgr.save(state, 10)  # seq 0: forced full rebase
    mgr.save(_bump(state, 0), 20)
    ck = DistCheckpoint.open(mgr.step_dir(20))
    m = ck.manifest
    assert m.save_mode == "delta" and m.base_step == 10
    assert m.shard_sources and set(m.shard_sources.values()) == {10}
    assert m.base_dirs == {"10": "step_00000010"}
    written = {str(p.relative_to(mgr.step_dir(20))) for p in mgr.step_dir(20).rglob("*.npy")}
    assert len(written) == len(m.shard_digests) - len(m.shard_sources)
    assert 0 < len(written) < len(m.shard_digests)
    # the full digest table regardless: the next delta diffs this manifest alone
    assert set(m.shard_digests) == set(DistCheckpoint.open(mgr.step_dir(10)).manifest.shard_digests)
    assert ck.validate() == []  # the chain-resolved check covers inherited shards
    assert ck.referenced_steps() == {10}
    assert ck.chain_roots() == [mgr.step_dir(20), mgr.step_dir(10)]
    key = next(iter(m.shard_sources))
    rank, rest = key.split("/")
    name, kind = rest.split("@")
    assert ck.owner_step(int(rank.split("_")[1]), name, T.StateKind(kind)) == 10


@pytest.mark.parametrize("depth", [2, 5])
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m"])
def test_chain_restore_bit_identical_to_full(tmp_path, arch, depth):
    """Restore from a K-deep chain — DIRECT, RESHARD_STREAM and VIA_UCP —
    matches a full save of the same final state, bit for bit."""
    plan, lm = _plan(arch)
    state = init_state(lm.init(torch.Generator().manual_seed(1)))
    mgr = _mgr(tmp_path / "delta", plan, save_mode="delta", full_interval=100, keep_last=100)
    s = state
    mgr.save(s, 10)
    for i in range(depth):
        s = _bump(s, i)
        mgr.save(s, 20 + 10 * i)
    tip = 20 + 10 * (depth - 1)
    assert DistCheckpoint.open(mgr.step_dir(tip)).manifest.base_step is not None
    full = _mgr(tmp_path / "full", plan)
    full.save(s, tip)

    r_delta, info = mgr.restore("cpu", step=tip)
    r_full, _ = full.restore("cpu", step=tip)
    assert info.mode is ResumeMode.DIRECT
    for field, _ in KINDS:
        _same(getattr(r_delta, field), getattr(r_full, field))
    _params_equal(r_delta, s)

    plan2 = _reshard_plan(arch)
    m2, f2 = _mgr(tmp_path / "delta", plan2), _mgr(tmp_path / "full", plan2)
    r_delta2, info2 = m2.restore("cpu", step=tip)
    r_full2, _ = f2.restore("cpu", step=tip)
    assert info2.mode is ResumeMode.RESHARD_STREAM
    for field, _ in KINDS:
        _same(getattr(r_delta2, field), getattr(r_full2, field))
    _params_equal(r_delta2, s)
    assert DistCheckpoint.open(mgr.step_dir(tip)).validate() == []
    # the UCP export consolidates through the chain too
    r_ucp, info_ucp = m2.restore("cpu", step=tip, force_mode=ResumeMode.VIA_UCP)
    assert info_ucp.mode is ResumeMode.VIA_UCP
    _params_equal(r_ucp, s)


def test_crash_mid_delta_leaves_chain_servable(setup):
    tmp, plan, state = setup
    mgr = _mgr(tmp / "ck", plan, save_mode="delta", full_interval=100, keep_last=100)
    mgr.save(state, 10)
    state2 = _bump(state, 0)
    mgr.save(state2, 20)
    # a crash mid-delta for step 30: a delta-shaped manifest referencing the
    # chain, shards missing, no COMMIT
    crashed = mgr.step_dir(30)
    m = DistCheckpoint.open(mgr.step_dir(20)).manifest.to_json()
    m["step"], m["base_step"] = 30, 20
    crashed.mkdir(parents=True)
    (crashed / "MANIFEST.json").write_text(json.dumps(m))
    assert mgr.latest_step() == 20  # discovery skips it
    restored, info = mgr.restore("cpu")
    assert info.step == 20
    _params_equal(restored, state2)
    state3 = _bump(state2, 1)
    mgr.save(state3, 40)  # GC removes the wreckage, the chain stays intact
    assert not crashed.exists()
    restored3, _ = mgr.restore("cpu", step=40)
    _params_equal(restored3, state3)


def test_gc_keeps_referenced_bases_until_rebase(setup):
    tmp, plan, state = setup
    mgr = _mgr(tmp / "ck", plan, save_mode="delta", full_interval=100, keep_last=1)
    s = state
    mgr.save(s, 10)  # the full base
    for i, step in enumerate((20, 30)):
        s = _bump(s, i)
        mgr.save(s, step)
    # keep_last=1 keeps step 30 alone, but 30's chain references 10
    refs = DistCheckpoint.open(mgr.step_dir(30)).referenced_steps()
    assert 10 in refs
    for r in refs:
        assert mgr.step_dir(r).exists(), f"GC removed live base step {r}"
    restored, _ = mgr.restore("cpu", step=30)
    _params_equal(restored, s)
    # a rebase (a forced full save) makes the old chain collectable
    s = _bump(s, 2)
    mgr._disk_save_seq = 0  # the next save hits the full_interval boundary
    mgr.save(s, 40)
    assert DistCheckpoint.open(mgr.step_dir(40)).manifest.base_step is None
    assert mgr.steps() == [40]
    assert not mgr.step_dir(10).exists() and not mgr.step_dir(30).exists()
    restored4, _ = mgr.restore("cpu")
    _params_equal(restored4, s)


def test_gc_pins_inflight_delta_base(setup, monkeypatch):
    """gc() must not collect a base that an in-flight delta resolved but has
    not committed against yet, even when newer commits push the base out of
    the keep-last window."""
    import repro_torch.ckpt.saver as saver_mod

    tmp, plan, state = setup
    real = saver_mod.write_distributed
    started, gate = threading.Event(), threading.Event()

    def stalled(snap, plan_, step, root, **kw):
        if step == 30:
            # resolve the base (registering the pin) as the real writer
            # would, then stall before any bytes land
            kw["base"] = kw["base"]()
            started.set()
            assert gate.wait(20), "test gate never opened"
        return real(snap, plan_, step, root, **kw)

    monkeypatch.setattr(saver_mod, "write_distributed", stalled)
    mgr = _mgr(tmp / "ck", plan, async_save=True, save_mode="delta", full_interval=2,
               keep_last=1)
    mgr.save(state, 10, block=True)  # seq 0: full (the future delta base)
    state2 = _bump(state, 0)
    mgr.save(state2, 30)  # seq 1: a delta, queued, stalls after resolving
    assert started.wait(20)
    # seq 2: a full rebase commits and gc() runs with keep={40}; without the
    # pin, step 10 would be neither kept, in flight nor referenced
    mgr.save(state2, 40, block=True)
    assert mgr.step_dir(10).exists(), "gc collected an in-flight delta's base"
    gate.set()
    mgr._async.wait()  # drain without re-running gc
    assert sorted(mgr.steps()) == [10, 30, 40]
    restored, _ = mgr.restore("cpu", step=30)
    _params_equal(restored, state2)
    mgr.gc()  # the pin died with the save: the dead chain goes
    assert mgr.steps() == [40]
    assert not mgr.step_dir(10).exists()
    mgr.close()


def test_delta_falls_back_to_full_without_base(setup):
    tmp, plan, state = setup
    snap = snapshot_state(state)
    res = write_distributed(snap, plan, 1, tmp / "a" / "step_1", save_mode="delta")
    assert res.mode == "full" and res.fallback_reason == "no committed base checkpoint"
    m = DistCheckpoint.open(tmp / "a" / "step_1").manifest
    assert m.save_mode == "dedup" and m.base_step is None
    # an incompatible base: another mesh geometry
    plan2, _ = _plan("smollm-360m", {"data": 1, "model": 1})
    write_distributed(snapshot_state(state), plan2, 2, tmp / "a" / "step_2")
    base = DistCheckpoint.open(tmp / "a" / "step_2")
    res3 = write_distributed(snap, plan, 3, tmp / "a" / "step_3", save_mode="delta", base=base)
    assert res3.mode == "full" and "mesh changed" in res3.fallback_reason
    # a base that is not a sibling directory
    write_distributed(snap, plan, 5, tmp / "b" / "step_5")
    res5 = write_distributed(snap, plan, 6, tmp / "a" / "step_6", save_mode="delta",
                             base=DistCheckpoint.open(tmp / "b" / "step_5"))
    assert res5.mode == "full" and "not a sibling" in res5.fallback_reason
    # a compatible base: a real delta with zero changed shards writes nothing
    base1 = DistCheckpoint.open(tmp / "a" / "step_1")
    res4 = write_distributed(snap, plan, 4, tmp / "a" / "step_4", save_mode="delta", base=base1)
    assert res4.mode == "delta" and res4.shards_written == 0 and res4.bytes_written == 0
    assert not list((tmp / "a" / "step_4").rglob("*.npy"))
    assert DistCheckpoint.open(tmp / "a" / "step_4").validate() == []


def test_validate_reports_malformed_digest_as_problem(setup):
    tmp, plan, state = setup
    write_distributed(snapshot_state(state), plan, 1, tmp / "ck" / "step_1")
    ck = DistCheckpoint.open(tmp / "ck" / "step_1")
    key = next(iter(ck.manifest.shard_digests))
    ck.manifest.shard_digests[key] = "bogus-algo:deadbeef"
    assert any("unrecognized recorded digest" in p for p in ck.validate())


def test_save_result_reports_delta_counts(setup):
    tmp, plan, state = setup
    root = tmp / "ck"
    write_distributed(snapshot_state(state), plan, 1, root / "step_00000001")
    base = DistCheckpoint.open(root / "step_00000001")
    res = write_distributed(snapshot_state(_bump(state, 0)), plan, 2, root / "step_00000002",
                            save_mode="delta", base=base)
    assert res.mode == "delta" and res.fallback_reason == ""
    assert res.shards_written > 0
    assert res.shards_inherited > res.shards_written  # a sparse update
    assert res.shards_written + res.shards_inherited == len(base.manifest.shard_digests)
    assert res.bytes_written < base.total_bytes()


# ---------------------------------------------------------------------------
# Coded deltas, serial vs parallel, and across packages
# ---------------------------------------------------------------------------


def _snap(plan, seed):
    rng = np.random.default_rng(seed)
    return {n: {k: rng.standard_normal(s.runtime_shape).astype(np.float32) for k in T.STATE_KINDS}
            for n, s in plan.param_specs.items()}


def _changed(snap, name, kinds, by=1.0):
    return {n: {k: a + np.float32(by) if n == name and k in kinds else a for k, a in ks.items()}
            for n, ks in snap.items()}


def _to_ref(snap):
    return {n: {R.StateKind(k.value): a for k, a in ks.items()} for n, ks in snap.items()}


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.glob("ranks/**/*.npy"))}


def _manifest(root):
    j = json.loads((root / "MANIFEST.json").read_text())
    j.pop("created_at")
    return j


def _ref_plan(arch, mesh_d=MESH):
    cfg = RC.reduced(RC.get_config(arch))
    mesh = R.MeshSpec.from_dict(mesh_d)
    parallel = RC.ParallelismConfig()
    lm = ref_build(cfg, vocab_multiple=RS.vocab_multiple(parallel, mesh))
    return RS.make_plan(cfg, lm.registry, parallel, mesh)


def _logical_equal(atom, want, spec) -> None:
    region = tuple(slice(0, s) for s in spec.logical_shape)
    got = atom.numpy() if isinstance(atom, torch.Tensor) else np.asarray(atom)
    np.testing.assert_array_equal(got[region], want[region])


def test_coded_delta_diffs_on_pre_encode_digests(tmp_path):
    """With int8-coded moments the served digest differs from the raw one;
    the diff runs on the pre-encode table, so an unchanged coded shard is
    inherited (with its codec tag) and a changed one rewritten."""
    plan, _ = _plan("smollm-360m")
    codec = CodecPolicy.moments("int8:b256")
    snap = _snap(plan, 0)
    root = tmp_path / "ck"
    write_distributed(snap, plan, 1, root / "step_00000001", codec=codec)
    base = DistCheckpoint.open(root / "step_00000001")
    assert base.manifest.shard_pre_digests  # lossy: served != pre
    res = write_distributed(snap, plan, 2, root / "step_00000002", codec=codec,
                            save_mode="delta", base=base)
    assert (res.mode, res.shards_written, res.coded_bytes) == ("delta", 0, 0)
    m2 = DistCheckpoint.open(root / "step_00000002").manifest
    assert m2.shard_codecs == base.manifest.shard_codecs
    assert m2.shard_pre_digests == base.manifest.shard_pre_digests
    snap3 = _changed(snap, "final_norm", (T.StateKind.EXP_AVG,))
    res3 = write_distributed(snap3, plan, 3, root / "step_00000003", codec=codec,
                             save_mode="delta", base=DistCheckpoint.open(root / "step_00000002"))
    m3 = DistCheckpoint.open(root / "step_00000003").manifest
    own = set(m3.shard_digests) - set(m3.shard_sources)
    assert own and all(k.endswith("final_norm@exp_avg") for k in own)
    assert res3.shards_written == len(own) and res3.coded_raw_bytes > 0
    assert set(m3.shard_sources.values()) == {1}  # flattened through step 2
    ck3 = DistCheckpoint.open(root / "step_00000003")
    assert ck3.validate() == []
    for kind, coded in ((T.StateKind.FP32, False), (T.StateKind.EXP_AVG, True)):
        for name, spec in plan.param_specs.items():
            atom = T.assemble_atom(ck3, spec, kind)
            if not coded:
                _logical_equal(atom, snap3[name][kind], spec)
            else:  # the served view: within one int8 step of each block's scale
                want = snap3[name][kind][tuple(slice(0, s) for s in spec.logical_shape)]
                assert np.abs(np.asarray(atom) - want).max() <= np.abs(want).max() / 127 + 1e-6


@pytest.mark.parametrize("codec", [None, "int8:b256"])
@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-130m"])
def test_delta_chain_byte_identical_serial_parallel_and_reference(tmp_path, arch, codec):
    """A full save and two deltas, written by the port's serial and 4-wide
    writers and by the reference's: the same files, digests, provenance and
    manifests in every directory of the chain; the reference restores the
    port's chain, validates it and converts it."""
    plan, rplan = _plan(arch)[0], _ref_plan(arch)
    name = sorted(plan.param_specs)[0]
    snaps = [_snap(plan, 3)]
    snaps.append(_changed(snaps[0], name, (T.StateKind.FP32,)))
    snaps.append(_changed(snaps[1], "final_norm", tuple(T.STATE_KINDS), by=2.0))
    tcodec = CodecPolicy.moments(codec) if codec else None
    rcodec = RefCodecPolicy.moments(codec) if codec else None
    chains = {}
    for label, w in (("ser", 1), ("par", 4), ("ref", None)):
        root = tmp_path / label
        for i, snap in enumerate(snaps):
            step_root = root / f"step_{i + 1:08d}"
            if label == "ref":
                base = R.DistCheckpoint.open(root / f"step_{i:08d}") if i else None
                r = ref_write(_to_ref(snap), rplan, i + 1, step_root, workers=4, codec=rcodec,
                              save_mode="delta" if i else "dedup", base=base)
            else:
                base = DistCheckpoint.open(root / f"step_{i:08d}") if i else None
                r = write_distributed(snap, plan, i + 1, step_root, workers=w, codec=tcodec,
                                      save_mode="delta" if i else "dedup", base=base)
            assert r.mode == ("delta" if i else "full")
            if i:
                assert 0 < r.shards_written < r.shards_inherited
        chains[label] = root
    for i in range(1, 4):
        d = f"step_{i:08d}"
        want_files, want_manifest = _files(chains["ref"] / d), _manifest(chains["ref"] / d)
        for label in ("ser", "par"):
            assert _files(chains[label] / d) == want_files, (label, d)
            assert _manifest(chains[label] / d) == want_manifest, (label, d)
    tip = R.DistCheckpoint.open(chains["par"] / "step_00000003")
    assert tip.manifest.base_step == 2 and tip.validate() == []
    assert tip.referenced_steps() == {1, 2}
    for name_, spec in tip.manifest.params.items():
        _logical_equal(R.assemble_atom(tip, spec, R.StateKind.FP32),
                       snaps[2][name_][T.StateKind.FP32], spec)
    ucp, _ = R.convert_to_ucp(tip, str(tmp_path / "ref.ucp"), workers=2)
    assert ucp.validate() == []


def test_reference_chain_restores_in_port(tmp_path):
    """The reference writes a full step and a delta; the port restores the
    tip DIRECT, RESHARD_STREAM and VIA_UCP, bit-equal to the snapshot."""
    plan, rplan = _plan("smollm-360m")[0], _ref_plan("smollm-360m")
    snaps = [_snap(plan, 4)]
    snaps.append(_changed(snaps[0], "final_norm", tuple(T.STATE_KINDS)))
    root = tmp_path / "ck"
    ref_write(_to_ref(snaps[0]), rplan, 1, root / "step_00000001", workers=1)
    r = ref_write(_to_ref(snaps[1]), rplan, 2, root / "step_00000002", workers=4,
                  save_mode="delta", base=R.DistCheckpoint.open(root / "step_00000001"))
    assert r.mode == "delta" and r.shards_inherited > 0
    ck = DistCheckpoint.open(root / "step_00000002")
    assert ck.validate() == [] and ck.referenced_steps() == {1}
    direct = state_from_source(ck, plan, "cpu")
    plan2 = _reshard_plan("smollm-360m")
    rp = T.plan_resume(ck.manifest, T.TargetSpec(plan2.mesh, plan2.param_specs))
    stream = state_from_stream(ck, plan2, "cpu", rp.transforms)
    via = _mgr(root, plan2).restore("cpu", force_mode=ResumeMode.VIA_UCP)[0]
    for state in (direct, stream, via):
        for field, kind in KINDS:
            got = flatten_with_paths(getattr(state, field))
            for name, spec in plan.param_specs.items():
                _logical_equal(got[name], snaps[1][name][kind], spec)


def test_port_delta_on_reference_base_restores_in_both(tmp_path):
    """A port delta against a base the reference wrote commits, and both
    packages restore its tip bit-equal to the snapshot."""
    plan, rplan = _plan("smollm-360m")[0], _ref_plan("smollm-360m")
    snaps = [_snap(plan, 6)]
    snaps.append(_changed(snaps[0], "final_norm", (T.StateKind.FP32,)))
    root = tmp_path / "ck"
    ref_write(_to_ref(snaps[0]), rplan, 1, root / "step_00000001", workers=4)
    res = write_distributed(snaps[1], plan, 2, root / "step_00000002", workers=4,
                            save_mode="delta", base=DistCheckpoint.open(root / "step_00000001"))
    assert res.mode == "delta" and res.shards_written > 0 and res.shards_inherited > 0
    rck = R.DistCheckpoint.open(root / "step_00000002")
    assert rck.is_committed and rck.validate() == [] and rck.manifest.base_step == 1
    direct = _mgr(root, plan).restore("cpu")[0]
    for name, spec in rck.manifest.params.items():
        for kind in R.STATE_KINDS:
            want = snaps[1][name][T.StateKind(kind.value)]
            _logical_equal(R.assemble_atom(rck, spec, kind), want, spec)
        _logical_equal(flatten_with_paths(direct.params)[name], snaps[1][name][T.StateKind.FP32],
                       plan.param_specs[name])
