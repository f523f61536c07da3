"""The port's checkpoint fan-out (``repro_torch.serve``), held against the
JAX package (``tests/test_fanout.py`` case by case, the same inputs drawn
from a seed with numpy):

* the binomial tree and the refusal to publish an uncommitted or
  undigested checkpoint;
* the announcement diff and the peer store's GC: one sequence of
  checkpoints gives the reference's ``Publication.changed`` sets;
* a fleet of 8 restores bit-equal to ``state_from_source`` with each fp32
  shard read from disk once fleet-wide; at ``io_workers=1`` in a fixed
  order every replica's ``FanoutStats`` equal the reference's;
* the serving hot set (each region, and each consolidated atom, assembled
  once per fleet), shared regions kept out of the arena's reuse, and the
  fleet's built weights weighed against the engine's byte bound;
* a corrupt peer (evicted, fetched again) and a corrupt file on disk
  (``IntegrityError``); an in-place delta and a feed with a gap;
* the manager publishing on commit, and a crash mid-publish through the
  port's ``ChaosController``; 12 concurrent readers on one engine;
* across packages: the reference's ``write_distributed`` of a reduced
  smollm-360m under data=2,model=2, published by each package to a fleet
  of 3 under data=1,model=1, gives bit-equal weights and, served
  unsharded, the same greedy tokens with fp32 logits within 1e-4 (the
  tolerance of ``tests/test_torch_serve.py``); a coded checkpoint
  reshards and serves the fan-out as in ``tests/test_codec.py``.
"""

import dataclasses
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
import repro.hot as RH  # noqa: E402
import repro.serve as RSV  # noqa: E402
from repro.ckpt.restore import state_from_dist as ref_state_from_dist  # noqa: E402
from repro.ckpt.saver import write_distributed as ref_write  # noqa: E402
from repro.core.engine import CheckpointEngine as RefEngine  # noqa: E402
from repro.core.pytree import flatten_with_paths as ref_flatten  # noqa: E402
from repro.core.pytree import unflatten_from_paths as ref_unflatten  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import decode as RD  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.chaos import ChaosController, FaultError, FaultSpec, Schedule  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.restore import (  # noqa: E402
    build_param_arrays,
    params_from_source,
    read_region_from_source,
    state_from_source,
)
from repro_torch.ckpt.saver import write_distributed  # noqa: E402
from repro_torch.core.codec import CodecPolicy  # noqa: E402
from repro_torch.core.engine import CheckpointEngine, HandleCache  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths  # noqa: E402
from repro_torch.core.tensor_io import IntegrityError, digest_matches  # noqa: E402
from repro_torch.hot import binomial_parent, fanout_ladder  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.serve import FleetReplica, PeerFragmentSource, PublicationRegistry  # noqa: E402
from repro_torch.train.optimizer import TrainState  # noqa: E402

MESH_2X2 = {"data": 2, "model": 2}
MESH_1X1 = {"data": 1, "model": 1}


def _spec(pkg, name, shape, dims, **kw):
    return pkg.uniform_param_spec(name, shape, [pkg.DimSpec(tuple(d)) for d in dims], **kw)


def _specs(pkg):
    return {
        "w": _spec(pkg, "w", (8, 6), [("data",), ("model",)]),
        "u": _spec(pkg, "u", (6, 4), [("model",), ()]),
        "b": _spec(pkg, "b", (4,), [()]),  # fully replicated
    }


def _plan(pkg, specs, mesh_d):
    sharding = TS if pkg is T else RS
    return sharding.ShardingPlan(mesh=pkg.MeshSpec.from_dict(mesh_d), param_specs=specs)


def _random_state(specs, seed=0):
    rng = np.random.default_rng(seed)
    return {
        n: {k: rng.normal(size=s.runtime_shape).astype(np.float32) for k in T.STATE_KINDS}
        for n, s in specs.items()
    }


def _to_ref(snap):
    return {n: {R.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snap.items()}


def _copy(snap):
    return {n: {k: v.copy() for k, v in kv.items()} for n, kv in snap.items()}


def _serial():
    return CheckpointEngine(workers=1)


def _same_params(got: dict, want: dict):
    assert got.keys() == want.keys() and got
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)


def _ref_params(ckpt_dir, tgt_specs):
    """The JAX package's params of a 1x1 restore of ``ckpt_dir``, flat."""
    st = ref_state_from_dist(R.DistCheckpoint.open(ckpt_dir), _plan(R, tgt_specs, MESH_1X1),
                             _jmesh(), engine=RefEngine(workers=1))
    return {n: np.asarray(a) for n, a in ref_flatten(jax.device_get(st.params)).items()}


_JMESH = []


def _jmesh():
    if not _JMESH:
        _JMESH.append(jax.make_mesh((1, 1), ("data", "model")))
    return _JMESH[0]


@pytest.fixture()
def published(tmp_path):
    """One committed 2x2 checkpoint, published; plus a 1x1 target plan."""
    specs = _specs(T)
    plan = _plan(T, specs, MESH_2X2)
    snap = _random_state(specs)
    write_distributed(snap, plan, 1, tmp_path / "step_1")
    ckpt = T.DistCheckpoint.open(tmp_path / "step_1")
    registry = PublicationRegistry()
    pub = registry.publish(ckpt)
    return tmp_path, plan, snap, ckpt, registry, pub, _plan(T, specs, MESH_1X1)


def _direct(ckpt, tgt_plan):
    return flatten_with_paths(state_from_source(ckpt, tgt_plan, "cpu", engine=_serial()).params)


# ---------------------------------------------------------------------------
# Binomial fan-out tree
# ---------------------------------------------------------------------------


def test_binomial_tree_shape():
    assert binomial_parent(0) is None
    assert binomial_parent(1) == 0
    assert binomial_parent(6) == 2
    assert fanout_ladder(0) == []
    assert fanout_ladder(11) == [3, 1, 0]
    for p in range(1, 200):
        ladder = fanout_ladder(p)
        assert ladder[0] == binomial_parent(p)
        assert ladder[-1] == 0
        assert all(a > b for a, b in zip(ladder, ladder[1:]))
        assert len(ladder) == bin(p).count("1")
        assert ladder == RH.fanout_ladder(p) and binomial_parent(p) == RH.binomial_parent(p)
    children: dict[int, int] = {}
    for p in range(1, 256):
        children[binomial_parent(p)] = children.get(binomial_parent(p), 0) + 1
    assert max(children.values()) <= 8  # log2(256)
    with pytest.raises(ValueError):
        binomial_parent(-1)


# ---------------------------------------------------------------------------
# Registry: publish / subscribe / store GC
# ---------------------------------------------------------------------------


def test_registry_refuses_unsafe_publishes(tmp_path):
    specs = _specs(T)
    write_distributed(_random_state(specs), _plan(T, specs, MESH_2X2), 1, tmp_path / "step_1")
    ckpt = T.DistCheckpoint.open(tmp_path / "step_1")
    registry = PublicationRegistry()
    ckpt.commit_path.unlink()
    with pytest.raises(ValueError, match="uncommitted"):
        registry.publish(ckpt)
    ckpt.commit()
    ckpt.manifest.shard_digests.clear()
    with pytest.raises(ValueError, match="digest"):
        registry.publish(ckpt)
    assert registry.current() is None


def test_publish_diff_and_store_gc(published):
    tmp, plan, snap, ckpt, registry, pub, tgt_plan = published
    assert pub.kind == "full" and pub.seq == 1
    assert pub.changed == frozenset(pub.digests)
    sub = registry.subscribe("late")
    assert [p.seq for p in sub.poll()] == [1]
    snap2 = _copy(snap)
    snap2["u"][T.StateKind.FP32] += 1.0
    write_distributed(snap2, plan, 2, tmp / "step_2")
    pub2 = registry.publish(T.DistCheckpoint.open(tmp / "step_2"))
    assert pub2.kind == "delta"
    assert pub2.changed_params == frozenset({"u"})
    assert all("/u@" in k for k in pub2.changed)
    r = FleetReplica("r0", registry, tgt_plan, "cpu", engine=_serial())
    assert r.sync()  # drains both pubs: a full rebuild at pub2
    assert r.seq == 2 and r.step == 2
    before = registry.stored_nbytes
    snap3 = _copy(snap2)
    snap3["u"][T.StateKind.FP32] += 1.0
    write_distributed(snap3, plan, 3, tmp / "step_3")
    registry.publish(T.DistCheckpoint.open(tmp / "step_3"))
    assert registry.store_evictions > 0
    assert registry.stored_nbytes <= before  # the old "u" content dropped


def test_publication_diffs_equal_the_reference(tmp_path):
    """One sequence of checkpoints (full saves and deltas, each package
    writing its own) announces the reference's changed sets, kinds and
    store evictions."""
    specs, rspecs = _specs(T), _specs(R)
    plan, rplan = _plan(T, specs, MESH_2X2), _plan(R, rspecs, MESH_2X2)
    snap = _random_state(specs, seed=3)
    registry, rregistry = PublicationRegistry(), RSV.PublicationRegistry()
    edits = [None, ("u", "fp32"), ("w", "exp_avg"), ("b", "fp32"), None]
    base = rbase = None
    for step, edit in enumerate(edits, start=1):
        if edit is not None:
            snap[edit[0]][T.StateKind(edit[1])] += 1.0
        mode = "delta" if step % 2 == 0 else "dedup"
        write_distributed(snap, plan, step, tmp_path / f"t{step}", save_mode=mode,
                          base=base if mode == "delta" else None)
        ref_write(_to_ref(snap), rplan, step, tmp_path / f"r{step}", save_mode=mode,
                  base=rbase if mode == "delta" else None)
        base, rbase = T.DistCheckpoint.open(tmp_path / f"t{step}"), R.DistCheckpoint.open(
            tmp_path / f"r{step}")
        pub, rpub = registry.publish(base), rregistry.publish(rbase)
        FleetReplica(f"p{step}", registry, _plan(T, specs, MESH_1X1), "cpu",
                     engine=_serial()).sync()
        RSV.FleetReplica(f"p{step}", rregistry, _plan(R, rspecs, MESH_1X1), _jmesh(),
                         engine=RefEngine(workers=1)).sync()
        assert (pub.seq, pub.step, pub.kind) == (rpub.seq, rpub.step, rpub.kind)
        assert pub.digests == rpub.digests
        assert pub.changed == rpub.changed and pub.changed_params == rpub.changed_params
        assert registry.store_evictions == rregistry.store_evictions
        assert registry.stored_nbytes == rregistry.stored_nbytes


# ---------------------------------------------------------------------------
# Fleet restore: bit-identity + O(1) disk traffic
# ---------------------------------------------------------------------------


def test_fleet_restore_bit_identical_and_o1_disk(published):
    """8 resharding readers with *private* engines (the peer tier does the
    distribution): each fp32 shard is read from disk once fleet-wide, the
    rest comes from peers, every replica is bit-equal to a direct restore,
    and each replica's tallies are the reference's (io_workers=1, synced in
    order)."""
    tmp, plan, snap, ckpt, registry, pub, tgt_plan = published
    reps = [FleetReplica(f"r{i}", registry, tgt_plan, "cpu", engine=_serial())
            for i in range(8)]
    for r in reps:
        assert r.sync()
    fp32_shards = [k for k in pub.digests if k.endswith("@fp32")]
    assert sum(r.stats.disk_fetches for r in reps) == len(fp32_shards)
    assert sum(r.stats.peer_fetches for r in reps) > 0
    assert sum(r.stats.digest_failures for r in reps) == 0
    want = _direct(ckpt, tgt_plan)
    for r in reps:
        _same_params(r.flat_params(), want)
    for key in fp32_shards:
        assert len(registry.holders(f"{key}@{pub.digests[key]}")) == len(reps)
    # the reference's fleet over the same files, in the same order
    rregistry = RSV.PublicationRegistry()
    rregistry.publish(R.DistCheckpoint.open(tmp / "step_1"))
    rtgt = _plan(R, _specs(R), MESH_1X1)
    rreps = [RSV.FleetReplica(f"r{i}", rregistry, rtgt, _jmesh(), engine=RefEngine(workers=1))
             for i in range(8)]
    for rr, r in zip(rreps, reps):
        assert rr.sync()
        assert dataclasses.asdict(rr.stats) == r.stats.as_dict(), r.name
        _same_params(r.flat_params(), {n: np.asarray(a) for n, a in rr.flat_params().items()})
    for key in fp32_shards:
        skey = f"{key}@{pub.digests[key]}"
        assert registry.holders(skey) == rregistry.holders(skey)


def _sync_all(reps):
    errs: list[BaseException] = []

    def sync_one(r):
        try:
            assert r.sync()
        except BaseException as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=sync_one, args=(r,)) for r in reps]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs


def test_fleet_shared_engine_serving_hot_set(published):
    """Replica threads sharing one engine pool their region reads and their
    built tensors: each shard leaves disk once and no reader assembles
    another's region; every replica holds the same tensors."""
    tmp, plan, snap, ckpt, registry, pub, tgt_plan = published
    engine = CheckpointEngine(workers=2)
    reps = [FleetReplica(f"s{i}", registry, tgt_plan, "cpu", engine=engine) for i in range(6)]
    _sync_all(reps)
    fp32_shards = [k for k in pub.digests if k.endswith("@fp32")]
    total = sum(r.stats.disk_fetches + r.stats.peer_fetches for r in reps)
    assert sum(r.stats.disk_fetches for r in reps) == len(fp32_shards)
    assert total <= len(fp32_shards)  # regions built once, period
    want = _direct(ckpt, tgt_plan)
    for r in reps:
        _same_params(r.flat_params(), want)
        assert all(r.flat_params()[n] is reps[0].flat_params()[n] for n in want)


def test_fanout_consolidation_assembled_once_per_fleet(tmp_path):
    """A fused param under a TP change takes the CONSOLIDATE stream path;
    the publication-keyed atom cache assembles it once per fleet, and the
    result is the reference's."""
    def specs_of(pkg):
        fused = pkg.uniform_param_spec(
            "qkv", (8, 4),
            [pkg.DimSpec(("model",), (pkg.SubFragment("q", 4), pkg.SubFragment("k", 4))),
             pkg.DimSpec()],
            kind="fused_qkv",
        )
        return {"qkv": fused, "b": _spec(pkg, "b", (4,), [()])}

    specs = specs_of(T)
    snap = _random_state(specs)
    write_distributed(snap, _plan(T, specs, MESH_2X2), 1, tmp_path / "step_1")
    ckpt = T.DistCheckpoint.open(tmp_path / "step_1")
    registry = PublicationRegistry()
    registry.publish(ckpt)
    tgt_plan = _plan(T, specs, MESH_1X1)
    engine = CheckpointEngine(workers=2)
    reps = [FleetReplica(f"c{i}", registry, tgt_plan, "cpu", engine=engine) for i in range(4)]
    for r in reps:
        assert r.sync()
    for r in reps:
        _same_params(r.flat_params(), _direct(ckpt, tgt_plan))
        _same_params(r.flat_params(), _ref_params(tmp_path / "step_1", specs_of(R)))
    atom_keys = [k for k in engine.atoms._entries if "::atom::qkv@fp32" in k]
    assert len(atom_keys) == 1


def test_shared_regions_stay_out_of_arena_reuse(published):
    """4 readers on one engine at workers=4, twice, with a state restore
    through the same arena between: every region served from the shared
    cache stays intact, so each result is bit-equal to a serial restore."""
    tmp, plan, snap, ckpt, registry, pub, tgt_plan = published
    engine = CheckpointEngine(workers=4)
    want = _direct(ckpt, tgt_plan)
    results: list = []
    lock = threading.Lock()

    def reader(i, rnd):
        src = PeerFragmentSource(registry, pub, f"a{rnd}{i}")
        flat = build_param_arrays(src, tgt_plan, "cpu", engine=engine)
        with lock:
            results.append(flat)

    for rnd in range(2):
        threads = [threading.Thread(target=reader, args=(i, rnd)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        # unshared staging through the same arena, between the rounds
        state_from_source(ckpt, tgt_plan, "cpu", engine=engine)
    assert len(results) == 8
    for flat in results:
        _same_params(flat, want)
    regions = [v for k, v in engine.atoms._entries.items() if "::region::" in k]
    assert regions and all(isinstance(v, np.ndarray) for v in regions)


def test_fleet_memo_weighs_its_tensors(published):
    """The fleet's built weights count against the engine's byte bound (a
    mapping of tensors weighs the sum of its values), and a replica that
    moves on drops what the engine kept of the publication it left: after
    3 more publications the engine holds the newest one's entries alone."""
    tmp, plan, snap, ckpt, registry, pub, tgt_plan = published
    t = {"a": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.float64)}
    assert HandleCache._weight(t) == 3 * 4 * 4 + 5 * 8
    engine = CheckpointEngine(workers=1)
    full = sum(a.numel() * 4 for a in _direct(ckpt, tgt_plan).values())
    engine.atoms.max_bytes = full  # room for one set, nothing beside it
    reps = [FleetReplica(f"m{i}", registry, tgt_plan, "cpu", engine=engine) for i in range(2)]
    for step in (2, 3, 4):
        assert all(r.sync() for r in reps)
        assert [k for k in engine.atoms._entries if "::fleet::" in k] == [
            k for k in engine.atoms._entries if k.startswith(f"pub://{registry.uid}/seq{step - 1}::")
            and "::fleet::" in k]
        assert engine.atoms._bytes <= full
        snap = _copy(snap)
        for kinds in snap.values():
            kinds[T.StateKind.FP32] += 1.0
        write_distributed(snap, plan, step, tmp / f"step_{step}")
        registry.publish(T.DistCheckpoint.open(tmp / f"step_{step}"))
    assert all(r.sync() and r.last_update == frozenset(snap) for r in reps)
    assert all(k.startswith(f"pub://{registry.uid}/seq4::") for k in engine.atoms._entries)
    assert len([k for k in engine.atoms._entries if "::fleet::" in k]) == 1
    want = _direct(T.DistCheckpoint.open(tmp / "step_4"), tgt_plan)
    for r in reps:
        _same_params(r.flat_params(), want)
    # a second set over the bound evicts the first, though its weights live on
    other = _plan(T, {n: _spec(T, n, s.logical_shape, [()] * len(s.logical_shape))
                      for n, s in _specs(T).items()}, MESH_1X1)
    FleetReplica("x", registry, other, "cpu", engine=engine).sync()
    assert len([k for k in engine.atoms._entries if "::fleet::" in k]) == 1
    _same_params(reps[0].flat_params(), want)


# ---------------------------------------------------------------------------
# Integrity: corrupt peer → evict + transparent refetch; corrupt disk → loud
# ---------------------------------------------------------------------------


def test_corrupt_peer_detected_evicted_and_refetched(published):
    tmp, plan, snap, ckpt, registry, pub, tgt_plan = published
    first = FleetReplica("first", registry, tgt_plan, "cpu", engine=_serial())
    assert first.sync()
    key = next(k for k in pub.digests if "/w@fp32" in k)
    skey = f"{key}@{pub.digests[key]}"
    assert registry.holders(skey) == ["first"]
    registry.poison_holder("first", skey)
    victim = FleetReplica("victim", registry, tgt_plan, "cpu", engine=_serial())
    assert victim.sync()
    assert victim.stats.digest_failures >= 1
    assert victim.stats.refetches >= 1
    assert "first" not in registry.holders(skey)
    assert "victim" in registry.holders(skey)
    _same_params(victim.flat_params(), _direct(ckpt, tgt_plan))


def test_corrupt_disk_raises_integrity_error(published):
    tmp, plan, snap, ckpt, registry, pub, tgt_plan = published
    key = next(k for k in pub.digests if "/w@fp32" in k)
    rank = int(key.split("/")[0].split("_")[1])
    path = ckpt.shard_path(rank, "w", T.StateKind.FP32)
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    lone = FleetReplica("lone", registry, tgt_plan, "cpu", engine=_serial())
    with pytest.raises(IntegrityError, match="disk copy"):
        lone.sync()


def test_bf16_weights_fan_out_and_a_corrupt_bf16_peer_is_caught(tmp_path):
    """A checkpoint of bfloat16 weights (as jamba's serving saves): its raw
    shards read as CPU tensors, and the peer store copies, serves and (when
    poisoned) corrupts them like numpy shards; the fleet is bit-equal to a
    direct restore."""
    from repro_torch.ckpt.saver import snapshot_state

    specs = {n: _spec(T, n, shape, dims, dtype="bfloat16") for n, shape, dims in (
        ("w", (8, 6), [("data",), ("model",)]), ("b", (4,), [()]))}
    g = torch.Generator().manual_seed(5)
    state = TrainState(*({n: torch.randn(s.logical_shape, generator=g).to(torch.bfloat16)
                          for n, s in specs.items()} for _ in range(3)), step=1)
    write_distributed(snapshot_state(state), _plan(T, specs, MESH_2X2), 1, tmp_path / "step_1")
    ckpt = T.DistCheckpoint.open(tmp_path / "step_1")
    registry = PublicationRegistry()
    pub = registry.publish(ckpt)
    tgt_plan = _plan(T, specs, MESH_1X1)
    first = FleetReplica("first", registry, tgt_plan, "cpu", engine=_serial())
    assert first.sync()
    key = next(k for k in pub.digests if "/w@fp32" in k)
    skey = f"{key}@{pub.digests[key]}"
    assert isinstance(registry.fetch(skey, "first"), torch.Tensor)
    registry.poison_holder("first", skey)
    victim = FleetReplica("victim", registry, tgt_plan, "cpu", engine=_serial())
    assert victim.sync()
    assert victim.stats.digest_failures == 1 and victim.stats.refetches == 1
    want = flatten_with_paths(state_from_source(ckpt, tgt_plan, "cpu", engine=_serial()).params)
    for r in (first, victim):
        got = r.flat_params()
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert t.dtype == torch.bfloat16 and torch.equal(t, want[name]), name


# ---------------------------------------------------------------------------
# Delta-aware publishes: in-place updates
# ---------------------------------------------------------------------------


def test_delta_publish_updates_replica_in_place(published):
    tmp, plan, snap, ckpt, registry, pub, tgt_plan = published
    r = FleetReplica("r", registry, tgt_plan, "cpu", engine=_serial())
    assert r.sync()
    assert r.last_update == frozenset(_specs(T))
    bytes_full = r.restore_stats.bytes_read
    before = r.flat_params()
    snap2 = _copy(snap)
    snap2["u"][T.StateKind.FP32] += 1.0
    write_distributed(snap2, plan, 2, tmp / "step_2", save_mode="delta", base=ckpt)
    ck2 = T.DistCheckpoint.open(tmp / "step_2")
    assert registry.publish(ck2).kind == "delta"
    assert r.sync()
    assert r.last_update == frozenset({"u"})
    assert r.restore_stats.bytes_read < 2 * bytes_full  # the diff, not a rebuild
    after = r.flat_params()
    assert after["w"] is before["w"] and after["b"] is before["b"]  # kept in place
    _same_params(after, _direct(ck2, tgt_plan))
    snap3 = _copy(snap2)
    snap3["w"][T.StateKind.EXP_AVG] += 1.0  # invisible to a weights-only replica
    write_distributed(snap3, plan, 3, tmp / "step_3", save_mode="delta", base=ck2)
    registry.publish(T.DistCheckpoint.open(tmp / "step_3"))
    assert r.sync()
    assert r.last_update == frozenset()
    assert r.step == 3


def test_gapped_feed_falls_back_to_full_rebuild(published):
    tmp, plan, snap, ckpt, registry, pub, tgt_plan = published
    r = FleetReplica("r", registry, tgt_plan, "cpu", engine=_serial())
    assert r.sync()
    snap2 = _copy(snap)
    snap2["u"][T.StateKind.FP32] += 1.0
    write_distributed(snap2, plan, 2, tmp / "step_2")
    registry.publish(T.DistCheckpoint.open(tmp / "step_2"))
    r.subscription.poll()  # lose the announcement (the gap)
    snap3 = _copy(snap2)
    snap3["b"][T.StateKind.FP32] += 1.0
    write_distributed(snap3, plan, 3, tmp / "step_3")
    ck3 = T.DistCheckpoint.open(tmp / "step_3")
    registry.publish(ck3)
    assert r.sync()
    assert r.last_update == frozenset(_specs(T))  # not contiguous: a rebuild
    _same_params(r.flat_params(), _direct(ck3, tgt_plan))


# ---------------------------------------------------------------------------
# Manager publish hook
# ---------------------------------------------------------------------------


def _state(snap, specs, step=0):
    def tree(kind):
        return {n: torch.from_numpy(snap[n][kind].copy()) for n in specs}

    return TrainState(params=tree(T.StateKind.FP32), exp_avg=tree(T.StateKind.EXP_AVG),
                      exp_avg_sq=tree(T.StateKind.EXP_AVG_SQ), step=step)


def test_manager_publishes_on_commit(tmp_path):
    specs = _specs(T)
    plan = _plan(T, specs, MESH_2X2)
    state = _state(_random_state(specs), specs)
    registry = PublicationRegistry()
    sub = registry.subscribe("watcher")
    mgr = CheckpointManager(tmp_path / "ck", plan,
                            policy=CheckpointPolicy(async_save=False, registry=registry))
    mgr.save(state, 10)
    assert [p.step for p in sub.poll()] == [10]
    # async saves publish once the commit is observed (at wait()); a fresh
    # manager over the same root first re-announces the committed step.  The
    # writer is held before its first shard, so save() returns before step
    # 20 can commit, whatever the scheduling.
    mgr2 = CheckpointManager(tmp_path / "ck", plan,
                             policy=CheckpointPolicy(async_save=True, registry=registry))
    hold = Schedule(0, (FaultSpec("saver.shard", action="pause", hit=1, args=("write",)),))
    with ChaosController(hold) as ctrl:
        mgr2.save(state, 20)
        ctrl.wait_paused("write")
        assert [p.step for p in sub.poll()] == [10]
        ctrl.release("write")
        mgr2.wait()
    mgr2.close()
    assert [p.step for p in sub.poll()] == [20]
    assert registry.current().step == 20
    mgr2.publish(10)  # an explicit older publish never moves the cursor back
    assert mgr2._published_step == 20
    mgr.close()


def test_crash_mid_publish_fleet_still_serves(tmp_path):
    """A crash between the publish-time store GC and delivery: replicas on
    the old publication keep serving it, a fresh replica rebuilds the new
    step from disk, the next publish heals the fleet, and the manager's GC
    keeps the published step past keep_last throughout."""
    specs = _specs(T)
    plan, tgt_plan = _plan(T, specs, MESH_2X2), _plan(T, specs, MESH_1X1)

    def state_at(seed):
        snap = _random_state(specs, seed=seed)
        return snap, _state(snap, specs)

    registry = PublicationRegistry()
    mgr = CheckpointManager(tmp_path / "ck", plan, policy=CheckpointPolicy(
        keep_last=1, save_interval=10, async_save=False, io_workers=1, registry=registry))
    snap10, state10 = state_at(1)
    mgr.save(state10, 10)
    r1 = FleetReplica("r1", registry, tgt_plan, "cpu")
    assert r1.sync()
    snap20, state20 = state_at(2)
    with ChaosController(Schedule(0, (FaultSpec("registry.publish.deliver", hit=1),))):
        with pytest.raises(FaultError):
            mgr.save(state20, 20)
    assert registry.current().step == 20
    assert not r1.sync()  # never announced to r1: it stays on 10
    for name, t in r1.flat_params().items():
        np.testing.assert_array_equal(t.numpy(), snap10[name][T.StateKind.FP32])
    r2 = FleetReplica("r2", registry, tgt_plan, "cpu")
    assert r2.sync()
    for name, t in r2.flat_params().items():
        np.testing.assert_array_equal(t.numpy(), snap20[name][T.StateKind.FP32])
    snap30, state30 = state_at(3)
    mgr.save(state30, 30)
    assert registry.current().step == 30
    assert r1.sync() and r2.sync()
    for rep in (r1, r2):
        for name, t in rep.flat_params().items():
            np.testing.assert_array_equal(t.numpy(), snap30[name][T.StateKind.FP32])
    mgr.close()


# ---------------------------------------------------------------------------
# Concurrent-reader stress: shared engine, shared caches, no races
# ---------------------------------------------------------------------------


def test_concurrent_readers_one_engine_stress(tmp_path):
    """12 threads restoring through ONE engine (shared handle cache, arena,
    atom single-flight, shared regions) all produce bit-equal state with
    sane cache accounting."""
    import sys

    specs = _specs(T)
    plan, tgt_plan = _plan(T, specs, MESH_2X2), _plan(T, specs, MESH_1X1)
    write_distributed(_random_state(specs, seed=7), plan, 5, tmp_path / "step_5")
    ckpt = T.DistCheckpoint.open(tmp_path / "step_5")
    engine = CheckpointEngine(workers=4)
    ref = state_from_source(ckpt, tgt_plan, "cpu", engine=_serial())
    want_p, want_m = flatten_with_paths(ref.params), flatten_with_paths(ref.exp_avg)
    registry = PublicationRegistry()
    pub = registry.publish(ckpt)
    results: list = [None] * 12
    errs: list[BaseException] = []

    def reader(i: int):
        try:
            if i % 3 == 0:
                st = state_from_source(ckpt, tgt_plan, "cpu", engine=engine)
                results[i] = (flatten_with_paths(st.params), flatten_with_paths(st.exp_avg))
            elif i % 3 == 1:
                src = PeerFragmentSource(registry, pub, f"t{i}")
                results[i] = (params_from_source(src, tgt_plan, "cpu", engine=engine), None)
            else:
                out = {
                    n: torch.from_numpy(np.array(read_region_from_source(
                        ckpt, n, T.StateKind.FP32,
                        tuple(slice(0, d) for d in s.runtime_shape), "float32", engine=engine)))
                    for n, s in specs.items()
                }
                results[i] = (out, None)
        except BaseException as e:  # surfaced below
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    for params, moments in results:
        _same_params(params, want_p)
        if moments is not None:
            _same_params(moments, want_m)
    assert len(engine.handles) <= engine.handles.capacity
    assert engine.handles._bytes >= 0 and engine.atoms._bytes >= 0
    assert 0 <= engine.arena._retained <= engine.arena.max_bytes
    engine.close()


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------


def _smollm(pkg_cfg, build, sharding, mesh_mod, mesh_d, **kw):
    cfg = pkg_cfg.reduced(pkg_cfg.get_config("smollm-360m"))
    par, mesh = pkg_cfg.ParallelismConfig(), mesh_mod.MeshSpec.from_dict(mesh_d)
    lm = build(cfg, vocab_multiple=sharding.vocab_multiple(par, mesh), **kw)
    return lm, sharding.make_plan(cfg, lm.registry, par, mesh)


def test_reduced_smollm_fleet_equals_the_reference(tmp_path):
    """The reference writes a reduced smollm-360m under data=2,model=2; each
    package publishes it to a fleet of 3 under data=1,model=1 (RESHARD_STREAM,
    the fused wqkv consolidated).  The weights are bit-equal across the
    packages, and served unsharded they give equal greedy tokens with fp32
    logits within 1e-4."""
    rlm, rplan = _smollm(RC, ref_build, RS, R, MESH_2X2)
    rparams = rlm.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in ref_flatten(rparams).items()}
    snap = {n: {R.StateKind.FP32: a, R.StateKind.EXP_AVG: np.zeros_like(a),
                R.StateKind.EXP_AVG_SQ: np.zeros_like(a)} for n, a in flat.items()}
    ref_write(snap, rplan, 1, tmp_path / "step_1")

    rlm1, rplan1 = _smollm(RC, ref_build, RS, R, MESH_1X1, compute_dtype=jnp.float32,
                           remat="none")
    tlm1, tplan1 = _smollm(TC, build_model, TS, T, MESH_1X1, compute_dtype=torch.float32)
    rregistry, registry = RSV.PublicationRegistry(), PublicationRegistry()
    rregistry.publish(R.DistCheckpoint.open(tmp_path / "step_1"))
    pub = registry.publish(T.DistCheckpoint.open(tmp_path / "step_1"))
    rreps = [RSV.FleetReplica(f"f{i}", rregistry, rplan1, _jmesh(), engine=RefEngine(workers=2))
             for i in range(3)]
    reps = [FleetReplica(f"f{i}", registry, tplan1, "cpu", engine=CheckpointEngine(workers=2))
            for i in range(3)]
    for rr, r in zip(rreps, reps):
        assert rr.sync() and r.sync()
    fused = [n for n in tplan1.param_specs if n.endswith("wqkv")]
    assert fused and any(k.endswith("::atom::" + fused[0] + "@fp32")
                         for k in reps[0].engine.atoms._entries)
    rflat = {n: np.asarray(a) for n, a in rreps[0].flat_params().items()}
    for r in reps:
        _same_params(r.flat_params(), rflat)
    fp32 = [k for k in pub.digests if k.endswith("@fp32")]
    assert sum(r.stats.disk_fetches for r in reps) == len(fp32)

    # served unsharded (the reference's sharded gather needs an out
    # sharding under jax 0.9: ROADMAP section 3), from replica 1's weights
    # in the reference and replica 2's in the port
    b, s, steps = 2, 12, 4
    toks = np.random.default_rng(0).integers(0, tlm1.cfg.vocab_size, (b, s))
    rp = ref_unflatten({n: jnp.asarray(np.asarray(a)) for n, a in rreps[1].flat_params().items()})
    tp = reps[2].params
    rc, tc = RD.init_cache(rlm1, b, s + steps + 1), D.init_cache(tlm1, b, s + steps + 1)
    rl, rc = RD.prefill(rlm1, rp, rc, jnp.asarray(toks, jnp.int32))
    tl, tc = D.prefill(tlm1, tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4, rtol=0)
    cur = np.asarray(jnp.argmax(rl, -1))[:, None]
    assert np.array_equal(tl.argmax(-1)[:, None].numpy(), cur)
    for _ in range(steps):
        rl, rc = RD.decode_step(rlm1, rp, rc, jnp.asarray(cur, jnp.int32))
        tl, tc = D.decode_step(tlm1, tp, tc, torch.from_numpy(cur.copy()))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4, rtol=0)
        cur = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1)[:, None].numpy(), cur)


def test_coded_reshard_and_peer_fanout(tmp_path):
    """A 2x2 checkpoint with int8:b32 moments consolidates to a 1x1 target
    through the stream path, and serves the peer fan-out unchanged: the
    publication's digests are served digests, so peer checks pass on coded
    shards, and the fp32 weights are the reference's."""
    specs = _specs(T)
    snap = _random_state(specs, seed=13)
    write_distributed(snap, _plan(T, specs, MESH_2X2), 1, tmp_path / "step_1",
                      codec=CodecPolicy.moments("int8:b32"))
    ckpt = T.DistCheckpoint.open(tmp_path / "step_1")
    tgt_plan = _plan(T, specs, MESH_1X1)
    st = state_from_source(ckpt, tgt_plan, "cpu")
    for n in specs:
        np.testing.assert_array_equal(st.params[n].numpy(), snap[n][T.StateKind.FP32])
        raw = snap[n][T.StateKind.EXP_AVG]
        np.testing.assert_allclose(st.exp_avg[n].numpy(), raw, atol=np.abs(raw).max() / 120)
    registry = PublicationRegistry()
    pub = registry.publish(ckpt)
    params = params_from_source(PeerFragmentSource(registry, pub, "reader"), tgt_plan, "cpu")
    _same_params(params, {n: snap[n][T.StateKind.FP32] for n in specs})
    _same_params(params, _ref_params(tmp_path / "step_1", _specs(R)))
    # a coded moment shard through the peer source decodes on the host
    key = next(k for k in pub.digests if k.endswith("@exp_avg"))
    rank, rest = key.split("/")
    name = rest.rsplit("@", 1)[0]
    got = PeerFragmentSource(registry, pub, "moments").read_fragment(
        int(rank.split("_")[1]), name, T.StateKind.EXP_AVG)
    assert isinstance(got, np.ndarray) and digest_matches(got, pub.digests[key])
