"""The port's checkpoint I/O engine, held against the JAX package
(mirrors ``tests/test_engine.py`` case by case; the hot-tier cases wait for
the hot tier, ROADMAP queue 1 item 7):

* the port's parallel save (``workers=4``) is byte-identical to its serial
  save and to the reference's ``write_distributed`` at ``workers=1`` and
  ``workers=4`` — shard files, digests and manifests (apart from
  ``created_at``) — on random meshes and layouts, and on the reduced
  smollm-360m and mamba2-130m at data=2,model=2, raw and ``int8:b256``,
  dedup and all;
* a parallel restore (DIRECT and RESHARD_STREAM) is bit-equal to a serial
  one and to the reference's region reads;
* the fragment index matches a brute-force scan, the handle cache's LRU
  bounds it by entries and by bytes (a decoded tensor weighs its bytes),
  a restore opens (and decodes) each file once, a re-save drops the default
  engines' stale handles, and ``invalidate`` respects path boundaries;
* a parallel ``convert_to_ucp`` writes the reference's atoms byte for byte.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
from repro.ckpt.restore import read_region_from_source as ref_read_region  # noqa: E402
from repro.ckpt.saver import write_distributed as ref_write  # noqa: E402
from repro.core.codec import CodecPolicy as RefCodecPolicy  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.codec as TCODEC  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
import repro_torch.ckpt.restore as T_restore  # noqa: E402
from repro_torch.ckpt.restore import (  # noqa: E402
    read_region_from_source, state_from_source, state_from_stream, target_regions,
)
from repro_torch.ckpt.saver import AsyncSaver, SaveResult, write_distributed  # noqa: E402
from repro_torch.core.codec import CodecPolicy  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    BufferArena, CheckpointEngine, HandleCache, _key_under_root, default_engine,
    default_workers,
)
from repro_torch.core.pytree import flatten_with_paths  # noqa: E402
from repro_torch.dist.sharding import ShardingPlan  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.train.optimizer import TrainState  # noqa: E402

ARCHS = ["smollm-360m", "mamba2-130m"]
MESH = {"data": 2, "model": 2}


def _tree_bytes(root):
    """{relative path: bytes} of every shard file under a checkpoint dir."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.glob("ranks/**/*.npy"))}


def _manifest_json(root):
    j = R.DistCheckpoint.open(root).manifest.to_json()
    j.pop("created_at")
    return j


def _random_state(specs, seed=0):
    rng = np.random.default_rng(seed)
    return {
        n: {k: rng.normal(size=s.runtime_shape).astype(np.float32) for k in T.STATE_KINDS}
        for n, s in specs.items()
    }


def _to_ref(snap):
    return {n: {R.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snap.items()}


def _plans(arch, mesh_d):
    """(port plan, reference plan) of a reduced config under ``mesh_d``."""
    tcfg, rcfg = TC.reduced(TC.get_config(arch)), RC.reduced(RC.get_config(arch))
    tmesh, rmesh = T.MeshSpec.from_dict(mesh_d), R.MeshSpec.from_dict(mesh_d)
    tpar, rpar = TC.ParallelismConfig(), RC.ParallelismConfig()
    tlm = port_build(tcfg, vocab_multiple=TS.vocab_multiple(tpar, tmesh))
    rlm = ref_build(rcfg, vocab_multiple=RS.vocab_multiple(rpar, rmesh))
    return TS.make_plan(tcfg, tlm.registry, tpar, tmesh), RS.make_plan(rcfg, rlm.registry, rpar, rmesh)


def _same_checkpoints(*roots):
    first = roots[0]
    files, manifest = _tree_bytes(first), _manifest_json(first)
    assert files, "no shard files"
    for other in roots[1:]:
        got = _tree_bytes(other)
        assert got.keys() == files.keys(), other
        for rel in files:
            assert got[rel] == files[rel], f"{other}: {rel} differs"
        assert _manifest_json(other) == manifest, other


# ---------------------------------------------------------------------------
# Property: parallel save + indexed parallel restore == serial == reference
# ---------------------------------------------------------------------------


@st.composite
def _case(draw):
    mesh = (("data", draw(st.integers(1, 3))), ("model", draw(st.integers(1, 3))))
    tgt = (("data", draw(st.integers(1, 3))), ("model", draw(st.integers(1, 3))))
    rows, cols = draw(st.integers(1, 12)), draw(st.integers(1, 9))
    axis_choices = [(), ("data",), ("model",), ("data", "model")]
    sdims = (draw(st.sampled_from(axis_choices)), draw(st.sampled_from([(), ("model",)])))
    tdims = (draw(st.sampled_from(axis_choices)), draw(st.sampled_from([(), ("model",)])))
    if set(sdims[0]) & set(sdims[1]):
        sdims = (sdims[0], ())
    if set(tdims[0]) & set(tdims[1]):
        tdims = (tdims[0], ())
    save_mode = draw(st.sampled_from(["dedup", "all"]))
    return mesh, tgt, (rows, cols), sdims, tdims, save_mode


@settings(max_examples=25, deadline=None)
@given(_case())
def test_property_parallel_paths_bit_identical(tmp_path_factory, case):
    mesh_axes, tgt_axes, shape, sdims, tdims, save_mode = case
    tmp = tmp_path_factory.mktemp("eng")

    def specs(M):
        return {
            "w": M.uniform_param_spec("w", shape, [M.DimSpec(a) for a in sdims]),
            "b": M.uniform_param_spec("b", (shape[0],), [M.DimSpec(sdims[0])]),
        }

    tspecs, rspecs = specs(T), specs(R)
    snap = _random_state(tspecs, seed=shape[0] * 31 + shape[1])
    tplan = ShardingPlan(mesh=T.MeshSpec(mesh_axes), param_specs=tspecs)
    rplan = RS.ShardingPlan(mesh=R.MeshSpec(mesh_axes), param_specs=rspecs)
    write_distributed(snap, tplan, 1, tmp / "ser", workers=1, save_mode=save_mode)
    write_distributed(snap, tplan, 1, tmp / "par", workers=4, save_mode=save_mode)
    ref_write(_to_ref(snap), rplan, 1, tmp / "ref1", workers=1, save_mode=save_mode)
    ref_write(_to_ref(snap), rplan, 1, tmp / "ref4", workers=4, save_mode=save_mode)
    _same_checkpoints(tmp / "ser", tmp / "par", tmp / "ref1", tmp / "ref4")

    # Region reads under an arbitrary Target layout: serial engine, parallel
    # engine and the truth agree.
    ck = T.DistCheckpoint.open(tmp / "par")
    tgt_mesh = T.MeshSpec(tgt_axes)
    with CheckpointEngine(workers=1) as e1, CheckpointEngine(workers=4) as e4:
        for name, spec in tspecs.items():
            layout = T.uniform_param_spec(
                name, spec.logical_shape, [T.DimSpec(a) for a in tdims[: len(spec.logical_shape)]]
            ).layout_for(T.StateKind.FP32, tgt_mesh)
            regions = [e.atom_index() for r in tgt_mesh.ranks() for e in layout.entries[r]]
            regions.append(tuple(slice(0, s) for s in spec.runtime_shape))
            for region in regions:
                want = snap[name][T.StateKind.FP32][region]
                for eng in (e1, e4):
                    got = read_region_from_source(ck, name, T.StateKind.FP32, region, "float32",
                                                  engine=eng)
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("save_mode", ["dedup", "all"])
@pytest.mark.parametrize("codec", [None, "int8:b256"])
@pytest.mark.parametrize("arch", ARCHS)
def test_parallel_save_byte_identical_to_serial_and_reference(tmp_path, arch, codec, save_mode):
    """A full-size layout of a real config: the port's serial and 4-wide
    saves and the reference's serial and 4-wide saves write the same files,
    digests and manifests, raw and with coded moments."""
    tplan, rplan = _plans(arch, MESH)
    snap = _random_state(tplan.param_specs, seed=len(arch))
    tcodec = CodecPolicy.moments(codec) if codec else None
    rcodec = RefCodecPolicy.moments(codec) if codec else None
    kw = dict(save_mode=save_mode, scalars={"cursor": 3}, config_fingerprint={"arch": arch})
    ser = write_distributed(snap, tplan, 7, tmp_path / "ser", workers=1, codec=tcodec, **kw)
    par = write_distributed(snap, tplan, 7, tmp_path / "par", workers=4, codec=tcodec, **kw)
    for w in (1, 4):
        ref_write(_to_ref(snap), rplan, 7, tmp_path / f"ref{w}", workers=w, codec=rcodec, **kw)
    _same_checkpoints(tmp_path / "ser", tmp_path / "par", tmp_path / "ref1", tmp_path / "ref4")
    assert R.DistCheckpoint.open(tmp_path / "par").validate() == []
    assert bool(_manifest_json(tmp_path / "par").get("shard_codecs")) == bool(codec)
    for a, b in ((ser, par),):
        assert (a.bytes_written, a.shards_written, a.coded_raw_bytes, a.coded_bytes) == \
            (b.bytes_written, b.shards_written, b.coded_raw_bytes, b.coded_bytes)
    assert (par.mode, par.shards_inherited, par.fallback_reason) == ("full", 0, "")
    assert par.bytes_written == sum(p.stat().st_size - _npy_header(p)
                                    for p in (tmp_path / "par").glob("ranks/**/*.npy"))


def _npy_header(path) -> int:
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            np.lib.format.read_array_header_1_0(f)
        else:
            np.lib.format.read_array_header_2_0(f)
        return f.tell()


@pytest.mark.parametrize("tgt_mesh,mode", [(MESH, "direct"), ({"data": 1, "model": 1}, "reshard_stream")])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_parallel_restore_equals_serial(tmp_path, arch, tgt_mesh, mode):
    """A full TrainState restore (coded moments) through a serial and a
    4-wide engine is bit-equal, and every region equals the reference's
    read of the same checkpoint."""
    tplan, rplan = _plans(arch, MESH)
    snap = _random_state(tplan.param_specs, seed=5)
    write_distributed(snap, tplan, 2, tmp_path / "ck", workers=4, codec=CodecPolicy.moments())
    ck = T.DistCheckpoint.open(tmp_path / "ck")
    tgt_plan, _ = _plans(arch, tgt_mesh)
    rp = T.plan_resume(ck.manifest, T.TargetSpec(tgt_plan.mesh, tgt_plan.param_specs))
    assert rp.mode.value == mode
    states = []
    for w in (1, 4):
        with CheckpointEngine(workers=w) as eng:
            if rp.transforms is None:
                states.append(state_from_source(ck, tgt_plan, "cpu", engine=eng))
            else:
                states.append(state_from_stream(ck, tgt_plan, "cpu", rp.transforms, engine=eng))
    rck = R.DistCheckpoint.open(tmp_path / "ck")
    for field, kind in (("params", T.StateKind.FP32), ("exp_avg", T.StateKind.EXP_AVG),
                        ("exp_avg_sq", T.StateKind.EXP_AVG_SQ)):
        a, b = (flatten_with_paths(getattr(s, field)) for s in states)
        assert a.keys() == b.keys() == set(snap)
        for name, t in a.items():
            assert torch.equal(t, b[name]), (field, name)
            if rp.transforms is None:
                for region in target_regions(tgt_plan.param_specs[name], tgt_plan.mesh, kind):
                    want = ref_read_region(rck, name, R.StateKind(kind.value), region, "float32")
                    assert t.numpy()[region].tobytes() == np.ascontiguousarray(want).tobytes()
    logical = {n: tuple(slice(0, s) for s in tplan.param_specs[n].logical_shape) for n in snap}
    for name, t in flatten_with_paths(states[1].params).items():
        np.testing.assert_array_equal(t.numpy()[logical[name]],
                                      snap[name][T.StateKind.FP32][logical[name]])


@pytest.mark.parametrize("workers", [1, 4])
def test_manager_restore_under_a_splitting_layout_decodes_each_file_once(tmp_path, monkeypatch,
                                                                          workers):
    """A coded resume under data=4,model=1 of a data=2,model=2 save, where
    coded shards feed two Target regions each: every coded file is decoded
    once, the state equals a restore through a fresh serial engine, and the
    manager's engine holds nothing of the checkpoint after the restore or
    after an export."""
    tplan, _ = _plans("smollm-360m", MESH)
    snap = _random_state(tplan.param_specs, seed=9)
    write_distributed(snap, tplan, 2, tmp_path / "step_00000002", workers=4,
                      codec=CodecPolicy.moments())
    ck = T.DistCheckpoint.open(tmp_path / "step_00000002")
    tgt_plan, _ = _plans("smollm-360m", {"data": 4, "model": 1})
    uses = {}
    with CheckpointEngine(workers=1) as eng:
        for name, spec in tgt_plan.param_specs.items():
            for kind in (T.StateKind.EXP_AVG, T.StateKind.EXP_AVG_SQ):
                idx = eng.index_for(ck, name, kind)
                for region in target_regions(spec, tgt_plan.mesh, kind):
                    for rank, _, _ in idx.overlapping(region):
                        uses[(rank, name, kind)] = uses.get((rank, name, kind), 0) + 1
    n_coded = sum(tag != "raw" for tag in ck.manifest.shard_codecs.values())
    assert len(uses) == n_coded and sum(n > 1 for n in uses.values()) > n_coded // 2
    rp = T.plan_resume(ck.manifest, T.TargetSpec(tgt_plan.mesh, tgt_plan.param_specs))
    with CheckpointEngine(workers=1) as eng:
        want = state_from_stream(ck, tgt_plan, "cpu", rp.transforms, engine=eng)

    decodes = []
    real = TCODEC.decode_file
    monkeypatch.setattr(TCODEC, "decode_file",
                        lambda path, *a, **k: decodes.append(str(path)) or real(path, *a, **k))
    mgr = CheckpointManager(tmp_path, tgt_plan,
                            policy=CheckpointPolicy(async_save=False, io_workers=workers))
    state, info = mgr.restore("cpu")
    assert info.mode.value == "reshard_stream" and state.step == 2
    assert len(decodes) == len(set(decodes)) == n_coded
    eng = mgr.engine_for("cpu")
    assert len(eng.handles) == 0 and len(eng.atoms) == 0
    for field in ("params", "exp_avg", "exp_avg_sq"):
        a, b = (flatten_with_paths(getattr(s, field)) for s in (state, want))
        assert a.keys() == b.keys()
        for name, t in a.items():
            assert torch.equal(t, b[name]), (field, name)
    logical = {n: tuple(slice(0, s) for s in tplan.param_specs[n].logical_shape) for n in snap}
    for name, t in flatten_with_paths(state.params).items():
        np.testing.assert_array_equal(t.numpy()[logical[name]],
                                      snap[name][T.StateKind.FP32][logical[name]])
    mgr.export_ucp(2, device="cpu")
    assert len(eng.handles) == 0 and len(eng.atoms) == 0
    mgr.close()


@pytest.mark.parametrize("entry", ["params_from_source", "state_from_source",
                                   "state_from_stream", "restore_params"])
def test_restore_without_an_engine_leaves_the_default_engine_empty(tmp_path, entry):
    """A restore that picks the default engine itself drops every handle
    and consolidated atom of the checkpoint when it ends (decoded shards
    would otherwise stay cached up to the byte bound, on the card too)."""
    from repro_torch.launch.serve import restore_params

    tplan, _ = _plans("smollm-360m", MESH)
    write_distributed(_random_state(tplan.param_specs, seed=4), tplan, 1,
                      tmp_path / "step_00000001", workers=1, codec=CodecPolicy.moments())
    ck = T.DistCheckpoint.open(tmp_path / "step_00000001")
    stream_plan, _ = _plans("smollm-360m", {"data": 1, "model": 1})
    transforms = T.plan_resume(
        ck.manifest, T.TargetSpec(stream_plan.mesh, stream_plan.param_specs)).transforms
    eng = default_engine("cpu")
    mine = lambda cache: [k for k in cache._entries if k.startswith(str(tmp_path))]  # noqa: E731
    if entry == "params_from_source":
        out = T_restore.params_from_source(ck, tplan, "cpu")
    elif entry == "state_from_source":
        out = state_from_source(ck, tplan, "cpu").exp_avg
    elif entry == "state_from_stream":
        out = state_from_stream(ck, stream_plan, "cpu", transforms).exp_avg
    else:
        out, rp = restore_params(tmp_path / "step_00000001", stream_plan, "cpu")
        assert rp.mode.value == "reshard_stream"
    assert out and not mine(eng.handles) and not mine(eng.atoms)


@pytest.mark.parametrize("workers", [1, 4])
def test_a_restored_state_is_freed_without_the_garbage_collector(tmp_path, workers):
    """Neither a restore nor ``flatten_with_paths`` leaves a reference cycle
    around the state: its tensors (card memory, on a card) are freed as soon
    as the caller drops them, not whenever the collector next runs."""
    import gc
    import weakref

    tplan, _ = _plans("smollm-360m", MESH)
    write_distributed(_random_state(tplan.param_specs, seed=6), tplan, 1,
                      tmp_path / "step_00000001", workers=1, codec=CodecPolicy.moments())
    tgt_plan, _ = _plans("smollm-360m", {"data": 4, "model": 1})
    mgr = CheckpointManager(tmp_path, tgt_plan,
                            policy=CheckpointPolicy(async_save=False, io_workers=workers))
    gc.disable()
    try:
        state, _ = mgr.restore("cpu")
        refs = [weakref.ref(t) for tree in (state.params, state.exp_avg, state.exp_avg_sq)
                for t in flatten_with_paths(tree).values()]
        del state
        alive = sum(r() is not None for r in refs)
    finally:
        gc.enable()
        mgr.close()
    assert refs and alive == 0


# ---------------------------------------------------------------------------
# Fragment index, handle cache, arena
# ---------------------------------------------------------------------------


def test_fragment_index_matches_brute_force(tmp_path):
    mesh = T.MeshSpec.from_dict({"data": 3, "model": 2})
    specs = {"w": T.uniform_param_spec("w", (13, 7), [T.DimSpec(("data",)), T.DimSpec(("model",))])}
    write_distributed(_random_state(specs, seed=11), ShardingPlan(mesh, specs), 1, tmp_path / "ck",
                      workers=1)
    ck = T.DistCheckpoint.open(tmp_path / "ck")
    eng = CheckpointEngine(workers=1)
    idx = eng.index_for(ck, "w", T.StateKind.FP32)
    layout = idx.layout
    rng = np.random.default_rng(0)
    for _ in range(30):
        r0, r1 = sorted(rng.integers(0, 14, size=2)), sorted(rng.integers(0, 8, size=2))
        if r0[0] == r0[1] or r1[0] == r1[1]:
            continue
        region = (slice(r0[0], r0[1]), slice(r1[0], r1[1]))
        got = {(rank, e.atom_slice) for rank, e, _ in idx.overlapping(region)}
        want, seen = set(), set()
        for rank in ck.writing_ranks("w", T.StateKind.FP32):
            if layout.fragment_id[rank] in seen:
                continue
            seen.add(layout.fragment_id[rank])
            for e in layout.entries[rank]:
                if all(max(a0, r.start) < min(a1, r.stop) for (a0, a1), r in zip(e.atom_slice, region)):
                    want.add((rank, e.atom_slice))
        assert got == want
    assert eng.index_for(ck, "w", T.StateKind.FP32) is idx  # built once, cached


def test_handle_cache_lru_eviction():
    cache = HandleCache(capacity=2)
    loads = []

    def loader(path):
        return lambda: loads.append(path) or f"handle:{path}"

    assert cache.get("/a", loader("/a")) == "handle:/a"
    assert cache.get("/b", loader("/b")) == "handle:/b"
    assert cache.get("/a", loader("/a")) == "handle:/a"  # hit, /a now MRU
    assert cache.get("/c", loader("/c")) == "handle:/c"  # evicts /b (LRU)
    assert len(cache) == 2
    assert "/b" not in cache and "/a" in cache and "/c" in cache
    assert cache.evictions == 1 and cache.hits == 1 and cache.misses == 3
    cache.get("/b", loader("/b"))  # /b must be re-loaded after eviction
    assert loads == ["/a", "/b", "/c", "/b"]
    with pytest.raises(ValueError):
        HandleCache(capacity=0)


def test_handle_cache_weighs_tensors_and_arrays_by_bytes(tmp_path):
    """Decoded tensors and materialized arrays carry their bytes (the bound
    holds on the card too); mmap views are light."""
    cache = HandleCache(capacity=100, max_bytes=1000)
    np.save(tmp_path / "m.npy", np.zeros(1000, np.float32))
    cache.get("/mmap", lambda: np.load(tmp_path / "m.npy", mmap_mode="r"))
    cache.get("/t1", lambda: torch.zeros(100))  # 400 bytes
    cache.get("/a1", lambda: np.zeros(100, np.float32))  # 400 bytes
    assert cache._bytes == 800 and len(cache) == 3
    cache.get("/t2", lambda: torch.zeros(200, dtype=torch.bfloat16))  # 400: over the bound
    assert "/mmap" not in cache and "/t1" not in cache  # LRU order, until under the bound
    assert cache._bytes == 800 and cache.evictions == 2


def test_buffer_arena_recycles_only_dead_views():
    arena = BufferArena()
    a = arena.alloc((100,), "float32")
    assert (a == 0).all()
    alias = torch.from_numpy(a)  # a consumer that aliases rather than copies
    arena.recycle(a)
    del a
    b = arena.alloc((100,), "float32", zero=False)
    assert arena.reuses == 0, "storage reused under a live alias"
    b[:] = 7
    assert (alias == 0).all()
    del alias
    c = arena.alloc((90,), "float32", zero=False)  # same bucket, alias gone now
    assert arena.reuses == 1 and c.shape == (90,)
    arena.recycle(np.zeros(4))  # foreign arrays pass through
    arena.recycle(torch.zeros(4))


def test_restore_opens_each_file_once(tmp_path, monkeypatch):
    """N params x R regions touches each shard file once, and decodes each
    coded file once, on a serial and on a parallel engine."""
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 1})
    specs = {"w": T.uniform_param_spec("w", (8, 256), [T.DimSpec(("data",)), T.DimSpec()])}
    write_distributed(_random_state(specs, seed=3), ShardingPlan(mesh, specs), 1, tmp_path / "ck",
                      workers=1, codec=CodecPolicy.moments())
    ck = T.DistCheckpoint.open(tmp_path / "ck")
    eng = CheckpointEngine(workers=1)
    for lo in range(0, 8, 2):  # 4 regions, 2 shard files
        read_region_from_source(ck, "w", T.StateKind.FP32, (slice(lo, lo + 2), slice(None)),
                                 "float32", engine=eng)
    assert eng.handles.misses == 2  # one open per shard file…
    assert eng.handles.hits >= 2  # …every later region reuses the handle

    decodes = []
    real = TCODEC.decode_file
    monkeypatch.setattr(TCODEC, "decode_file",
                        lambda path, *a, **k: decodes.append(str(path)) or real(path, *a, **k))
    with CheckpointEngine(workers=8) as par:
        regions = [(slice(lo, lo + 1), slice(None)) for lo in range(8)] * 4
        got = par.map(lambda r: read_region_from_source(ck, "w", T.StateKind.EXP_AVG, r,
                                                       "float32", engine=par), regions)
    assert sorted(decodes) == sorted(set(decodes)) and len(decodes) == 2
    full = np.concatenate(got[:8])
    np.testing.assert_array_equal(full, T.assemble_atom(ck, specs["w"], T.StateKind.EXP_AVG))


def test_resave_invalidates_default_engine_handles(tmp_path):
    """Re-saving into the same directory must not leave a default engine
    serving the old checkpoint's bytes from cached handles."""
    mesh = T.MeshSpec.from_dict({"data": 1, "model": 1})
    specs = {"w": T.uniform_param_spec("w", (4,), [T.DimSpec()])}
    plan = ShardingPlan(mesh, specs)
    region = (slice(0, 4),)
    snap1 = {"w": {k: np.full((4,), 1.0, np.float32) for k in T.STATE_KINDS}}
    snap2 = {"w": {k: np.full((4,), 2.0, np.float32) for k in T.STATE_KINDS}}
    write_distributed(snap1, plan, 1, tmp_path / "ck", workers=2)
    ck = T.DistCheckpoint.open(tmp_path / "ck")
    got = read_region_from_source(ck, "w", T.StateKind.FP32, region, "float32")
    np.testing.assert_array_equal(got, snap1["w"][T.StateKind.FP32])
    assert str(ck.shard_path(0, "w", T.StateKind.FP32)) in default_engine().handles
    # overwrite through a private pool (a workers override): the default
    # engine's cached handle of the old file must still be dropped
    write_distributed(snap2, plan, 1, tmp_path / "ck", workers=3)
    ck2 = T.DistCheckpoint.open(tmp_path / "ck")
    got = read_region_from_source(ck2, "w", T.StateKind.FP32, region, "float32")
    np.testing.assert_array_equal(got, snap2["w"][T.StateKind.FP32])


def test_default_engine_is_one_per_device():
    assert default_engine() is default_engine("cpu") is default_engine(None)
    assert default_engine().workers == default_workers() >= 4
    assert default_engine().decode_device is None


def test_invalidate_respects_path_boundaries():
    """invalidate(root) drops root's own keys (its delta-variant cache key
    and derived atom keys too), never a sibling's that merely shares the
    root as a string prefix (run1 vs run10)."""
    root = "/ck/run1"
    assert _key_under_root("/ck/run1", root)
    assert _key_under_root("/ck/run1/ranks/r0/a.npy", root)
    assert _key_under_root("/ck/run1@delta:10", root)
    assert _key_under_root("/ck/run1::atom::w@fp32", root)
    assert not _key_under_root("/ck/run10", root)
    assert not _key_under_root("/ck/run10/ranks/r0/a.npy", root)
    assert not _key_under_root("/ck/run1.ucp/atoms/w/fp32.npy", root)
    eng = CheckpointEngine(workers=2)
    arr = np.zeros(4, np.float32)
    eng.handles.get("/ck/run1/ranks/r0/a.npy", lambda: arr)
    eng.handles.get("/ck/run10/ranks/r0/a.npy", lambda: arr)
    eng.invalidate("/ck/run1")
    assert "/ck/run1/ranks/r0/a.npy" not in eng.handles
    assert "/ck/run10/ranks/r0/a.npy" in eng.handles
    eng.close()


def test_single_flight_builds_once_under_racing_threads():
    """A consolidated atom asked for by many region reads at once is built
    once (the stream restore's fused-QKV consolidation)."""
    eng = CheckpointEngine(workers=8)
    built, gate = [], threading.Event()

    class Src:
        cache_key = "/ck/src"

    def builder():
        built.append(1)
        gate.wait(2)
        return np.arange(10)

    def ask(_):
        return eng.consolidated(Src, "w", T.StateKind.FP32, builder)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(10)
    assert len(built) == 1
    eng.invalidate("/ck/src")
    ask(0)
    assert len(built) == 2
    eng.close()


def test_map_runs_inline_when_serial_and_in_order_when_parallel():
    main = threading.get_ident()
    with CheckpointEngine(workers=1) as e1:
        assert e1.map(lambda x: (x, threading.get_ident()), range(3)) == [(i, main) for i in range(3)]
        assert not e1.use_arena
    with CheckpointEngine(workers=4) as e4:
        out = e4.map(lambda x: (x * x, threading.get_ident()), range(50))
        assert [a for a, _ in out] == [i * i for i in range(50)]
        assert {t for _, t in out} - {main}
        assert e4.use_arena
    with pytest.raises(ValueError):
        CheckpointEngine(workers=0)


# ---------------------------------------------------------------------------
# Conversion and the async saver
# ---------------------------------------------------------------------------


def test_convert_stats_counts_atom_files(tmp_path):
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 1})
    specs = {
        "w": T.uniform_param_spec("w", (6, 4), [T.DimSpec(("data",)), T.DimSpec()]),
        "b": T.uniform_param_spec("b", (4,), [T.DimSpec()]),
    }
    write_distributed(_random_state(specs, seed=5), ShardingPlan(mesh, specs), 1,
                      tmp_path / "ck", workers=1)
    _, stats = T.convert_to_ucp(T.DistCheckpoint.open(tmp_path / "ck"), str(tmp_path / "ucp"),
                                workers=2)
    # one atom *file* per (param, state kind), not one per parameter
    assert stats.params == 2
    assert stats.atoms_written == 2 * len(T.STATE_KINDS)


@pytest.mark.parametrize("codec", [None, "int8:b256"])
@pytest.mark.parametrize("arch", ARCHS)
def test_parallel_convert_writes_reference_atoms(tmp_path, arch, codec):
    """``convert_to_ucp`` at workers=4 (and through a 4-wide engine) writes
    the serial conversion's atoms and the reference's, byte for byte."""
    tplan, rplan = _plans(arch, MESH)
    snap = _random_state(tplan.param_specs, seed=9)
    write_distributed(snap, tplan, 4, tmp_path / "ck", workers=4,
                      codec=CodecPolicy.moments(codec) if codec else None)
    ck = T.DistCheckpoint.open(tmp_path / "ck")
    outs = {
        "ser": T.convert_to_ucp(ck, str(tmp_path / "ser"), workers=1)[0],
        "par": T.convert_to_ucp(ck, str(tmp_path / "par"), workers=4)[0],
        "eng": T.convert_to_ucp(ck, str(tmp_path / "eng"), engine=CheckpointEngine(workers=4))[0],
    }
    ref, _ = R.convert_to_ucp(R.DistCheckpoint.open(tmp_path / "ck"), str(tmp_path / "ref"),
                              workers=4)
    want = {str(p.relative_to(tmp_path / "ref")): p.read_bytes()
            for p in sorted((tmp_path / "ref").glob("atoms/**/*.npy"))}
    assert want
    for label, ucp in outs.items():
        got = {str(p.relative_to(ucp.root)): p.read_bytes() for p in sorted(ucp.root.glob("atoms/**/*.npy"))}
        assert got == want, label
        assert {n: a.digests for n, a in ucp.manifest.atoms.items()} == \
            {n: {T.StateKind(k.value): d for k, d in a.digests.items()}
             for n, a in ref.manifest.atoms.items()}, label
        assert ucp.validate() == []


def test_async_saver_bounds_pending_snapshots(monkeypatch):
    """submit() applies backpressure once max_pending jobs are queued."""
    import repro_torch.ckpt.saver as saver_mod

    release, started = threading.Event(), threading.Event()

    def slow_write(snap, plan, step, root, **kw):
        started.set()
        release.wait(10)
        return SaveResult(step, Path(str(root)), 0, 0.0)

    monkeypatch.setattr(saver_mod, "write_distributed", slow_write)
    monkeypatch.setattr(saver_mod, "snapshot_state", lambda state, codec=None: {})
    s = AsyncSaver(max_pending=1)
    s.submit(None, None, 1, "/tmp/x1")  # picked up by the writer, blocks
    assert started.wait(5)
    s.submit(None, None, 2, "/tmp/x2")  # fills the queue (depth 1)
    third_done = threading.Event()

    def third():
        s.submit(None, None, 3, "/tmp/x3")
        third_done.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    assert not third_done.wait(0.3), "the third submit should block on a full queue"
    release.set()
    assert third_done.wait(5), "submit must unblock once the disk catches up"
    t.join(5)
    assert len(s.wait()) == 3
    s.close()
    with pytest.raises(ValueError):
        AsyncSaver(max_pending=0)


def test_async_saver_drops_each_snapshot_after_its_write(tmp_path, monkeypatch):
    """A finished job no longer pins its snapshot: once ``wait()`` returns,
    nothing of it is alive (a coded kind's copy would otherwise stay on the
    card until the next save arrives)."""
    import gc
    import weakref

    import repro_torch.ckpt.saver as saver_mod

    specs = {"w": T.uniform_param_spec("w", (8, 6), [T.DimSpec(("data",)), T.DimSpec()])}
    plan = ShardingPlan(mesh=T.MeshSpec.from_dict({"data": 2}), param_specs=specs)
    refs = []
    real = saver_mod.snapshot_state

    def tracked(state, codec=None):
        snap = real(state, codec)
        refs.extend(weakref.ref(a) for kinds in snap.values() for a in kinds.values()
                    if isinstance(a, torch.Tensor))
        return snap

    monkeypatch.setattr(saver_mod, "snapshot_state", tracked)
    tree = {"w": torch.randn(8, 6)}
    state = TrainState(params=tree, exp_avg={"w": torch.rand(8, 6)},
                       exp_avg_sq={"w": torch.rand(8, 6)}, step=1)
    s = AsyncSaver(max_pending=1)
    s.submit(state, plan, 1, tmp_path / "step_1", codec=CodecPolicy.moments("int8:b256"))
    assert len(s.wait()) == 1
    gc.collect()
    assert len(refs) == 2 and all(r() is None for r in refs), "the writer kept its snapshot"
    s.close()


def test_engine_stress_under_many_threads(tmp_path, monkeypatch):
    """More threads than cores, a short switch interval: concurrent region
    reads of coded shards through one engine decode each file once and give
    the serial answer, and the handle cache's byte count stays the sum of
    its entries' weights while entries are evicted under it."""
    import sys

    mesh = T.MeshSpec.from_dict({"data": 4, "model": 2})
    specs = {f"w{i}": T.uniform_param_spec(f"w{i}", (16, 512), [T.DimSpec(("data",)),
                                                                T.DimSpec(("model",))])
             for i in range(4)}
    write_distributed(_random_state(specs, seed=13), ShardingPlan(mesh, specs), 1,
                      tmp_path / "ck", workers=4, codec=CodecPolicy.moments())
    ck = T.DistCheckpoint.open(tmp_path / "ck")
    regions = [(n, (slice(lo, lo + 2), slice(c, c + 128))) for n in specs
               for lo in range(0, 16, 2) for c in range(0, 512, 128)]
    with CheckpointEngine(workers=1) as serial:
        want = [read_region_from_source(ck, n, T.StateKind.EXP_AVG, r, "float32", engine=serial)
                for n, r in regions]
    decodes = []
    real = TCODEC.decode_file
    monkeypatch.setattr(TCODEC, "decode_file",
                        lambda path, *a, **k: decodes.append(str(path)) or real(path, *a, **k))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        # the byte bound evicts nothing here: each of the 32 files decodes once
        with CheckpointEngine(workers=32) as eng:
            got = eng.map(lambda j: read_region_from_source(ck, j[0], T.StateKind.EXP_AVG, j[1],
                                                            "float32", engine=eng), regions * 3)
            cache = eng.handles
            assert cache._bytes == sum(cache._weight(v) for v in cache._entries.values())
        # a bound smaller than one file: every get evicts, the count stays exact
        small = HandleCache(capacity=1000, max_bytes=8 * 512 * 4)
        threads = [threading.Thread(target=lambda i=i: [small.get(f"/k{(i + j) % 40}",
                                                                  lambda: np.zeros(512, np.float32))
                                                        for j in range(200)])
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert small._bytes == sum(small._weight(v) for v in small._entries.values()) <= 8 * 512 * 4
    finally:
        sys.setswitchinterval(old)
    assert len(decodes) == len(set(decodes)) == 32
    for a, b in zip(got, want * 3):
        np.testing.assert_array_equal(a, b)
