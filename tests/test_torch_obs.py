"""The port's obs layer and fault points, held against the JAX package
(``tests/test_obs.py`` case by case, on the CPU):

* the disabled fast path: one shared no-op singleton that never touches a
  Tracer, ``timed`` still measuring;
* nesting, the explicit handoff across threads, the engine pool's
  ``save.shard`` spans and the ``AsyncSaver`` job parented to their
  submitters;
* the Chrome export (valid JSON, thread metadata) and the validator
  rejecting bad nesting; delta counters equal to the ``SaveResult``;
  summary ordering and process exclusivity;
* across packages: the same numpy state saved by both under a tracer
  counts the same ``save.*`` and ``codec.encode_*`` numbers, raw and
  ``int8:b256``;
* an AST scan: every ported file emits the literal span, timed, event,
  counter and fault-point names of its reference file (exceptions listed
  with their reasons), the port's fault-point call sites are the
  reference's ``CATALOG`` less the three fan-out points (ROADMAP item 8),
  and the port's catalogs equal the reference's.
"""

import ast
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.chaos.points as ref_points  # noqa: E402
import repro.core as R  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
from repro.ckpt.saver import write_distributed as ref_write  # noqa: E402
from repro.core.codec import CodecPolicy as RefCodecPolicy  # noqa: E402

import repro_torch.chaos as chaos  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
import repro_torch.obs.trace as trace_mod  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.saver import snapshot_state, write_distributed  # noqa: E402
from repro_torch.core.codec import CodecPolicy  # noqa: E402
from repro_torch.core.dist_ckpt import DistCheckpoint  # noqa: E402
from repro_torch.core.layout import MeshSpec  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.dist.sharding import ShardingPlan, make_plan, vocab_multiple  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.optimizer import TrainState, init_state  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT, REF = REPO / "src" / "repro_torch", REPO / "src" / "repro"


@pytest.fixture(autouse=True)
def _no_tracer_leak():
    """Every test starts and ends with tracing disabled."""
    assert obs.active() is None, "a tracer leaked into this test"
    yield
    obs.disable()
    chaos.deactivate()


@pytest.fixture(scope="module")
def model_setup():
    cfg = TC.reduced(TC.get_config("smollm-360m"))
    mesh = MeshSpec.from_dict({"data": 2, "model": 2})
    parallel = TC.ParallelismConfig()
    lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh))
    plan = make_plan(cfg, lm.registry, parallel, mesh)
    state = init_state(lm.init(torch.Generator().manual_seed(0)))
    return cfg, plan, state


def _bump(state: TrainState, idx: int) -> TrainState:
    flat = flatten_with_paths(state.params)
    name = sorted(flat)[idx % len(flat)]
    flat = dict(flat)
    flat[name] = flat[name] + (1.0 + idx)
    return TrainState(unflatten_from_paths(flat), state.exp_avg, state.exp_avg_sq, state.step)


# ---------------------------------------------------------------------------
# Disabled fast path


def test_disabled_span_is_shared_singleton():
    a = obs.span("anything", step=1)
    b = obs.span("something_else")
    assert a is b is obs.NULL_SPAN  # no allocation: one shared no-op
    with a as s:
        assert s.set(x=1) is s  # set() chainable and inert
    assert obs.attach(None) is obs.NULL_SPAN
    assert obs.current() is None


def test_disabled_never_touches_tracer(monkeypatch):
    calls = []
    monkeypatch.setattr(trace_mod.Tracer, "span", lambda self, *a, **k: calls.append(("span", a)))
    monkeypatch.setattr(trace_mod.Tracer, "emit_event",
                        lambda self, *a, **k: calls.append(("event", a)))
    with obs.span("x"):
        obs.add("counter.name", 3)
        obs.gauge("gauge.name", 1.5)
        obs.event("event.name", detail="ignored")
    assert calls == []


def test_disabled_timed_still_measures():
    with obs.timed("x") as sw:
        mid = sw.elapsed_s  # readable mid-flight
        assert mid >= 0
    assert sw.elapsed_s >= mid
    assert sw.set(anything=1) is sw


def test_disabled_fault_point_is_a_no_op():
    assert chaos.active_controller() is None
    chaos.fault_point("saver.shard", step=1)  # no controller: nothing happens


# ---------------------------------------------------------------------------
# Nesting and parent propagation


def test_span_nesting_parent_chain():
    with obs.enabled() as tracer:
        with obs.span("outer", step=7) as outer:
            with obs.span("inner") as inner:
                assert obs.current() is inner
            assert obs.current() is outer
            obs.event("marker", reason="test")
        assert obs.current() is None
    recs = {r["name"]: r for r in tracer.span_records()}
    assert recs["outer"]["parent_id"] is None
    assert recs["inner"]["parent_id"] == recs["outer"]["span_id"]
    assert recs["outer"]["attrs"] == {"step": 7}
    assert recs["inner"]["ts_us"] >= recs["outer"]["ts_us"]
    (ev,) = tracer.event_records()
    assert ev["parent_id"] == recs["outer"]["span_id"]


def test_explicit_handoff_across_threads():
    with obs.enabled() as tracer:
        with obs.span("submit"):
            token = obs.current()

            def with_handoff():
                with obs.attach(token), obs.span("worker.attached"):
                    pass

            def without_handoff():
                with obs.span("worker.orphan"):
                    pass

            with ThreadPoolExecutor(max_workers=1) as pool:
                pool.submit(with_handoff).result()
                pool.submit(without_handoff).result()
    recs = {r["name"]: r for r in tracer.span_records()}
    assert recs["worker.attached"]["parent_id"] == recs["submit"]["span_id"]
    assert recs["worker.orphan"]["parent_id"] is None
    assert recs["worker.attached"]["tid"] != recs["submit"]["tid"]


def test_engine_pool_shard_spans_parented(model_setup, tmp_path):
    """A parallel save's per-shard spans (engine worker pool) parent to the
    ckpt.save span that submitted them."""
    cfg, plan, state = model_setup
    with obs.enabled() as tracer:
        write_distributed(snapshot_state(state), plan, 10, tmp_path / "s10", workers=4)
    recs = tracer.span_records()
    (save_rec,) = [r for r in recs if r["name"] == "ckpt.save"]
    shards = [r for r in recs if r["name"] == "save.shard"]
    assert shards, "parallel save produced no save.shard spans"
    assert all(r["parent_id"] == save_rec["span_id"] for r in shards)
    assert {r["tid"] for r in shards} != {save_rec["tid"]}


def test_async_saver_job_parented_to_submit(model_setup, tmp_path):
    cfg, plan, state = model_setup
    with obs.enabled() as tracer:
        mgr = CheckpointManager(tmp_path / "ck", plan,
                                policy=CheckpointPolicy(async_save=True, save_interval=1))
        mgr.save(state, 10)
        mgr.wait()
        mgr.close()
    recs = tracer.span_records()
    by_id = {r["span_id"]: r for r in recs}
    (job,) = [r for r in recs if r["name"] == "save.async_job"]
    submit = by_id[job["parent_id"]]
    assert submit["name"] == "manager.save"
    assert job["tid"] != submit["tid"]
    (save_rec,) = [r for r in recs if r["name"] == "ckpt.save"]
    assert save_rec["parent_id"] == job["span_id"]


# ---------------------------------------------------------------------------
# Chrome export


def test_chrome_export_valid_and_consistent(model_setup, tmp_path):
    cfg, plan, state = model_setup
    with obs.enabled() as tracer:
        mgr = CheckpointManager(tmp_path / "ck", plan, policy=CheckpointPolicy(async_save=False))
        mgr.save(state, 10)
        mgr.restore("cpu", step=10)
        mgr.close()
        out = obs.write_chrome_trace(tmp_path / "trace.json", tracer)
    doc = json.loads(out.read_text())
    n = obs.validate_chrome_trace(doc)
    assert n >= 10
    assert doc["otherData"]["schema"] == "repro-trace/v1"
    assert doc["otherData"]["counters"].get("save.shards_written", 0) > 0
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"ckpt.save", "ckpt.restore", "ckpt.commit", "restore.plan", "restore.prefetch",
            "restore.materialize"} <= names
    tids = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    meta = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert tids <= meta
    # the reference's validator accepts the port's document too
    assert ref_obs.validate_chrome_trace(doc) == n


def test_validator_rejects_inconsistent_nesting():
    bad = {
        "traceEvents": [
            {"name": "parent", "ph": "X", "ts": 100, "dur": 10, "pid": 1,
             "tid": 1, "args": {"span_id": 1, "parent_id": None}},
            {"name": "child", "ph": "X", "ts": 50, "dur": 5, "pid": 1,
             "tid": 1, "args": {"span_id": 2, "parent_id": 1}},
        ]
    }
    with pytest.raises(AssertionError):
        obs.validate_chrome_trace(bad)


# ---------------------------------------------------------------------------
# Counters vs SaveResult on a known delta save


def test_delta_counters_match_save_result(model_setup, tmp_path):
    cfg, plan, state = model_setup
    with obs.enabled() as tracer:
        first = write_distributed(snapshot_state(state), plan, 10, tmp_path / "s10",
                                  save_mode="delta")
        assert first.mode == "full"  # no base yet: a rebase
        before = tracer.counters()
        result = write_distributed(
            snapshot_state(_bump(state, 0)), plan, 20, tmp_path / "s20",
            save_mode="delta", base=DistCheckpoint.open(tmp_path / "s10"),
        )
        after = tracer.counters()
    assert result.mode == "delta"
    assert result.shards_inherited > 0 and result.shards_written > 0
    delta = obs.diff_counters(after, before)
    assert delta.get("save.shards_written", 0) == result.shards_written
    assert delta.get("save.shards_inherited", 0) == result.shards_inherited
    assert delta.get("save.bytes_written", 0) == result.bytes_written
    assert delta.get("save.delta", 0) == 1
    assert delta.get("save.full", 0) == 0
    spans = [r for r in tracer.span_records()
             if r["name"] == "ckpt.save" and r["attrs"].get("step") == 20]
    assert spans[0]["attrs"]["shards_written"] == result.shards_written
    assert spans[0]["attrs"]["shards_inherited"] == result.shards_inherited


# ---------------------------------------------------------------------------
# Summary / timeline plumbing


def test_summary_and_timeline_ordering():
    with obs.enabled() as tracer:
        with obs.span("a"):
            obs.event("mid")
            with obs.span("b"):
                pass
        obs.add("some.counter", 2)
    line = tracer.summary()
    assert "a" in line and "some.counter" in line
    tl = tracer.timeline()
    assert [r["ts_us"] for r in tl] == sorted(r["ts_us"] for r in tl)
    assert {r["kind"] for r in tl} == {"span", "event"}


def test_enable_is_process_exclusive():
    t = obs.enable()
    try:
        with pytest.raises(RuntimeError):
            obs.enable()
        obs.disable(trace_mod.Tracer())  # someone else's tracer stays installed
        assert obs.active() is t
    finally:
        obs.disable(t)
    assert obs.active() is None


def test_fault_point_activation_is_process_exclusive():
    class Seen:
        def __init__(self):
            self.hits = []

        def on_point(self, name, ctx):
            self.hits.append((name, dict(ctx)))

    c = Seen()
    chaos.activate(c)
    try:
        with pytest.raises(RuntimeError):
            chaos.activate(Seen())
        chaos.fault_point("dist.pre_commit", step=3, name="p")
        assert c.hits == [("dist.pre_commit", {"step": 3, "name": "p"})]
    finally:
        chaos.deactivate(c)
    assert chaos.active_controller() is None


# ---------------------------------------------------------------------------
# Across packages: the same state saved by both counts the same content


def _specs():
    return {
        "w": T.uniform_param_spec("w", (8, 6), [T.DimSpec(("data",)), T.DimSpec(("model",))]),
        "u": T.uniform_param_spec("u", (6, 300), [T.DimSpec(("model",)), T.DimSpec()]),
        "b": T.uniform_param_spec("b", (4,), [T.DimSpec()]),
    }


def _ref_specs():
    return {
        "w": R.uniform_param_spec("w", (8, 6), [R.DimSpec(("data",)), R.DimSpec(("model",))]),
        "u": R.uniform_param_spec("u", (6, 300), [R.DimSpec(("model",)), R.DimSpec()]),
        "b": R.uniform_param_spec("b", (4,), [R.DimSpec()]),
    }


CONTENT_COUNTERS = ("save.bytes_written", "save.shards_written", "save.shards_inherited",
                    "save.full", "save.delta", "codec.encode_shards", "codec.encode_bytes_raw",
                    "codec.encode_bytes_coded")


@pytest.mark.parametrize("tag", ["raw", "int8:b256"])
@pytest.mark.parametrize("workers", [1, 4])
def test_save_counters_equal_reference(tmp_path, tag, workers):
    rng = np.random.default_rng(5)
    specs = _specs()
    snap = {n: {k: rng.normal(size=s.runtime_shape).astype(np.float32) for k in T.STATE_KINDS}
            for n, s in specs.items()}
    ref_snap = {n: {R.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snap.items()}
    mesh_d = {"data": 2, "model": 2}
    plan = ShardingPlan(mesh=T.MeshSpec.from_dict(mesh_d), param_specs=specs)
    rplan = RS.ShardingPlan(mesh=R.MeshSpec.from_dict(mesh_d), param_specs=_ref_specs())
    codec = CodecPolicy.moments(tag) if tag != "raw" else None
    rcodec = RefCodecPolicy.moments(tag) if tag != "raw" else None
    with obs.enabled() as tracer, ref_obs.enabled() as rtracer:
        res = write_distributed(snap, plan, 3, tmp_path / "port", workers=workers, codec=codec)
        ref_write(ref_snap, rplan, 3, tmp_path / "ref", workers=workers, codec=rcodec)
    got = {k: v for k, v in tracer.counters().items() if k in CONTENT_COUNTERS}
    want = {k: v for k, v in rtracer.counters().items() if k in CONTENT_COUNTERS}
    assert got == want
    assert got["save.bytes_written"] == res.bytes_written
    assert (got.get("codec.encode_shards", 0) > 0) == (tag != "raw")
    names = {r["name"] for r in tracer.span_records()}
    rnames = {r["name"] for r in rtracer.span_records()}
    assert names == rnames


# ---------------------------------------------------------------------------
# AST: the names each ported file emits are its reference file's


OBS_CALLS = {"span", "timed", "event", "add", "gauge"}

# Ported files, each against its reference file.
PAIRS = [
    "core/dist_ckpt.py", "core/codec.py", "core/engine.py", "core/convert.py",
    "ckpt/saver.py", "ckpt/restore.py", "ckpt/manager.py", "train/trainer.py",
    "launch/train.py", "launch/serve.py", "launch/dryrun.py",
    "hot/snapshot.py", "hot/drain.py", "hot/recovery.py", "hot/replicate.py",
    "elastic/planner.py", "elastic/resume.py",
    "serve/registry.py", "serve/peer.py", "serve/fleet.py",
    "chaos/schedule.py", "chaos/harness.py",
]

# (file, kind, name): names one side emits and the other does not, each
# with its reason.
EXCEPTIONS = {
    # The port's serve CLI plans its weights-only restore itself
    # (``restore_params``); the reference's goes through
    # ``CheckpointManager.restore``, whose ``restore.plan`` span is in
    # ckpt/manager.py.  The span splits a serve restore's wall.
    ("launch/serve.py", "span", "restore.plan"): "port only: the serve CLI plans its restore",
}


def _literal(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):  # f"save.{mode}" -> "save.{}"
        return "".join(v.value if isinstance(v, ast.Constant) else "{}" for v in node.values)
    return None


def _emitted(path: Path) -> set[tuple[str, str]]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "obs" and f.attr in OBS_CALLS:
            kind = f.attr
        elif isinstance(f, ast.Name) and f.id == "fault_point":
            kind = "fault_point"
        else:
            continue
        name = _literal(node.args[0])
        if name is not None:
            out.add((kind, name))
    return out


@pytest.mark.parametrize("rel", PAIRS)
def test_ported_file_emits_the_reference_names(rel):
    port, ref = _emitted(PORT / rel), _emitted(REF / rel)
    allowed = {(k, n) for (f, k, n) in EXCEPTIONS if f == rel}
    assert port - allowed == ref - allowed, (
        f"{rel}: port only {sorted(port - ref - allowed)}, "
        f"reference only {sorted(ref - port - allowed)}"
    )


def test_fault_point_sites_are_the_catalog_less_fanout():
    """With fan-out ported, the port's fault-point sites are the reference's
    whole catalog."""
    sites = {n for p in PORT.rglob("*.py") for k, n in _emitted(p) if k == "fault_point"}
    assert sites == set(ref_points.CATALOG)
    assert chaos.CATALOG == ref_points.CATALOG  # word for word


def _tables(path: Path) -> dict:
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = ast.literal_eval(node.value)
    return out


def test_catalog_tables_equal_the_reference():
    port, ref = _tables(PORT / "obs" / "catalog.py"), _tables(REF / "obs" / "catalog.py")
    assert set(port) == {"SPANS", "TIMED", "EVENTS", "COUNTERS"}
    assert port == ref


def test_every_emitted_name_is_registered():
    tables = _tables(PORT / "obs" / "catalog.py")
    registered = {"span": set(tables["SPANS"]), "timed": set(tables["TIMED"]),
                  "event": set(tables["EVENTS"]), "add": set(tables["COUNTERS"])}
    for path in PORT.rglob("*.py"):
        if path.parent.name == "obs":
            continue
        for kind, name in _emitted(path):
            if kind in registered and "{" not in name:
                assert name in registered[kind], f"{path.relative_to(PORT)}: {kind} {name!r}"


def test_handle_cache_counts_hits_misses_evictions():
    from repro_torch.core.engine import HandleCache

    cache = HandleCache(capacity=1, metric="engine.atom")
    with obs.enabled() as tracer:
        cache.get("a", lambda: np.zeros(4))
        cache.get("a", lambda: np.zeros(4))
        cache.get("b", lambda: np.zeros(4))
    c = tracer.counters()
    assert (c["engine.atom.miss"], c["engine.atom.hit"], c["engine.atom.eviction"]) == (2, 1, 1)
    assert (cache.misses, cache.hits, cache.evictions) == (2, 1, 1)


def test_restore_stats_equal_counters(model_setup, tmp_path):
    from repro_torch.ckpt.restore import RestoreStats, state_from_source

    cfg, plan, state = model_setup
    write_distributed(snapshot_state(state), plan, 1, tmp_path / "s1", workers=1)
    stats = RestoreStats()
    with obs.enabled() as tracer:
        state_from_source(DistCheckpoint.open(tmp_path / "s1"), plan, "cpu", stats=stats)
    c = tracer.counters()
    assert stats.arrays == c["restore.arrays"] == 3 * len(plan.param_specs)
    assert stats.bytes_read == c["restore.bytes_read"] > 0
    spans = [r["name"] for r in tracer.span_records()]
    assert spans.count("restore.prefetch") == spans.count("restore.materialize") == 3


def test_thread_safe_counters():
    with obs.enabled() as tracer:
        def bump():
            for _ in range(1000):
                obs.add("x")

        threads = [threading.Thread(target=bump) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert tracer.counters()["x"] == 4000
