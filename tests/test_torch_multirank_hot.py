"""The hot tier, delta saves and fan-out of the port under a multi-rank
group, on the CPU, held against one process and the JAX package.

Ranks are processes of a gloo group (``run_world`` of
``tests/test_torch_multirank.py``: spawned, a ``file://`` store in
``tmp_path``, joined with a timeout and killed after it), on reduced
smollm-360m in fp32.  Two worlds run once per module:

* 4 ranks under data=2,model=2, ``CheckpointPolicy(codec="int8:b256",
  hot_interval=1, disk_interval=2, hot_replication=1, save_mode="delta",
  full_interval=2, keep_last=1)`` with a registry on rank 0: two steps
  (step 2 drained full), the same state saved as steps 3-4 (step 4 a delta
  that inherits every shard) and 5-6 (a rebase), then with one parameter
  changed as steps 7-8 (a delta that writes only that parameter's shards);
  then rank 1's memory lost (HOT_DIRECT), a HOT_RESHARD to data=1,model=4,
  the buddy group {0, 1} lost (the disk ladder), and the group destroyed
  with 3 survivors (refused);
* 2 ranks under data=2,model=1: rank 1's process exits after two captures,
  and rank 0 recovers alone under data=1,model=1 from its own memory, then
  takes 2 steps.

The reference is imported lazily, so the spawned ranks load no JAX.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.saver import snapshot_state  # noqa: E402
from repro_torch.core.dist_ckpt import DistCheckpoint  # noqa: E402
from repro_torch.core.layout import MeshSpec, slice_shard  # noqa: E402
from repro_torch.core.patterns import StateKind  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.hot import HotTier, persist_snapshot, state_from_hot  # noqa: E402
from repro_torch.hot.replicate import mirror_targets  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402
from repro_torch.serve import PublicationRegistry  # noqa: E402
from repro_torch.train.optimizer import TrainState, init_state  # noqa: E402
from repro_torch.train.trainer import gather_state, shard_state  # noqa: E402
from test_torch_multirank import (  # noqa: E402
    ARCH, B, FIELDS, REL, S, _flat_state, _plan, _ref, _reference_weights, _single_steps,
    _trainer, parallel_for, run_world,
)

MESH22 = {"data": 2, "model": 2}
MESH21 = {"data": 2, "model": 1}
MESH14 = {"data": 1, "model": 4}
MESH11 = {"data": 1, "model": 1}
POLICY = dict(codec="int8:b256", hot_interval=1, disk_interval=2, hot_replication=1,
              save_mode="delta", full_interval=2, keep_last=1)
CHANGED = "final_norm"  # the parameter steps 7-8 change
MODULE = "test_torch_multirank_hot"


def _state(flat: dict, step: int) -> TrainState:
    return TrainState(step=step, **{f: unflatten_from_paths(dict(flat[f])) for f, _ in FIELDS})


def _index(hs) -> dict:
    """A snapshot's index as this rank sees it: (name, kind, owner) ->
    holders, digest, size and the bytes it holds (None: not held)."""
    out = {}
    for (name, kv, owner), f in sorted(hs._frags.items()):
        data = None if f.data is None else (
            f.data.clone() if isinstance(f.data, torch.Tensor) else torch.from_numpy(
                np.array(f.data)))
        out[(name, kv, owner)] = (f.holders, f.digest, f.nbytes, data)
    return out


def _result(r) -> dict:
    return {"step": r.step, "mode": r.mode, "written": r.shards_written,
            "inherited": r.shards_inherited, "bytes": r.bytes_written}


class _OpenSpy:
    """Counts the checkpoint files a block opens."""

    def __enter__(self):
        self.n = 0
        self._real = DistCheckpoint.read_shard

        def spy(ck, *a, **kw):
            self.n += 1
            return self._real(ck, *a, **kw)

        DistCheckpoint.read_shard = spy
        return self

    def __exit__(self, *exc):
        DistCheckpoint.read_shard = self._real


# ---------------------------------------------------------------------------
# the ranks


def _keep(out: Path, mgr, step: int) -> None:
    """Rank 0 copies a committed step aside before GC (keep_last=1) takes it."""
    if mgr.rank == 0:
        shutil.copytree(mgr.step_dir(step), out / "kept" / mgr.step_dir(step).name)


def hot_world4(rank, out, weights):
    from repro_torch.elastic import ElasticEvent, hot_recover
    from repro_torch.serve import FleetReplica

    world, res = dist.group.WORLD, {}
    try:  # every rank gets a registry: the ranks but 0 are refused, on every rank
        CheckpointManager(out / "refused", _plan(MESH22), group=world,
                          policy=CheckpointPolicy(registry=PublicationRegistry()))
        res["refused"] = "created"
    except ValueError as e:
        res["refused"] = str(e)
    reg = PublicationRegistry() if rank == 0 else None
    t = _trainer(MESH22, world, ckpt_dir=out / "hot22",
                 policy=CheckpointPolicy(**POLICY, registry=reg))
    mgr = t.manager
    state = shard_state(init_state(params_from_reference(weights, t.lm, "cpu")), t.plan, rank)
    with obs.enabled() as tracer:
        state, _ = t.run(state, 0, 2)  # captures 1 and 2; step 2 drained full and published
    _keep(out, mgr, 2)
    spans = tracer.span_records()
    cap = [r for r in spans if r["name"] == "hot.capture"][-1]
    res["index2"], res["log2"] = _index(mgr.hot.latest()), dict(cap["attrs"])
    # the device->host copy: the save.stage span beside the capture
    res["d2h2"] = [r["name"] for r in spans if r["parent_id"] == cap["parent_id"]]
    res["results2"] = [_result(r) for r in t.save_results]
    full = _flat_state(gather_state(state, t.plan, world))
    res["gathered2"] = full if rank == 0 else None
    res["local2"] = _flat_state(state)
    mgr.save(state, 3)
    mgr.save(state, 4)  # a delta of the unchanged state
    res["results4"] = [_result(r) for r in mgr.wait()]
    _keep(out, mgr, 4)
    mgr.save(state, 5)
    mgr.save(state, 6)  # a rebase
    res["results6"] = [_result(r) for r in mgr.wait()]
    res["steps6"] = mgr.steps()  # the published step 4 outlives keep_last=1
    _keep(out, mgr, 6)
    flat = flatten_with_paths(state.params)
    flat[CHANGED] = flat[CHANGED] * 1.5
    changed = TrainState(unflatten_from_paths(flat), state.exp_avg, state.exp_avg_sq, state.step)
    mgr.save(changed, 7)
    mgr.save(changed, 8)  # a delta with one parameter changed
    res["results8"] = [_result(r) for r in mgr.wait()]
    _keep(out, mgr, 8)
    res["index8"] = _index(mgr.hot.latest())
    res["local8"] = _flat_state(changed)
    full = _flat_state(gather_state(changed, t.plan, world))
    res["gathered8"] = full if rank == 0 else None
    # (f) fan-out: rank 0 publishes, every rank gets its publication
    pub = mgr.publish()
    res["publish"] = (pub.step, pub.seq)
    if rank == 0:
        replica = FleetReplica("r0", reg, _plan(MESH11), device="cpu")
        replica.sync()
        res["replica"] = {n: v.clone() for n, v in replica.flat_params().items()}
        res["replica_step"] = replica.step
    # (c) rank 1's memory lost: HOT_DIRECT, rank 1's bytes from its buddy
    with _OpenSpy() as spy:
        st, info = hot_recover(mgr, ElasticEvent(3, "failure", (1,)), "cpu")
    rs = info.restore_stats
    res["c"] = {"mode": info.mode.value, "step": info.step, "state": _flat_state(st),
                "opened": spy.n, "fetched": rs.fetched_bytes, "sent": rs.sent_bytes}
    # (d) HOT_RESHARD to data=1,model=4 on the same ranks
    with _OpenSpy() as spy:
        st, info = mgr.restore_latest("cpu", target_plan=_plan(MESH14))
    rs = info.restore_stats
    res["d"] = {"mode": info.mode.value, "state": _flat_state(st), "opened": spy.n,
                "fetched": rs.fetched_bytes, "sent": rs.sent_bytes}
    # (e) the buddy group {0, 1} lost: no hot plan, the disk ladder together
    st, info = hot_recover(mgr, ElasticEvent(2, "failure", (0,)), "cpu")
    res["e"] = {"mode": info.mode.value, "step": info.step,
                "params": _flat_state(st)["params"]}
    # three survivors of a real death may not re-form a group
    dist.destroy_process_group()
    try:
        hot_recover(mgr, ElasticEvent(3, "failure", (3,)), "cpu")
        res["survivors"] = "recovered"
    except (NotImplementedError, ValueError) as e:
        res["survivors"] = f"{type(e).__name__}: {e}"
    mgr.close()
    return res


def hot_world2(rank, out, weights):
    from repro_torch.elastic import ElasticEvent, hot_recover, rebuild_on

    world = dist.group.WORLD
    t = _trainer(MESH21, world, ckpt_dir=out / "hot21",
                 policy=CheckpointPolicy(hot_interval=1, save_interval=100, async_save=False))
    state = shard_state(init_state(params_from_reference(weights, t.lm, "cpu")), t.plan, rank)
    state, _ = t.run(state, 0, 2)  # captures 1 and 2, nothing on disk
    full = _flat_state(gather_state(state, t.plan, world))
    # per-rank delta saves without the hot tier, through the async writer:
    # step 2 full, step 3 a delta with one parameter changed
    mgr = CheckpointManager(out / "delta21", t.plan, group=world,
                            config_fingerprint=t.manager.config_fingerprint,
                            policy=CheckpointPolicy(codec="int8:b256", save_mode="delta",
                                                    full_interval=2))
    mgr.save(state, 2)
    flat = flatten_with_paths(state.params)
    flat[CHANGED] = flat[CHANGED] * 1.5
    mgr.save(TrainState(unflatten_from_paths(flat), state.exp_avg, state.exp_avg_sq, 2), 3)
    saves = [_result(r) for r in mgr.wait()]
    mgr.close()
    dist.barrier()
    if rank == 1:  # this process dies
        t.manager.close()
        return {"exited": True, "saves": saves}
    dist.destroy_process_group()
    event = ElasticEvent(1, "failure", (1,))
    mesh11 = MeshSpec.from_dict(MESH11)
    solo = rebuild_on(event, TC.reduced(TC.get_config(ARCH)), parallel_for(mesh11),
                      TC.TrainConfig(), batch_size=B, seq_len=S, ckpt_dir=str(out / "solo"),
                      device="cpu", hbm_budget=1e12)
    with _OpenSpy() as spy:
        st, info = hot_recover(t.manager, event, "cpu", target_plan=solo.plan)
    res = {"mode": info.mode.value, "step": info.step, "state": _flat_state(st),
           "gathered": full, "opened": spy.n, "mesh": dict(solo.mesh.axes), "saves": saves}
    _, hist = solo.run(st, 2, 2)
    res["hist"] = [(h["loss"], h["grad_norm"]) for h in hist]
    t.manager.close()
    solo.manager.close()
    return res


# ---------------------------------------------------------------------------
# fixtures


@pytest.fixture(scope="module")
def weights():
    return _reference_weights(ARCH)


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("hot_worlds")
    np.savez(out / "weights.npz", **weights)
    w4 = run_world(out, 4, "hot_world4", module=MODULE)
    w2 = run_world(out, 2, "hot_world2", module=MODULE)
    return out, w4, w2


def _snap(flat: dict) -> dict:
    return snapshot_state(_state(flat, 0))


def _one_capture(flat: dict, plan, step: int):
    """A one-process capture of a gathered state on the same plan."""
    tier = HotTier(replication=1, save_mode="dedup")
    return tier.capture(_snap(flat), plan, step, config_fingerprint=_fingerprint())


def _fingerprint(mesh_d=MESH22) -> dict:
    t = _trainer(mesh_d)
    return {"model": t.cfg.fingerprint(), "parallel": t.parallel.fingerprint()}


# ---------------------------------------------------------------------------
# (a) holdings


def test_each_rank_holds_its_holders_fragments(worlds):
    _, w4, _ = worlds
    plan = _plan(MESH22)
    one, stats = _one_capture(w4[0]["gathered2"], plan, 2)
    want = {k: (f.holders, f.digest, f.nbytes, f.data) for k, f in
            ((k, one._frags[k]) for k in sorted(one._frags))}
    mirrored = 0
    for r, res in enumerate(w4):
        idx = res["index2"]
        assert set(idx) == set(want), r
        for key, (holders, digest, nbytes, data) in idx.items():
            wh, wd, wn, wdata = want[key]
            assert (holders, digest, nbytes) == (wh, wd, wn), (r, key)
            assert (data is not None) == (r in holders), (r, key, holders)
            if data is not None:
                exp = wdata if isinstance(wdata, torch.Tensor) else torch.from_numpy(wdata)
                assert torch.equal(data.reshape(-1).view(torch.uint8),
                                   exp.reshape(-1).view(torch.uint8)), (r, key)
    for (name, kv, owner), (holders, _, nbytes, _) in want.items():
        spec = plan.param_specs[name]
        mirrored += nbytes * len(mirror_targets(spec.layout_for(StateKind(kv), plan.mesh),
                                                owner, holders,
                                                natural_replication=not spec.average))
    logs = [res["log2"] for res in w4]
    assert all(log["step"] == 2 for log in logs)
    for res in w4:
        names = res["d2h2"]
        assert names.count("save.stage") == names.count("hot.capture") == 1, names
        assert names.index("save.stage") < names.index("hot.capture"), names
    for field in ("fragments", "natural_fragments", "stored_bytes", "resident_bytes",
                  "mirrored_bytes"):
        assert sum(log[field] for log in logs) == getattr(stats, field), field
    # what went over the group is what the mirrors hold
    assert sum(log["received_bytes"] for log in logs) == stats.mirrored_bytes == mirrored > 0
    assert sum(log["sent_bytes"] for log in logs) == stats.mirrored_bytes


# ---------------------------------------------------------------------------
# (b) drained saves


def _reference_save(flat: dict, step: int, root: Path, base=None, mesh_d=MESH22):
    repro = _ref()
    from repro.ckpt.saver import write_distributed as ref_write
    from repro.core.codec import CodecPolicy
    from repro.models import build_model as ref_build

    rc = repro.configs
    rmesh = repro.core.MeshSpec.from_dict(mesh_d)
    rpar = rc.ParallelismConfig(data_axes=("data",), compute_dtype="float32")
    rcfg = rc.reduced(rc.get_config(ARCH))
    rplan = repro.dist.sharding.make_plan(
        rcfg, ref_build(rcfg, vocab_multiple=repro.dist.sharding.vocab_multiple(rpar, rmesh)
                        ).registry, rpar, rmesh)
    snap = {n: {repro.core.StateKind(k.value): v for k, v in kinds.items()}
            for n, kinds in _snap(flat).items()}
    kw = {} if base is None else {"save_mode": "delta",
                                  "base": repro.core.DistCheckpoint.open(base)}
    return ref_write(snap, rplan, step, root, workers=1,
                     config_fingerprint=_fingerprint(mesh_d),
                     codec=CodecPolicy.moments("int8:b256"), **kw)


DRAINS = [(2, "gathered2", None), (4, "gathered2", 2), (6, "gathered2", None),
          (8, "gathered8", 6)]


@pytest.mark.parametrize("step,state,base", DRAINS, ids=[f"step{d[0]}" for d in DRAINS])
def test_drained_steps_are_the_reference_save_of_the_gathered_state(worlds, tmp_path, step,
                                                                    state, base):
    out, w4, _ = worlds
    kept = out / "kept"
    ref = tmp_path / "ref"
    for s, st, b in DRAINS:  # the reference's chain up to this step, in its own root
        _reference_save(w4[0][st], s, ref / f"step_{s:08d}",
                        None if b is None else ref / f"step_{b:08d}")
        if s == step:
            break
    rj = _same_checkpoint(kept / f"step_{step:08d}", ref / f"step_{step:08d}")
    results = [r for res in w4 for r in res[f"results{step}"] if r["step"] == step]
    assert len(results) == 4  # one part a rank
    total = len(rj["shard_digests"])
    assert {r["mode"] for r in results} == {"full" if base is None else "delta"}
    written = sum(r["written"] for r in results)
    inherited = sum(r["inherited"] for r in results)
    assert written + inherited == total
    if step == 4:  # the unchanged state inherits every shard
        assert written == 0 and rj["base_step"] == 2
    elif step == 8:  # only the changed parameter's shards are written
        assert written == len([k for k in rj["shard_digests"]
                               if k.split("/", 1)[1] == f"{CHANGED}@fp32"]) > 0
        assert set(rj["shard_sources"]) == {k for k in rj["shard_digests"]
                                            if not k.endswith(f"/{CHANGED}@fp32")}
    else:
        assert inherited == 0


def _same_checkpoint(port_root: Path, ref_root: Path) -> dict:
    """The port's committed step against the reference's, byte for byte
    (the manifest but ``created_at``); returns the manifest."""
    repro = _ref()
    pc, rc = repro.core.DistCheckpoint.open(port_root), repro.core.DistCheckpoint.open(ref_root)
    assert pc.is_committed
    pj, rj = pc.manifest.to_json(), rc.manifest.to_json()
    pj.pop("created_at"), rj.pop("created_at")
    assert pj == rj
    assert pc.validate() == []  # the reference recomputes every digest
    files = sorted(p.relative_to(port_root) for p in port_root.rglob("*.npy"))
    assert files == sorted(p.relative_to(ref_root) for p in ref_root.rglob("*.npy"))
    for f in files:
        assert (port_root / f).read_bytes() == (ref_root / f).read_bytes(), f
    return rj


def test_per_rank_delta_save_is_the_reference_delta(worlds, tmp_path):
    """Without the hot tier, through the async writer: each of 2 ranks diffs
    its own shards against the base rank 0 resolved; the step-3 delta (one
    parameter changed) is the reference's delta of the gathered state."""
    out, _, w2 = worlds
    full = w2[0]["gathered"]
    changed = {f: dict(full[f]) for f, _ in FIELDS}
    changed["params"][CHANGED] = full["params"][CHANGED] * 1.5
    ref = tmp_path / "ref"
    _reference_save(full, 2, ref / "step_00000002", mesh_d=MESH21)
    _reference_save(changed, 3, ref / "step_00000003", ref / "step_00000002", mesh_d=MESH21)
    for step in (2, 3):
        rj = _same_checkpoint(out / "delta21" / f"step_{step:08d}", ref / f"step_{step:08d}")
    assert rj["base_step"] == 2
    for r in w2:
        assert [(x["step"], x["mode"]) for x in r["saves"]] == [(2, "full"), (3, "delta")]
    written = sum(r["saves"][1]["written"] for r in w2)
    assert written == len([k for k in rj["shard_digests"] if k.endswith(f"/{CHANGED}@fp32")]) > 0
    assert written + sum(r["saves"][1]["inherited"] for r in w2) == len(rj["shard_digests"])


def test_gc_keeps_the_published_step(worlds):
    """keep_last=1: after step 6 commits, step 4 (published when step 6 was
    collected against) and its base step 2 stay."""
    _, w4, _ = worlds
    assert all(res["steps6"] == [2, 4, 6] for res in w4)


# ---------------------------------------------------------------------------
# (c)-(e) recovery


def test_hot_direct_after_losing_rank_1(worlds):
    _, w4, _ = worlds
    for r, res in enumerate(w4):
        c = res["c"]
        assert (c["mode"], c["step"], c["opened"]) == ("hot_direct", 8, 0), r
        for field, _ in FIELDS:
            for name, got in c["state"][field].items():
                want = res["local8"][field][name]
                assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), (r, name)
    own = [sum(t.numel() * t.element_size() for f, _ in FIELDS
               for t in res["local8"][f].values()) for res in w4]
    assert w4[1]["c"]["fetched"] == own[1] > 0  # rank 1 holds nothing: all from its buddy
    assert [res["c"]["fetched"] for i, res in enumerate(w4) if i != 1] == [0, 0, 0]
    assert sum(res["c"]["sent"] for res in w4) == own[1]


def test_hot_reshard_to_another_layout(worlds):
    _, w4, _ = worlds
    one, _ = _one_capture(w4[0]["gathered8"], _plan(MESH22), 8)
    plan = _plan(MESH14)
    full = _flat_state(state_from_hot(one, plan, "cpu"))
    for r, res in enumerate(w4):
        d = res["d"]
        assert (d["mode"], d["opened"]) == ("hot_reshard", 0), r
        for field, kind in FIELDS:
            for name, got in d["state"][field].items():
                layout = plan.param_specs[name].layout_for(kind, plan.mesh)
                assert torch.equal(got, slice_shard(full[field][name], layout, r)), (r, name)
    assert sum(res["d"]["fetched"] for res in w4) == sum(res["d"]["sent"] for res in w4) > 0


def test_losing_a_buddy_group_falls_through_to_disk_together(worlds):
    _, w4, _ = worlds
    for r, res in enumerate(w4):
        e = res["e"]
        assert (e["mode"], e["step"]) == ("direct", 8), r
        for name, got in e["params"].items():  # raw weights: the state that was saved
            assert torch.equal(got, res["local8"]["params"][name]), (r, name)


def test_a_lone_survivor_recovers_from_its_own_memory(worlds, weights):
    _, _, w2 = worlds
    assert w2[1]["exited"]
    res = w2[0]
    assert (res["mode"], res["step"], res["opened"]) == ("hot_reshard", 2, 0)
    assert res["mesh"] == MESH11
    for field, _ in FIELDS:
        for name, got in res["state"][field].items():
            assert torch.equal(got, res["gathered"][field][name]), (field, name)
    _, hist = _single_steps(None, state=_state(res["gathered"], 2), start=2, n=2)
    for (loss, gn), (l1, g1) in zip(res["hist"], hist, strict=True):
        assert abs(loss - l1) <= REL * abs(l1) and abs(gn - g1) <= REL * abs(g1)


# ---------------------------------------------------------------------------
# (f) fan-out and what stays refused


def test_rank_0_publishes_for_the_group(worlds):
    out, w4, _ = worlds
    assert len({res["publish"] for res in w4}) == 1 and w4[0]["publish"][0] == 8
    assert w4[0]["replica_step"] == 8
    mgr = CheckpointManager(out / "kept", _plan(MESH11))
    state, info = mgr.restore("cpu", step=8)
    assert info.mode.value == "reshard_stream"
    want = flatten_with_paths(state.params)
    assert set(w4[0]["replica"]) == set(want)
    for name, got in w4[0]["replica"].items():
        assert torch.equal(got, want[name]), name


def test_a_registry_off_rank_0_is_refused(worlds):
    _, w4, _ = worlds
    assert all(res["refused"] == "a publication registry belongs to group rank 0, which "
               "commits and publishes; ranks [1, 2, 3] were given one" for res in w4)


def test_two_or_more_survivors_are_refused(worlds):
    _, w4, _ = worlds
    for res in w4[:3]:
        assert res["survivors"].startswith("NotImplementedError: 3 ranks survive ([0, 1, 2])")
    assert w4[3]["survivors"].startswith("ValueError: rank 3 is among the failed ranks")


# ---------------------------------------------------------------------------
# the launcher


CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--mesh", "data=2,model=1",
       "--steps", "4", "--batch", "4", "--seq", "32", "--save-interval", "2",
       "--hot-interval", "1", "--save-mode", "delta", "--full-interval", "2", "--log-json",
       "--compute-dtype", "float32"]  # as the in-process worlds: agreement to rounding


def _cli(args: list[str]) -> dict[int, float]:
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return {r["step"]: r["loss"] for r in map(json.loads, out.stdout.splitlines())
            if r.get("event") == "step"}


def test_cli_runs_hot_delta_on_two_ranks(tmp_path):
    """``--host-devices 2`` with ``--hot-interval`` and ``--save-mode
    delta`` runs in fp32; its losses are a one-process run's within 1e-5,
    its commits are that run's (the same steps, modes, bases and inherited
    sets) and hold its state within 1e-5 of each tensor's scale, and each
    one's digests are a one-process drain's of the state it holds.  The
    digests cannot be the one-process run's themselves: the gradient's
    all-reduce over two ranks rounds otherwise than one device's sum."""
    two = _cli([*CLI, "--host-devices", "2", "--ckpt-dir", str(tmp_path / "two")])
    one = _cli([*CLI, "--ckpt-dir", str(tmp_path / "one")])
    assert sorted(two) == sorted(one) == [1, 2, 3, 4]
    assert all(abs(two[s] - one[s]) <= REL * abs(one[s]) for s in one), (two, one)
    plan = _plan(MESH21)
    base = None
    for step in (2, 4):
        name = f"step_{step:08d}"
        got = DistCheckpoint.open(tmp_path / "two" / name).manifest
        ref = DistCheckpoint.open(tmp_path / "one" / name).manifest
        assert (got.save_mode, got.base_step) == (ref.save_mode, ref.base_step)
        assert set(got.shard_digests) == set(ref.shard_digests)
        assert set(got.shard_sources) == set(ref.shard_sources)
        mgr = CheckpointManager(tmp_path / "two", plan)
        state, info = mgr.restore("cpu", step=step)
        assert info.mode.value == "direct"
        solo, _ = CheckpointManager(tmp_path / "one", plan).restore("cpu", step=step)
        for field, _ in FIELDS:
            want = flatten_with_paths(getattr(solo, field))
            for name, x in flatten_with_paths(getattr(state, field)).items():
                w = want[name]
                assert torch.allclose(x, w, rtol=REL, atol=REL * float(w.abs().max())), \
                    (step, field, name)
        hs, _ = HotTier(replication=1).capture(snapshot_state(state), plan, step)
        root = tmp_path / "again" / name
        persist_snapshot(hs, root, base=base, save_mode="delta" if base else None)
        again = DistCheckpoint.open(root).manifest
        assert again.shard_digests == got.shard_digests
        assert again.shard_sources == got.shard_sources and again.base_step == got.base_step
        base = DistCheckpoint.open(root)


# ---------------------------------------------------------------------------
# a group of 1 gives what no group gives


@pytest.fixture
def one_rank_group(tmp_path):
    assert not dist.is_initialized(), "a test left the default group initialized"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    yield dist.group.WORLD
    if dist.is_initialized():
        dist.destroy_process_group()


ONE_RANK_POLICIES = {
    "hot": dict(hot_interval=1, save_interval=2, codec="int8:b256"),
    "delta": dict(save_interval=1, save_mode="delta", full_interval=2),
    # synchronous: an async save is published by whichever later call sees
    # its commit, so the publications would follow the writer's timing
    "publish": dict(save_interval=1, keep_last=1, async_save=False),
}


@pytest.mark.parametrize("which", list(ONE_RANK_POLICIES))
def test_one_rank_group_gives_what_no_group_gives(one_rank_group, tmp_path, which):
    """Under each of the three policies a group of 1 over a mesh of 1 gives
    the same manifests, digests, snapshots and publications as no group."""
    runs = []
    for label, group in (("a", one_rank_group), ("b", None)):
        reg = PublicationRegistry() if which == "publish" else None
        sub = reg.subscribe("watch") if reg is not None else None
        t = _trainer(MESH11, group, ckpt_dir=tmp_path / label,
                     policy=CheckpointPolicy(**ONE_RANK_POLICIES[which], registry=reg))
        _, hist = t.run(t.init_state(), 0, 4)
        steps = t.manager.steps()
        manifests = {}
        for s in steps:
            m = DistCheckpoint.open(t.manager.step_dir(s)).manifest.to_json()
            m.pop("created_at")
            manifests[s] = m
        snaps = [] if t.manager.hot is None else [
            (hs.step, {k: (f.holders, f.digest, f.nbytes) for k, f in hs._frags.items()})
            for hs in t.manager.hot.snapshots()]
        pubs = [] if sub is None else [(p.seq, p.step, p.kind, sorted(p.changed))
                                       for p in sub.poll()]
        runs.append(([h["loss"] for h in hist], steps, manifests, snaps, pubs))
        t.manager.close()
    a, b = runs
    assert a == b
    assert a[1] and (a[3] or which != "hot") and (a[4] or which != "publish")
    if which == "delta":
        assert any(m["save_mode"] == "delta" for m in a[2].values())
