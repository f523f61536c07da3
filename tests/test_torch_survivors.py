"""Survivors of real process deaths re-form a group and recover, on the CPU,
held against one process and the JAX package.

Each world is 4 gloo ranks (``run_world`` of ``tests/test_torch_multirank.py``:
spawned, a ``file://`` store in ``tmp_path``, joined with a timeout and
killed after it) of reduced smollm-360m in fp32 under data=2,model=2, with
``CheckpointPolicy(codec="int8:b256", hot_interval=1, disk_interval=2,
hot_replication=1)`` and a registry on rank 0.  They train 2 steps (each
captured; step 2 drained to disk and published), then the ranks of
``failed`` exit.  The survivors destroy the default group, re-form one
(``reform_group``), rebuild a trainer on the mesh ``propose_mesh`` gives
them (data=2,model=1 under a budget of 1e12 bytes) and recover through
``hot_recover`` with their group, then take 2 steps whose step 4 the
rebuilt manager saves ``int8:b256`` and publishes.  The worlds:

* ``spare``: rank 3 lost; 3 survivors, a mesh of 2 and one spare (old rank
  2, the only holder left of rank 3's mirrored moments and of its own);
* ``pair``: ranks 1 and 2 lost, one of each buddy group ({0, 1}, {2, 3})
  and of each pair of data replicas ({0, 2}, {1, 3}), whose model shard
  no mirror holds;
* ``rank0``: ranks 0 and 3 lost; old rank 1 is the new rank 0, which
  commits and publishes (the old manager's registry died with rank 0);
* ``buddies``: the buddy group {0, 1} lost; no snapshot covers the state,
  and the survivors take the disk ladder together (RESHARD_STREAM).

Held against: the reference's ``repro.hot`` in one process (the gathered
step-2 state captured under the reference's plan, the same ranks failed,
``plan_hot_recovery`` and ``state_from_hot`` onto the plan of the
reference's ``propose_mesh``): the mode, and each compute rank's state bit
for bit ``slice_shard`` of the reference's; for ``buddies`` one process's
disk restore of the same step.  The 2 steps within 1e-5 relative of one
process stepping from the same state; the step-4 save byte for byte the
reference's ``write_distributed`` of the gathered state.  The reference is
imported lazily, so the spawned ranks load no JAX.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.core.layout import MeshSpec, slice_shard  # noqa: E402
from repro_torch.models import params_from_reference  # noqa: E402
from repro_torch.serve import PublicationRegistry  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.trainer import gather_state, shard_state  # noqa: E402
from test_torch_multirank import (  # noqa: E402
    ARCH, B, FIELDS, REL, S, _flat_state, _plan, _ref, _reference_weights, _single_steps,
    _trainer, parallel_for, run_world,
)
from test_torch_multirank_hot import (  # noqa: E402
    _OpenSpy, _reference_save, _same_checkpoint, _state,
)

MESH22 = {"data": 2, "model": 2}
MESH21 = {"data": 2, "model": 1}  # what propose_mesh gives 2 or 3 survivors
BUDGET = 1e12  # bytes per device, the same for both packages' propose_mesh
POLICY = dict(codec="int8:b256", hot_interval=1, disk_interval=2, hot_replication=1)
WORLDS = {"spare": (3,), "pair": (1, 2), "rank0": (0, 3), "buddies": (0, 1)}
MODULE = "test_torch_survivors"


# ---------------------------------------------------------------------------
# the ranks


def _survive(rank, out, weights, tag: str):
    from repro_torch.elastic import (
        ElasticEvent, hot_recover, rebuild_on, reform_group, survivor_plan,
    )

    failed = WORLDS[tag]
    world = dist.group.WORLD
    t = _trainer(MESH22, world, ckpt_dir=out / f"old_{tag}",
                 policy=CheckpointPolicy(**POLICY,
                                         registry=PublicationRegistry() if rank == 0 else None))
    state = shard_state(init_state(params_from_reference(weights, t.lm, "cpu")), t.plan, rank)
    state, _ = t.run(state, 0, 2)  # captures 1 and 2; step 2 drained and published
    full = _flat_state(gather_state(state, t.plan, world))
    res = {"gathered2": full if rank == 0 else None, "exited": rank in failed}
    dist.barrier()
    if rank in failed:  # this process dies
        t.manager.close()
        return res
    event = ElasticEvent(4 - len(failed), "failure", failed)
    group = reform_group(event, rank, 4, out / f"rendezvous_{tag}", timeout=240)
    cfg, par = TC.reduced(TC.get_config(ARCH)), parallel_for(MeshSpec.from_dict(MESH22))
    new_rank = dist.get_rank(group)
    reg = PublicationRegistry() if new_rank == 0 else None
    sub = reg.subscribe("watch") if reg is not None else None
    new = rebuild_on(event, cfg, par, TC.TrainConfig(), batch_size=B, seq_len=S,
                     ckpt_dir=str(out / f"new_{tag}"), device="cpu", hbm_budget=BUDGET,
                     group=group, policy=CheckpointPolicy(codec="int8:b256", save_interval=2,
                                                          async_save=False, registry=reg))
    plan = new.plan if new is not None else survivor_plan(event, cfg, par, device="cpu",
                                                          hbm_budget=BUDGET)
    with _OpenSpy() as spy:
        st, info = hot_recover(t.manager, event, "cpu", target_plan=plan, group=group)
    rs = info.restore_stats
    res.update(new_rank=new_rank, mode=info.mode.value, step=info.step, opened=spy.n,
               fetched=rs.fetched_bytes, sent=rs.sent_bytes, mesh=dict(plan.mesh.axes),
               publishing=t.manager._publishing, spare=new is None,
               state=None if st is None else _flat_state(st))
    t.manager.close()
    if new is None:  # a spare: its fragments went to the compute ranks
        return res
    st, hist = new.run(st, 2, 2)  # steps 3 and 4; step 4 saved and published
    res["hist"] = [(h["loss"], h["grad_norm"]) for h in hist]
    full4 = _flat_state(gather_state(st, new.plan, new.ranks.group))
    res["gathered4"] = full4 if new_rank == 0 else None
    res["published"] = None if sub is None else [p.step for p in sub.poll()]
    res["steps"] = new.manager.steps()
    new.manager.close()
    return res


def survivors_spare(rank, out, weights):
    return _survive(rank, out, weights, "spare")


def survivors_pair(rank, out, weights):
    return _survive(rank, out, weights, "pair")


def survivors_rank0(rank, out, weights):
    return _survive(rank, out, weights, "rank0")


def survivors_buddies(rank, out, weights):
    return _survive(rank, out, weights, "buddies")


def refused(rank, out, weights):
    """Refusals after a real death: the failed rank, and two survivors
    without a group."""
    from repro_torch.elastic import ElasticEvent, hot_recover

    t = _trainer(MESH21, dist.group.WORLD, ckpt_dir=out / "refused",
                 policy=CheckpointPolicy(hot_interval=1, save_interval=100, async_save=False))
    state = shard_state(init_state(params_from_reference(weights, t.lm, "cpu")), t.plan, rank)
    t.run(state, 0, 1)
    dist.destroy_process_group()
    out_ = {}
    for label, failed in (("failed", (rank,)), ("no_group", ())):
        try:
            hot_recover(t.manager, ElasticEvent(2 - len(failed), "failure", failed), "cpu")
            out_[label] = "recovered"
        except ValueError as e:
            out_[label] = str(e)
    t.manager.close()
    return out_


# ---------------------------------------------------------------------------
# fixtures


@pytest.fixture(scope="module")
def weights():
    return _reference_weights(ARCH)


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("survivors")
    np.savez(out / "weights.npz", **weights)
    with ThreadPoolExecutor(len(WORLDS)) as pool:  # the worlds run side by side
        futures = {tag: pool.submit(run_world, out, 4, f"survivors_{tag}", module=MODULE)
                   for tag in WORLDS}
        runs = {tag: f.result() for tag, f in futures.items()}
    return out, runs


def _reference_recovery(gathered: dict, failed):
    """The reference in one process: the gathered step-2 state captured under
    its data=2,model=2 plan, ``failed`` lost, and its recovery onto the plan
    of its ``propose_mesh`` for the survivors: (mode or None, the recovered
    state as flat numpy or None, the target mesh)."""
    import jax

    repro = _ref()
    import repro.elastic.planner as RP
    import repro.hot as RH
    from repro.core.pytree import flatten_with_paths as rflat
    from repro.models import build_model as ref_build

    rc = repro.configs
    rcfg = rc.reduced(rc.get_config(ARCH))
    rpar = rc.ParallelismConfig(data_axes=("data",), compute_dtype="float32")

    def rplan(mesh):
        return repro.dist.sharding.make_plan(
            rcfg, ref_build(rcfg, vocab_multiple=repro.dist.sharding.vocab_multiple(rpar, mesh)
                            ).registry, rpar, mesh)

    snap = {n: {repro.core.StateKind(kind.value): gathered[f][n].numpy()
                for f, kind in FIELDS} for n in gathered["params"]}
    tier = RH.HotTier(replication=1)
    tier.capture(snap, rplan(repro.core.MeshSpec.from_dict(MESH22)), 2)
    tier.fail_ranks(set(failed))
    mesh = RP.propose_mesh(rcfg, 4 - len(failed), hbm_budget=BUDGET)
    target = rplan(mesh)
    hp = RH.plan_hot_recovery(tier, repro.core.TargetSpec(target.mesh, target.param_specs),
                              min_step=2)
    if hp is None:
        return None, None, dict(mesh.axes)
    state = RH.state_from_hot(hp.snapshot, target, jax.make_mesh((1, 1), ("data", "model")))
    flat = {f: {n: np.asarray(a) for n, a in rflat(jax.device_get(getattr(state, f))).items()}
            for f, _ in FIELDS}
    return hp.mode.value, flat, dict(mesh.axes)


def _survivors(runs, tag):
    return [res for res in runs[tag] if not res.get("exited")]


def _compute(runs, tag):
    return sorted((res for res in _survivors(runs, tag) if not res["spare"]),
                  key=lambda res: res["new_rank"])


# ---------------------------------------------------------------------------
# the recovery


@pytest.mark.parametrize("tag", ["spare", "pair", "rank0"])
def test_survivors_recover_from_memory_as_the_reference(worlds, tag):
    _, runs = worlds
    mode, want, mesh = _reference_recovery(runs[tag][0]["gathered2"], WORLDS[tag])
    assert mode == "hot_reshard" and mesh == MESH21
    plan = _plan(MESH21)
    assert [res["new_rank"] for res in _survivors(runs, tag)] == list(
        range(4 - len(WORLDS[tag])))
    for res in _survivors(runs, tag):
        assert (res["mode"], res["step"], res["opened"], res["mesh"]) == (mode, 2, 0, MESH21)
    for r, res in enumerate(_compute(runs, tag)):
        for field, kind in FIELDS:
            for name, got in res["state"][field].items():
                layout = plan.param_specs[name].layout_for(kind, plan.mesh)
                exp = slice_shard(torch.from_numpy(want[field][name].copy()), layout, r)
                assert torch.equal(got.view(torch.uint8), exp.view(torch.uint8)), (r, name)
    survivors = _survivors(runs, tag)
    assert sum(res["fetched"] for res in survivors) == sum(res["sent"] for res in survivors) > 0


def test_a_spare_sends_what_only_it_holds(worlds):
    _, runs = worlds
    spare = [res for res in _survivors(runs, "spare") if res["spare"]]
    assert len(spare) == 1 and spare[0]["new_rank"] == 2 and spare[0]["state"] is None
    assert spare[0]["sent"] > 0 and spare[0]["fetched"] == 0
    assert "hist" not in spare[0]  # it trains and saves nothing


def test_losing_a_buddy_group_takes_the_disk_ladder_together(worlds):
    out, runs = worlds
    mode, _, mesh = _reference_recovery(runs["buddies"][0]["gathered2"], WORLDS["buddies"])
    assert mode is None and mesh == MESH21  # the reference has no hot plan either
    plan = _plan(MESH21)
    one, info = CheckpointManager(out / "old_buddies", plan).restore("cpu", step=2)
    assert info.mode.value == "reshard_stream"
    full = _flat_state(one)
    for r, res in enumerate(_compute(runs, "buddies")):
        assert (res["mode"], res["step"], res["fetched"], res["sent"]) == (
            "reshard_stream", 2, 0, 0)
        for field, kind in FIELDS:
            for name, got in res["state"][field].items():
                layout = plan.param_specs[name].layout_for(kind, plan.mesh)
                assert torch.equal(got, slice_shard(full[field][name], layout, r)), (r, name)


def _start(out, runs, tag):
    """The state the survivors' first step starts from, in one process."""
    if tag == "buddies":
        return CheckpointManager(out / "old_buddies", _plan(MESH21)).restore("cpu", step=2)[0]
    return _state(runs[tag][0]["gathered2"], 2)


@pytest.mark.parametrize("tag", list(WORLDS))
def test_two_steps_on_the_new_group_track_one_process(worlds, tag):
    out, runs = worlds
    _, hist = _single_steps(None, state=_start(out, runs, tag), start=2, n=2)
    compute = _compute(runs, tag)
    assert len(compute) == 2
    for res in compute:
        for (loss, gn), (l1, g1) in zip(res["hist"], hist, strict=True):
            assert abs(loss - l1) <= REL * abs(l1) and abs(gn - g1) <= REL * abs(g1), tag


@pytest.mark.parametrize("tag", list(WORLDS))
def test_the_new_groups_save_is_the_reference_save_of_the_gathered_state(worlds, tmp_path,
                                                                         tag):
    """The rebuilt manager's ``int8:b256`` step 4, written by the 2 compute
    ranks and committed by the new rank 0, is the reference's one-process
    ``write_distributed`` of the gathered state byte for byte."""
    out, runs = worlds
    compute = _compute(runs, tag)
    ref = tmp_path / "ref" / "step_00000004"
    _reference_save(compute[0]["gathered4"], 4, ref, mesh_d=MESH21)
    rj = _same_checkpoint(out / f"new_{tag}" / "step_00000004", ref)
    assert rj["shard_codecs"] and all(res["steps"] == [4] for res in compute)


def test_the_new_rank_0_commits_and_publishes(worlds):
    _, runs = worlds
    for tag in WORLDS:
        compute = _compute(runs, tag)
        assert compute[0]["published"] == [4] and compute[1]["published"] is None, tag
        # the old manager's registry was old rank 0's: it publishes only where that lived
        assert {res["publishing"] for res in _survivors(runs, tag)} == {0 not in WORLDS[tag]}


def test_a_failed_rank_and_survivors_without_a_group_are_refused(tmp_path, weights):
    np.savez(tmp_path / "weights.npz", **weights)
    res = run_world(tmp_path, 2, "refused", module=MODULE)
    for r, got in enumerate(res):
        assert got["failed"] == (f"rank {r} is among the failed ranks [{r}]: it has nothing "
                                 "to recover")
        assert got["no_group"] == ("2 ranks survive ([0, 1]): they recover as a group they "
                                   "re-form (elastic.reform_group)")
