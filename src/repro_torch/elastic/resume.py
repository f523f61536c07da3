"""Elastic resume orchestration: failure → plan → recover → continue (port
of ``repro.elastic.resume``).

The glue a cluster controller calls after detecting rank failures (or
receiving capacity):

    trainer = rebuild_on(event, cfg, parallel, tcfg, ...)   # proposed mesh
    state, info = hot_recover(old_manager, event, device,
                              target_plan=trainer.plan)     # tiered

Two recovery regimes:

* **process survived** (a peer rank died, the job reconfigures in place):
  :func:`hot_recover` marks the dead ranks' host memory lost and takes the
  tiered ladder — HOT_DIRECT / HOT_RESHARD from the surviving in-memory
  replicas when they still cover the state, disk otherwise.  No disk read
  in the common case.
* **process restarted** (the job rescheduled): host memory is gone, so
  ``Trainer.init_or_restore`` lands on the disk ladder — DIRECT when the
  layout matches, RESHARD_STREAM otherwise, VIA_UCP as the fallback.

The port's device model is one card with simulated ranks: the proposed
:class:`~repro_torch.core.layout.MeshSpec` is the rebuilt trainer's
checkpoint geometry, and its model trains on ``device``.

Under a group whose ranks are processes, a rank's memory dies with its
process.  :func:`hot_recover` on a live group marks the failed ranks on
every rank (one agreed event) and each rank restores its shards, fetching
what it lost from its buddies.  After a real death the survivors destroy
the default group, and then:

* a lone survivor leaves the group and recovers as one process from the
  snapshot in its own memory (its own fragments and its peers' mirrors);
* two or more re-form one (:func:`reform_group`: a gloo group over a store
  every survivor names from the event alone, its ranks the survivors in
  ascending old rank), and every survivor calls :func:`rebuild_on` and
  :func:`hot_recover` with it.  The proposed mesh can be smaller than the
  survivors (a power of two): its ranks are the group's first ones, and the
  rest are spares, which send what only their memory holds during the
  recovery's exchange, then restore, train and save nothing
  (:func:`rebuild_on` gives them no trainer, :func:`survivor_plan` the plan
  they recover onto).  The rebuilt trainer trains, saves, drains and
  publishes on the compute ranks' group; its rank 0 commits.

    group = reform_group(event, old_rank, world, rendezvous_dir)
    trainer = rebuild_on(event, cfg, parallel, tcfg, ..., group=group)  # None: a spare
    plan = trainer.plan if trainer else survivor_plan(event, cfg, parallel, ...)
    state, info = hot_recover(old_manager, event, device, target_plan=plan,
                              group=group)                            # None: a spare
"""

from __future__ import annotations

import dataclasses
import datetime
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ParallelismConfig, TrainConfig
from repro_torch.dist.sharding import ShardingPlan, make_plan, vocab_multiple
from repro_torch.models import build_model
from repro_torch.train.trainer import Trainer

from .planner import propose_mesh

__all__ = ["ElasticEvent", "hot_recover", "rebuild_on", "reform_group", "survivor_plan"]


@dataclasses.dataclass(frozen=True)
class ElasticEvent:
    """A capacity change the controller reacts to.

    ``failed_ranks``: logical ranks whose host memory died with them — the
    hot tier loses exactly those replicas (empty for scale events and
    whole-process restarts, where the tier is gone entirely).
    """

    healthy_devices: int
    reason: str  # "failure" | "scale_up" | "scale_down"
    failed_ranks: tuple[int, ...] = ()


def reform_group(event: ElasticEvent, rank: int, world: int, rendezvous: str | Path, *,
                 timeout: float | None = None):
    """The survivors of ``event`` re-form a gloo default group, after the old
    one died with ``event.failed_ranks`` (old mesh ranks of a group of
    ``world``); every survivor calls this with its old mesh ``rank``.

    The old default group is destroyed if this process has not done so.
    The rendezvous is a ``FileStore`` in the directory ``rendezvous`` (one
    every survivor can reach), named by the failed ranks, so the event
    alone agrees it.  Returns the new default group: its ranks are the
    survivors in ascending old rank, ``event.healthy_devices`` of them.
    ``timeout`` (seconds) bounds its collectives."""
    failed = sorted({int(r) for r in event.failed_ranks})
    survivors = [r for r in range(world) if r not in failed]
    if rank not in survivors:
        raise ValueError(f"rank {rank} is among the failed ranks {failed}")
    if len(survivors) != event.healthy_devices:
        raise ValueError(f"{len(survivors)} of {world} ranks survive {failed}; the event "
                         f"counts {event.healthy_devices} healthy devices")
    if dist.is_initialized():
        dist.destroy_process_group()
    path = Path(rendezvous).resolve() / f"survivors_of_{'_'.join(map(str, failed))}"
    path.parent.mkdir(parents=True, exist_ok=True)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group("gloo", store=dist.FileStore(str(path), len(survivors)),
                            rank=survivors.index(rank), world_size=len(survivors), **kw)
    return dist.group.WORLD


def survivor_plan(event: ElasticEvent, cfg: ModelConfig, parallel: ParallelismConfig, *,
                  device: str | torch.device = "cuda",
                  hbm_budget: float | None = None) -> ShardingPlan:
    """The plan of the trainer :func:`rebuild_on` builds for ``event``: what
    a spare, which gets no trainer, recovers onto with the others."""
    mesh = propose_mesh(cfg, event.healthy_devices, moment_dtype=parallel.moment_dtype,
                        hbm_budget=hbm_budget, device=device)
    lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh))
    return make_plan(cfg, lm.registry, parallel, mesh)


def rebuild_on(
    event: ElasticEvent,
    cfg: ModelConfig,
    parallel: ParallelismConfig,
    tcfg: TrainConfig,
    *,
    batch_size: int,
    seq_len: int,
    ckpt_dir: str,
    device: str | torch.device = "cuda",
    hbm_budget: float | None = None,
    group=None,
    policy=None,
) -> Trainer | None:
    """A trainer for the post-event topology: the mesh
    :func:`~repro_torch.elastic.planner.propose_mesh` proposes for
    ``event.healthy_devices`` (its memory budget ``hbm_budget``, else read
    from ``device``) as its checkpoint geometry, training on ``device``
    with the checkpoint ``policy``.

    Its ``init_or_restore`` reconfigures the latest disk checkpoint through
    UCP when the layout changed; :func:`hot_recover` serves it from the
    surviving in-memory replicas instead.

    ``group``: the survivors' re-formed group (:func:`reform_group`; a
    collective over it).  The trainer then trains on a group of the mesh's
    ranks, the group's first ones, and a survivor beyond them (a spare)
    gets None."""
    mesh = propose_mesh(cfg, event.healthy_devices, moment_dtype=parallel.moment_dtype,
                        hbm_budget=hbm_budget, device=device)
    if group is not None:
        if group.size() != event.healthy_devices:
            raise ValueError(f"the survivors' group has {group.size()} ranks; the event "
                             f"counts {event.healthy_devices}")
        if mesh.size < group.size():  # spares beyond the mesh
            glob = [dist.get_global_rank(group, r) for r in range(group.size())]
            spare = dist.get_rank(group) >= mesh.size
            group = dist.new_group(glob[:mesh.size], backend="gloo")  # every survivor
            if spare:
                return None
    return Trainer.create(
        cfg, parallel, tcfg, mesh,
        batch_size=batch_size, seq_len=seq_len, ckpt_dir=ckpt_dir, device=device,
        group=group, policy=policy,
    )


def hot_recover(
    manager,
    event: ElasticEvent,
    device: str | torch.device,
    *,
    target_plan=None,
    verify: bool = False,
    group=None,
):
    """In-process recovery after peer-rank loss, preferring the hot tier.

    Marks ``event.failed_ranks``' host memory lost in the manager's hot tier
    (each affected snapshot drops those replicas and re-keys its fragment
    indexes), then resumes onto ``device`` under ``target_plan`` through the
    tiered ladder: surviving in-memory replicas when they cover the state,
    disk otherwise.  Returns ``(state, RestoreInfo)`` or None when nothing
    committed exists.

    A manager of a group whose default group was destroyed (the failed
    ranks' processes died) first leaves it
    (:meth:`~repro_torch.ckpt.manager.CheckpointManager.leave_group`): a
    lone survivor then recovers on its own; two or more pass ``group``,
    the group they re-formed (:func:`reform_group`; every survivor calls
    this), and each compute rank restores its shards of ``target_plan``
    while a spare sends what it holds and gets ``(None, info)``.
    """
    if group is not None:
        manager.leave_group(event.failed_ranks, group, plan=target_plan)
    elif getattr(manager, "group", None) is not None and not dist.is_initialized():
        manager.leave_group(event.failed_ranks)
    if manager.hot is not None and event.failed_ranks:
        manager.hot.fail_ranks(event.failed_ranks)
    return manager.restore_latest(device, target_plan=target_plan, verify=verify)
