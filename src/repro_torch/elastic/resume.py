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
what it lost from its buddies.  After a real death, once the survivor has
destroyed the default group, the lone survivor leaves the group and
recovers as one process from the snapshot in its own memory (its own
fragments and its peers' mirrors); two or more survivors re-forming a
group is refused.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ParallelismConfig, TrainConfig
from repro_torch.train.trainer import Trainer

from .planner import propose_mesh

__all__ = ["ElasticEvent", "hot_recover", "rebuild_on"]


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
) -> Trainer:
    """A trainer for the post-event topology: the mesh
    :func:`~repro_torch.elastic.planner.propose_mesh` proposes for
    ``event.healthy_devices`` (its memory budget ``hbm_budget``, else read
    from ``device``) as its checkpoint geometry, training on ``device``.

    Its ``init_or_restore`` reconfigures the latest disk checkpoint through
    UCP when the layout changed; :func:`hot_recover` serves it from the
    surviving in-memory replicas instead."""
    mesh = propose_mesh(cfg, event.healthy_devices, moment_dtype=parallel.moment_dtype,
                        hbm_budget=hbm_budget, device=device)
    return Trainer.create(
        cfg, parallel, tcfg, mesh,
        batch_size=batch_size, seq_len=seq_len, ckpt_dir=ckpt_dir, device=device,
    )


def hot_recover(
    manager,
    event: ElasticEvent,
    device: str | torch.device,
    *,
    target_plan=None,
    verify: bool = False,
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
    lone survivor then recovers on its own, and two or more survivors raise.
    """
    if getattr(manager, "group", None) is not None and not dist.is_initialized():
        manager.leave_group(event.failed_ranks)
    if manager.hot is not None and event.failed_ranks:
        manager.hot.fail_ranks(event.failed_ranks)
    return manager.restore_latest(device, target_plan=target_plan, verify=verify)
