"""Tiered recovery planning: serve a resume from the cheapest tier that can
(port of ``repro.hot.recovery``).

The recovery ladder, cheapest first:

    HOT_DIRECT      surviving in-memory snapshot, layout unchanged — each
                    device region coincides with one resident fragment; no
                    disk I/O, no transformation.
    HOT_RESHARD     surviving in-memory snapshot, layout changed — the
                    streaming plan table classifies every parameter and
                    regions are served from resident fragments (the few
                    consolidation-class params assembled in memory); still
                    no disk I/O.
    DIRECT          disk checkpoint, layout unchanged (per-rank reads).
    RESHARD_STREAM  disk checkpoint, layout changed — the same streaming
                    plan table pointed at shard files.
    VIA_UCP         disk checkpoint, convert to atoms once then Load — the
                    fallback for a changed parameter set or a stream failure.

``plan_hot_recovery`` decides whether a hot tier applies: the newest
snapshot that (a) is at least as fresh as the best disk checkpoint, (b)
still covers every fragment after failures, and (c) is structurally
servable under the target.  Anything else falls through to the disk planner
inside ``CheckpointManager.restore``.

Under a group the plan is the same on every rank: its inputs are the
shared index, the agreed failures and rank 0's newest commit.  Each rank
then builds its own shards (``state_from_hot(..., rank=, group=)``): it
reads the fragments it holds, and every fragment its regions need that it
does not hold comes from the lowest surviving holder, planned by every rank
from the index alone and moved in one exchange.
"""

from __future__ import annotations

import dataclasses
import time

import torch

import torch.distributed as dist

import repro_torch.obs as obs
from repro_torch.core.engine import default_engine
from repro_torch.core.patterns import StateKind
from repro_torch.core.plan import (
    ResumeMode,
    TargetSpec,
    layouts_equal,
    stream_transforms,
    unstreamable_reason,
)
from repro_torch.core.tensor_io import IntegrityError

from .snapshot import HotSnapshot, HotTier, exchange_fragments, host_empty, n_chunks

__all__ = [
    "HotRecoveryPlan",
    "plan_hot_recovery",
    "reshard_compatible",
    "state_from_hot",
]


@dataclasses.dataclass
class HotRecoveryPlan:
    mode: ResumeMode  # HOT_DIRECT | HOT_RESHARD
    snapshot: HotSnapshot
    step: int
    reason: str


def reshard_compatible(manifest, target: TargetSpec) -> str | None:
    """Can HOT_RESHARD serve ``target`` from this snapshot?  None == yes.

    One predicate governs both planners: what the disk stream planner
    cannot serve (a changed parameter set or logical shape), the hot tier
    cannot either (the same restore code path)."""
    return unstreamable_reason(manifest, target)


def plan_hot_recovery(
    tier: HotTier | None,
    target: TargetSpec,
    *,
    min_step: int | None = None,
) -> HotRecoveryPlan | None:
    """Pick the hot tier that can serve ``target``, or None to go to disk.

    Scans the ring newest → oldest; a snapshot older than ``min_step`` (the
    best committed disk checkpoint) is never preferred — recovering an
    older state from memory would roll training back further than the disk
    tier does.
    """
    if tier is None:
        return None
    for snap in reversed(tier.snapshots()):
        if min_step is not None and snap.step < min_step:
            return None  # the ring is step-ordered: everything older loses too
        missing = snap.missing_fragments()
        if missing:
            obs.event("restore.hot_skip", step=snap.step, missing=len(missing))
            continue  # an older snapshot may still have full coverage
        if layouts_equal(snap.manifest, target):
            return HotRecoveryPlan(
                mode=ResumeMode.HOT_DIRECT,
                snapshot=snap,
                step=snap.step,
                reason=f"in-memory snapshot @ step {snap.step}, layout unchanged",
            )
        why_not = reshard_compatible(snap.manifest, target)
        if why_not is None:
            return HotRecoveryPlan(
                mode=ResumeMode.HOT_RESHARD,
                snapshot=snap,
                step=snap.step,
                reason=(
                    f"in-memory snapshot @ step {snap.step}, "
                    f"resharding from surviving replicas"
                ),
            )
        # structurally unservable: every snapshot of the ring shares the
        # run's manifest, so it is disk
        obs.event("restore.hot_unservable", step=snap.step, reason=why_not)
        return None
    return None


def fetch_plan(snapshot: HotSnapshot, plan, transforms, engine, world: int):
    """Every fragment some rank's restore under ``plan`` reads and does not
    hold, in one order on every rank: ``(rank, name, kind value, owner,
    sender)``, the sender its lowest surviving holder."""
    from repro_torch.ckpt.restore import fragments_needed

    out = []
    failed = snapshot.failed_ranks
    for r in range(world):
        for name, kv, owner in sorted(fragments_needed(snapshot, plan, r, transforms, engine)):
            frag = snapshot.fragment(name, kv, owner)
            alive = [h for h in frag.holders if h not in failed]
            if r not in alive:
                out.append((r, name, kv, owner, min(alive)))
    return out


def fetch_fragments(snapshot: HotSnapshot, plan, transforms, engine, rank: int, group,
                    stats=None):
    """Run the exchange of :func:`fetch_plan`: this rank sends what it is
    the sender of and receives what it needs; returns the
    :class:`~repro_torch.ckpt.restore.FetchedSource` serving both."""
    from repro_torch.ckpt.restore import FetchedSource

    t0 = time.perf_counter()
    sends, recvs, fetched, tag = [], [], {}, 0
    for r, name, kv, owner, sender in fetch_plan(snapshot, plan, transforms, engine,
                                                 group.size()):
        frag = snapshot.fragment(name, kv, owner)
        spec = snapshot.manifest.params[name]
        layout = spec.layout_for(StateKind(kv), snapshot.manifest.mesh)
        if sender == rank:
            sends.append((r, frag.data, tag))
        if r == rank:
            fetched[(name, kv, owner)] = host_empty(layout.local_shape,
                                                    spec.states[StateKind(kv)].dtype)
            recvs.append((sender, fetched[(name, kv, owner)], tag))
        tag += n_chunks(frag.nbytes)
    sent, received = exchange_fragments(sends, recvs, group)
    if stats is not None:
        stats.sent_bytes += sent
        stats.fetched_bytes += received
        stats.fetch_s += time.perf_counter() - t0
    return FetchedSource(snapshot, fetched)


def state_from_hot(
    snapshot: HotSnapshot,
    plan,
    device: str | torch.device,
    stats=None,
    *,
    engine=None,
    verify: bool = False,
    rank: int | None = None,
    group=None,
):
    """Restore a TrainState onto ``device`` from an in-memory snapshot (no
    disk I/O).

    Layout unchanged → pure fragment reads (``state_from_source``);
    otherwise the snapshot streams through the same per-param plan table as
    the disk RESHARD_STREAM tier (``state_from_stream``), the
    consolidation-class params assembled in memory from the surviving
    replicas.

    ``verify=True`` re-digests every surviving fragment against its capture
    digest first: a replica that rotted in host memory raises
    :class:`IntegrityError` instead of resuming from corrupt state.

    ``rank`` and ``group`` (a collective over ``group``): rank ``rank``'s
    shards under ``plan``, from the fragments it holds and those fetched
    from its peers (the module notes); ``verify`` failures of any rank
    raise on every rank.  ``stats`` then also counts the bytes fetched and
    sent.
    """
    from repro_torch.ckpt.restore import state_from_source, state_from_stream

    problems = snapshot.verify() if verify else []
    if group is not None and verify:
        everyone: list = [None] * group.size()
        dist.all_gather_object(everyone, problems, group=group)
        problems = [p for part in everyone for p in part]
    if problems:
        raise IntegrityError(
            f"hot snapshot @ step {snapshot.step} failed verification: "
            + "; ".join(problems[:5])
        )
    target = TargetSpec(plan.mesh, plan.param_specs)
    # HOT_DIRECT: bit-exact fragment reads — params_to_average replicas keep
    # their per-replica copies, padding bytes included.
    transforms = (None if layouts_equal(snapshot.manifest, target)
                  else stream_transforms(snapshot.manifest, target))
    source, own_engine = snapshot, engine is None and group is not None
    if group is not None:
        engine = engine or default_engine(device)
        source = fetch_fragments(snapshot, plan, transforms, engine, rank, group, stats)
    try:
        if transforms is None:
            return state_from_source(source, plan, device, engine=engine, stats=stats, rank=rank)
        return state_from_stream(source, plan, device, transforms, engine=engine, stats=stats,
                                 rank=rank)
    finally:
        if source is not snapshot:
            engine.release(source)  # its index and what it fetched
        if own_engine:
            engine.release(snapshot)  # the indexes the fetch plan built
