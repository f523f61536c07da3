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
"""

from __future__ import annotations

import dataclasses

import torch

import repro_torch.obs as obs
from repro_torch.core.plan import (
    ResumeMode,
    TargetSpec,
    layouts_equal,
    stream_transforms,
    unstreamable_reason,
)
from repro_torch.core.tensor_io import IntegrityError

from .snapshot import HotSnapshot, HotTier

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


def state_from_hot(
    snapshot: HotSnapshot,
    plan,
    device: str | torch.device,
    stats=None,
    *,
    engine=None,
    verify: bool = False,
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
    """
    from repro_torch.ckpt.restore import state_from_source, state_from_stream

    if verify:
        problems = snapshot.verify()
        if problems:
            raise IntegrityError(
                f"hot snapshot @ step {snapshot.step} failed verification: "
                + "; ".join(problems[:5])
            )
    target = TargetSpec(plan.mesh, plan.param_specs)
    if layouts_equal(snapshot.manifest, target):
        # HOT_DIRECT: bit-exact fragment reads — params_to_average replicas
        # keep their per-replica copies, padding bytes included.
        return state_from_source(snapshot, plan, device, engine=engine, stats=stats)
    transforms = stream_transforms(snapshot.manifest, target)
    return state_from_stream(snapshot, plan, device, transforms, engine=engine, stats=stats)
