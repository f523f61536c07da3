"""Reconfiguration planning (port of ``repro.core.plan``).

``plan_resume`` encodes the ladder:

    Source layout == Target layout  →  DIRECT          (per-rank shard reads)
    layout changed, same param set  →  RESHARD_STREAM  (stream fragments;
                                       consolidate the few params that need
                                       it *in memory*, per the plan table)
    parameter set changed           →  VIA_UCP         (convert once, Load)

Layout equality is structural — mesh axes/sizes, per-state dims, runtime
shapes, dtypes — so a checkpoint written by the JAX package under the same
layout plans DIRECT here too.  The port's restore serves DIRECT and
RESHARD_STREAM; it raises on VIA_UCP (ROADMAP queue 1, item 3: the rest of
the checkpoint path).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping

from .dist_ckpt import DistManifest
from .layout import MeshSpec
from .ops import LoadPlan, gen_ucp_metadata
from .patterns import ParamSpec, ParamTransform, TransformClass, classify_transform

__all__ = [
    "ResumeMode",
    "TargetSpec",
    "ResumePlan",
    "layouts_equal",
    "plan_resume",
    "stream_transforms",
    "unstreamable_reason",
]


class ResumeMode(str, enum.Enum):
    """The disk modes of the reference's ladder (its hot-tier modes come
    with the hot tier, ROADMAP queue 1, item 7)."""

    DIRECT = "direct"     # same layout: per-rank shard reads, no conversion
    RESHARD_STREAM = "reshard_stream"  # stream fragments into the new layout
    VIA_UCP = "via_ucp"   # param set changed: atoms, then Load


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    """What the resuming run wants: its mesh and its parameter layouts."""

    mesh: MeshSpec
    params: Mapping[str, ParamSpec]


def _state_layouts_equal(a: ParamSpec, b: ParamSpec) -> bool:
    if tuple(a.runtime_shape) != tuple(b.runtime_shape):
        return False
    if tuple(a.logical_shape) != tuple(b.logical_shape):
        return False
    if a.average != b.average:
        return False
    if set(a.states) != set(b.states):
        return False
    for kind in a.states:
        sa, sb = a.states[kind], b.states[kind]
        if sa.dtype != sb.dtype or sa.dims != sb.dims:
            return False
    return True


def layouts_equal(source: DistManifest, target: TargetSpec) -> bool:
    if source.mesh != target.mesh:
        return False
    if set(source.params) != set(target.params):
        return False
    return all(
        _state_layouts_equal(source.params[n], target.params[n]) for n in source.params
    )


@dataclasses.dataclass
class ResumePlan:
    mode: ResumeMode
    source_step: int
    load_plan: LoadPlan  # target-side geometry (valid for every mode)
    reason: str = ""
    # Per-param plan table (RESHARD_STREAM only).
    transforms: dict[str, ParamTransform] | None = None

    @property
    def consolidate_params(self) -> list[str]:
        if not self.transforms:
            return []
        return [
            n for n, t in self.transforms.items()
            if t.cls is TransformClass.CONSOLIDATE
        ]


def unstreamable_reason(source: DistManifest, target: TargetSpec) -> str | None:
    """Why a streaming reshard cannot serve ``target`` (None == it can):
    streaming needs equal parameter sets, equal logical shapes, equal
    state-kind sets and an unchanged average marker."""
    if set(source.params) != set(target.params):
        return (
            "parameter set changed: "
            f"source-only={sorted(set(source.params) - set(target.params))[:3]} "
            f"target-only={sorted(set(target.params) - set(source.params))[:3]}"
        )
    for name, src in source.params.items():
        tgt = target.params[name]
        if tuple(src.logical_shape) != tuple(tgt.logical_shape):
            return (
                f"{name}: logical shape {tuple(src.logical_shape)} -> "
                f"{tuple(tgt.logical_shape)}"
            )
        if set(src.states) != set(tgt.states):
            return f"{name}: state kinds changed"
        if src.average != tgt.average:
            return f"{name}: average-param marker changed"
    return None


def stream_transforms(source: DistManifest, target: TargetSpec) -> dict[str, ParamTransform]:
    """The per-param plan table for a streaming reshard; raises when the
    target is not streamable at all."""
    why_not = unstreamable_reason(source, target)
    if why_not is not None:
        raise ValueError(f"target is not streamable: {why_not}")
    return {
        n: classify_transform(source.params[n], target.params[n],
                              source.mesh, target.mesh)
        for n in target.params
    }


def plan_resume(
    source: DistManifest, target: TargetSpec, *, allow_stream: bool = True
) -> ResumePlan:
    """Choose the resume path and precompute the Target geometry."""
    plan = gen_ucp_metadata(dict(target.params), target.mesh)
    if layouts_equal(source, target):
        return ResumePlan(
            mode=ResumeMode.DIRECT,
            source_step=source.step,
            load_plan=plan,
            reason="source and target layouts are structurally identical",
        )
    diffs = []
    if source.mesh != target.mesh:
        diffs.append(f"mesh {dict(source.mesh.axes)} -> {dict(target.mesh.axes)}")
    changed = [
        n
        for n in source.params
        if n in target.params
        and not _state_layouts_equal(source.params[n], target.params[n])
    ]
    if changed:
        diffs.append(f"{len(changed)} param layouts changed (e.g. {changed[0]})")
    why_not_stream = unstreamable_reason(source, target)
    if allow_stream and why_not_stream is None:
        transforms = stream_transforms(source, target)
        n_cons = sum(
            1 for t in transforms.values() if t.cls is TransformClass.CONSOLIDATE
        )
        diffs.append(
            f"streaming {len(transforms) - n_cons} params, "
            f"consolidating {n_cons} in memory"
        )
        return ResumePlan(
            mode=ResumeMode.RESHARD_STREAM,
            source_step=source.step,
            load_plan=plan,
            reason="; ".join(diffs),
            transforms=transforms,
        )
    if why_not_stream is not None:
        diffs.append(f"not streamable ({why_not_stream})")
    return ResumePlan(
        mode=ResumeMode.VIA_UCP,
        source_step=source.step,
        load_plan=plan,
        reason="; ".join(diffs) or "parameter set changed",
    )
