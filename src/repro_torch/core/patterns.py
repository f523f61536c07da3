"""The UCP parameter-pattern language (paper §3.2, Tables 1 & 2).

A *pattern* describes how one parameter's state relates to the ranks of a
parallelism configuration.  The paper defines four:

=================== ==========================================================
``unique_params``    parameter owned by exactly one rank (PP stages, per-
                     expert-unique tensors)
``replicated_params`` identical copy on several ranks (pure DP)
``fragment_params``  partitioned along ≥1 dimension (TP/FSDP/EP), optionally
                     with *sub-patterns*: fused variable-size fragments
                     (packed QKV under GQA) and 3-D expert tensors (MoE)
``params_to_average`` updated independently per rank; consolidation averages
                     (local-update / DiLoCo-style optimizers)
=================== ==========================================================

In this framework patterns are **derived, not annotated**: the sharding rule
table in ``repro_torch.dist.sharding`` produces, for every parameter leaf and every
optimizer-state kind, a :class:`StateLayoutSpec` (dims over the mesh) — the
pattern falls out of the geometry.  ``params_to_average`` is the exception:
it is attached explicitly by the local-update optimizer mode, because
"updated independently" is a property of the *update rule*, not the layout.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence

from .layout import DimSpec, MeshSpec, ShardLayout, compute_layout

__all__ = [
    "Pattern",
    "derive_pattern",
    "StateKind",
    "STATE_KINDS",
    "StateLayoutSpec",
    "ParamSpec",
    "ParamTransform",
    "TransformClass",
    "classify_transform",
    "uniform_param_spec",
]


class Pattern(str, enum.Enum):
    UNIQUE = "unique_params"
    REPLICATED = "replicated_params"
    FRAGMENT = "fragment_params"
    AVERAGE = "params_to_average"


class StateKind(str, enum.Enum):
    """The per-parameter atom files (paper §3.1).

    ``fp32``        master weights
    ``exp_avg``     Adam first moment
    ``exp_avg_sq``  Adam second moment
    """

    FP32 = "fp32"
    EXP_AVG = "exp_avg"
    EXP_AVG_SQ = "exp_avg_sq"


STATE_KINDS: tuple[StateKind, ...] = (
    StateKind.FP32,
    StateKind.EXP_AVG,
    StateKind.EXP_AVG_SQ,
)


@dataclasses.dataclass(frozen=True)
class StateLayoutSpec:
    """Layout of one state kind of one parameter over one mesh.

    Different state kinds of the same parameter may be sharded differently
    (e.g. ZeRO-1: weights replicated over ``data`` while Adam moments are
    fragmented over it), hence layout is per-kind.
    """

    dims: tuple[DimSpec, ...]
    dtype: str = "float32"

    def layout(self, global_shape: Sequence[int], mesh: MeshSpec) -> ShardLayout:
        return compute_layout(global_shape, self.dims, mesh)

    def to_json(self) -> dict:
        return {"dims": [d.to_json() for d in self.dims], "dtype": self.dtype}

    @classmethod
    def from_json(cls, d: Mapping) -> "StateLayoutSpec":
        return cls(
            tuple(DimSpec.from_json(x) for x in d["dims"]), str(d.get("dtype", "float32"))
        )


def derive_pattern(
    layout: ShardLayout, *, average: bool = False, owner_ranks: Sequence[int] | None = None
) -> Pattern:
    """Classify a layout into the paper's pattern taxonomy: ``average`` (the
    update rule diverges per replica) → params_to_average; one owner rank →
    unique; one fragment → replicated; else fragment."""
    if average:
        return Pattern.AVERAGE
    if owner_ranks is not None and len(owner_ranks) == 1:
        return Pattern.UNIQUE
    if len(set(layout.fragment_id)) == 1:
        return Pattern.REPLICATED
    return Pattern.FRAGMENT


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Everything UCP needs to know about one parameter.

    ``name``            flattened pytree path, e.g. ``decoder.blocks.attn.wqkv``
    ``logical_shape``   consolidated (atom) shape — *no* alignment padding,
                        *no* replica dim
    ``runtime_shape``   global shape of the in-memory array during training.
                        May exceed ``logical_shape`` per-dim by alignment
                        padding (e.g. vocab rounded up to a mesh-axis
                        multiple) — the delta is what ``StripPadding``
                        removes.  For ``average`` parameters it additionally
                        carries a *leading replica dimension* holding the
                        per-data-group divergent copies.
    ``states``          per-:class:`StateKind` layout spec (layouts are over
                        ``runtime_shape``)
    ``average``         params_to_average marker (local-update mode): dim 0 of
                        ``runtime_shape`` is the replica dim; the atom is the
                        mean over it and Targets re-broadcast it
    ``stacked_dim``     index (in ``logical_shape``) of the layer-stack dim
                        ``L`` for scan-stacked block parameters — enables
                        PP-layout stage splitting at save time and PP
                        reconfiguration at load time
    ``kind``            sub-pattern tag for documentation/validation
                        ("dense" | "fused_qkv" | "moe_expert" | "scalar")
    """

    name: str
    logical_shape: tuple[int, ...]
    states: Mapping[StateKind, StateLayoutSpec]
    runtime_shape: tuple[int, ...] | None = None
    average: bool = False
    stacked_dim: int | None = None
    kind: str = "dense"

    def __post_init__(self) -> None:
        if self.runtime_shape is None:
            object.__setattr__(self, "runtime_shape", tuple(self.logical_shape))
        rt, lg = self.runtime_shape, self.logical_shape
        if self.average:
            if len(rt) != len(lg) + 1:
                raise ValueError(
                    f"{self.name}: average param runtime shape {rt} must have "
                    f"one extra leading (replica) dim vs logical {lg}"
                )
            body = rt[1:]
        else:
            if len(rt) != len(lg):
                raise ValueError(f"{self.name}: rank mismatch {rt} vs {lg}")
            body = rt
        if any(r < l for r, l in zip(body, lg)):
            raise ValueError(f"{self.name}: runtime {rt} smaller than logical {lg}")

    def layout_for(self, kind: StateKind, mesh: MeshSpec) -> ShardLayout:
        # Memoized: every save/convert/restore path asks for the same
        # (kind, mesh) layouts over and over (once per region read in the
        # worst case) and compute_layout is pure — cache per instance.
        cache: dict = self.__dict__.get("_layout_cache")  # type: ignore[assignment]
        if cache is None:
            cache = {}
            object.__setattr__(self, "_layout_cache", cache)
        key = (kind, mesh)
        layout = cache.get(key)
        if layout is None:
            layout = self.states[kind].layout(self.runtime_shape, mesh)
            cache[key] = layout
        return layout

    def pattern_for(self, kind: StateKind, mesh: MeshSpec) -> Pattern:
        return derive_pattern(self.layout_for(kind, mesh), average=self.average)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "logical_shape": list(self.logical_shape),
            "runtime_shape": list(self.runtime_shape),
            "states": {k.value: v.to_json() for k, v in self.states.items()},
            "average": self.average,
            "stacked_dim": self.stacked_dim,
            "kind": self.kind,
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "ParamSpec":
        return cls(
            name=str(d["name"]),
            logical_shape=tuple(int(x) for x in d["logical_shape"]),
            runtime_shape=tuple(int(x) for x in d["runtime_shape"]),
            states={
                StateKind(k): StateLayoutSpec.from_json(v)
                for k, v in d["states"].items()
            },
            average=bool(d.get("average", False)),
            stacked_dim=d.get("stacked_dim"),
            kind=str(d.get("kind", "dense")),
        )


# ---------------------------------------------------------------------------
# Source → Target transform classification (the RESHARD_STREAM plan table)
# ---------------------------------------------------------------------------


class TransformClass(str, enum.Enum):
    """How one parameter gets from a Source layout to a Target layout.

    ``IDENTITY``     layouts structurally equal — each Target region is one
                     Source fragment read (the per-param DIRECT case).
    ``RESLICE``      pure re-slicing: Source fragments and Target regions
                     address the *same* runtime coordinate space, so the
                     indexed region-read path streams Source bytes straight
                     into the Target layout — no atom ever materialized.
    ``CONSOLIDATE``  the transform needs the consolidated atom: replica
                     averaging (``params_to_average``), a runtime-padding
                     change (StripPadding + re-pad), fused sub-fragment
                     repartitioning, or MoE expert re-grouping.  The atom is
                     assembled *in memory* per parameter — consolidation no
                     longer implies a disk checkpoint.
    """

    IDENTITY = "identity"
    RESLICE = "reslice"
    CONSOLIDATE = "consolidate"


@dataclasses.dataclass(frozen=True)
class ParamTransform:
    """One row of the per-parameter RESHARD_STREAM plan table."""

    name: str
    cls: TransformClass
    reason: str = ""


def _sharded_dims(spec: StateLayoutSpec) -> tuple[bool, ...]:
    return tuple(bool(d.axes) for d in spec.dims)


def classify_transform(
    src: ParamSpec,
    tgt: ParamSpec,
    src_mesh: MeshSpec,
    tgt_mesh: MeshSpec,
) -> ParamTransform:
    """Classify one parameter's Source→Target transform.

    The streaming path serves Target device regions by unioning Source
    fragments in *runtime coordinates*; it is valid whenever both sides
    address the same runtime coordinate space.  Four cases genuinely need
    the consolidated (logical) atom instead, and are classified
    ``CONSOLIDATE`` so the planner assembles them in memory:

    * ``params_to_average`` — the atom is the replica mean, then
      re-broadcast on the Target; no per-fragment copy can produce it;
    * runtime-shape change (vocab padded to a different mesh multiple, a
      replica-dim change) — the two runtime coordinate spaces disagree, so
      the transform is StripPadding → re-pad through the logical atom;
    * fused sub-fragment repartitioning (packed QKV under a new TP degree)
      — per-part ceil-division ownership changes, routed through the atom
      path that the fused-geometry suite validates;
    * MoE expert re-grouping (EP ↔ expert-TP) — which dimension carries
      the mesh axis changes, i.e. the grouping itself is transformed.
    """
    name = tgt.name
    if src.average or tgt.average:
        return ParamTransform(
            name, TransformClass.CONSOLIDATE,
            "params_to_average: replica mean + re-broadcast",
        )
    if tuple(src.runtime_shape) != tuple(tgt.runtime_shape):
        return ParamTransform(
            name, TransformClass.CONSOLIDATE,
            f"runtime padding change {tuple(src.runtime_shape)} -> "
            f"{tuple(tgt.runtime_shape)}",
        )
    common_kinds = [k for k in src.states if k in tgt.states]
    for kind in common_kinds:
        sdims, tdims = src.states[kind].dims, tgt.states[kind].dims
        for i, (sd, td) in enumerate(zip(sdims, tdims)):
            if sd.parts is None and td.parts is None:
                continue
            if sd.parts != td.parts:
                return ParamTransform(
                    name, TransformClass.CONSOLIDATE,
                    f"dim {i}: fused sub-fragment structure changed",
                )
            ns, nt = sd.num_shards(src_mesh), td.num_shards(tgt_mesh)
            if ns != nt:
                return ParamTransform(
                    name, TransformClass.CONSOLIDATE,
                    f"fused dim {i} repartitioned ({ns} -> {nt} shards)",
                )
    if "moe_expert" in (src.kind, tgt.kind):
        for kind in common_kinds:
            if _sharded_dims(src.states[kind]) != _sharded_dims(tgt.states[kind]):
                return ParamTransform(
                    name, TransformClass.CONSOLIDATE,
                    "MoE expert re-grouping (sharded dims moved)",
                )
    if src_mesh == tgt_mesh and src == tgt:
        return ParamTransform(name, TransformClass.IDENTITY, "layout unchanged")
    return ParamTransform(name, TransformClass.RESLICE, "pure re-slicing")


def uniform_param_spec(
    name: str,
    logical_shape: Sequence[int],
    dims: Sequence[DimSpec],
    *,
    moment_dims: Sequence[DimSpec] | None = None,
    dtype: str = "float32",
    moment_dtype: str | None = None,
    average: bool = False,
    stacked_dim: int | None = None,
    kind: str = "dense",
) -> ParamSpec:
    """Convenience constructor: same layout for fp32/moments unless overridden."""
    base = StateLayoutSpec(tuple(dims), dtype)
    mdims = tuple(moment_dims) if moment_dims is not None else tuple(dims)
    mom = StateLayoutSpec(mdims, moment_dtype or dtype)
    return ParamSpec(
        name=name,
        logical_shape=tuple(int(s) for s in logical_shape),
        states={
            StateKind.FP32: base,
            StateKind.EXP_AVG: mom,
            StateKind.EXP_AVG_SQ: mom,
        },
        average=average,
        stacked_dim=stacked_dim,
        kind=kind,
    )
