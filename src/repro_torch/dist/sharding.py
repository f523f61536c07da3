"""The sharding rule table and the multi-rank runtime (port of
``repro.dist.sharding``).

:func:`make_plan` applies the reference's rule table to a model's
:class:`~repro_torch.models.common.ParamRegistry` and a
:class:`~repro_torch.core.layout.MeshSpec`, producing the per-parameter
:class:`~repro_torch.core.patterns.ParamSpec` table — per-kind dims, fused
sub-fragments, ``stacked_dim`` tags, vocab padding — that the checkpoint
layer persists.  It must give exactly the reference's specs, or the two
packages' checkpoints stop interchanging (the tests compare them through
``to_json``).

The rules, as in the reference: tensor parallelism shards the first
eligible logical axis (``vocab``, ``qkv_fused``, ``heads``, ``mlp``, ...) of
every tensor with at least two non-stack dims over the model axis; ZeRO-3 /
FSDP shards the largest remaining dim over the data axes for weights and
moments, ZeRO-1 for the moments only; a pipe axis shards the layer stack.

The plan also gives the runtime :class:`PartitionSpec` of every state kind
(``partition_specs``, ``moment_partition_specs``, ``state_pspecs()``), entry
for entry the reference's.

The runtime half places state over the ranks of a ``torch.distributed``
group laid over the mesh (:class:`RankGroups`): a rank's local tensor of a
(parameter, kind) is its *checkpoint shard* (``slice_shard`` through the
kind's layout, fused sub-fragments and padding included), so a save needs
no exchange and DIRECT reads the rank's own file; :func:`gather_full`
inverts the layout's index maps to rebuild the runtime-shaped tensor for
compute.  Ranks are mesh ranks (row-major coordinates); the data, model and
pipe subgroups are created by every rank in one order.  The collectives
take the tensors where they are: gloo takes CUDA tensors for each one the
runtime sends (``all_reduce``, ``broadcast``, ``all_gather``; the smoke's
``multirank`` phase checks it on the card, and found pinned host staging of
the gather no faster).

The compute half: :func:`make_sharder` is the reference's activation rule
(which logical axis of an activation goes over which mesh axis), returning
the :class:`PartitionSpec` it decides for a shape instead of constraining an
array; the dense family computes by it
(:mod:`repro_torch.dist.tensor_parallel`).  :func:`cache_pspecs` is the
decode cache's rule, which ``models.decode.init_cache`` follows under a
rank context.  A rank's weights for compute are its *model-local* tensors:
the full data replica of its model shard (:func:`model_layout`,
:func:`gather_shard` over the data subgroup), and, for the weights no rank
computes from its shard alone, the whole tensor (:func:`gather_full` over
the model subgroup).  A train step gathers them where a layer reads them,
one layer at a time (:class:`WeightGather`, each read differentiable:
its backward all-reduces the gradient over the data subgroup and keeps the
rank's shard); serving gathers them before the model runs.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ParallelismConfig
from repro_torch.core.layout import (
    DimSpec, IndexEntry, MeshSpec, ShardLayout, SubFragment, compute_layout, slice_shard,
)
from repro_torch.core.patterns import ParamSpec, StateKind, StateLayoutSpec
from repro_torch.core.pytree import tree_map_with_path
from repro_torch.models.common import ParamDef, ParamRegistry

__all__ = [
    "Exchange",
    "PartitionSpec",
    "RankGroups",
    "ShardingPlan",
    "WeightGather",
    "axis_groups",
    "batch_axes",
    "cache_pspecs",
    "data_coord",
    "gather_full",
    "gather_shard",
    "local_shard",
    "make_plan",
    "make_sharder",
    "new_subgroup",
    "model_layout",
    "place",
    "rank_rows",
    "relocal",
    "shard_norm",
    "vocab_multiple",
]


# Logical axes tensor parallelism may claim (first eligible dim wins).
_TP_AXES = frozenset(
    {"vocab", "qkv_fused", "ssm_fused", "heads", "mlp", "ssm_inner", "ssm_conv"}
)


def vocab_multiple(parallel: ParallelismConfig, mesh: MeshSpec) -> int:
    """Alignment multiple for the vocab dim of embedding/unembedding tables:
    the model-axis size under tensor parallelism, else the data-axes size."""
    if parallel.tensor_parallel and mesh.has_axis(parallel.model_axis):
        return max(1, mesh.axis_size(parallel.model_axis))
    m = 1
    for a in parallel.data_axes:
        if mesh.has_axis(a):
            m *= mesh.axis_size(a)
    return max(1, m)


class PartitionSpec(tuple):
    """The runtime sharding of one array, entry per dim, major to minor:
    ``None`` (replicated), an axis name, or a tuple of axis names — the
    reference's ``jax.sharding.PartitionSpec`` as a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _pspec_entry(dim: DimSpec):
    if not dim.axes:
        return None
    return dim.axes[0] if len(dim.axes) == 1 else tuple(dim.axes)


def _pspec(spec: StateLayoutSpec) -> PartitionSpec:
    return PartitionSpec(*[_pspec_entry(d) for d in spec.dims])


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """One run's state-distribution description: the mesh, the per-param
    :class:`ParamSpec` table, and the MoE mode (``"none"`` for dense)."""

    mesh: MeshSpec
    param_specs: dict[str, ParamSpec]
    moe_mode: str = "none"

    @property
    def partition_specs(self) -> dict[str, PartitionSpec]:
        """Runtime PartitionSpec per parameter (fp32 master weights)."""
        return {n: _pspec(s.states[StateKind.FP32]) for n, s in self.param_specs.items()}

    @property
    def moment_partition_specs(self) -> dict[str, PartitionSpec]:
        """Runtime PartitionSpec per parameter for the Adam moments."""
        return {n: _pspec(s.states[StateKind.EXP_AVG]) for n, s in self.param_specs.items()}

    def state_pspecs(self) -> dict[str, dict[str, PartitionSpec]]:
        """PartitionSpec trees for every TrainState field, by flat path."""
        return {
            "params": self.partition_specs,
            "exp_avg": self.moment_partition_specs,
            "exp_avg_sq": {
                n: _pspec(s.states[StateKind.EXP_AVG_SQ]) for n, s in self.param_specs.items()
            },
        }


def _moe_mode(cfg: ModelConfig, parallel: ParallelismConfig, mesh: MeshSpec) -> str:
    if cfg.moe is None:
        return "none"
    if (
        parallel.expert_parallel
        and mesh.has_axis(parallel.model_axis)
        and cfg.moe.num_experts % mesh.axis_size(parallel.model_axis) == 0
    ):
        return "ep"
    return "tp"


def _spec_for_def(
    d: ParamDef,
    cfg: ModelConfig,
    parallel: ParallelismConfig,
    *,
    has_model: bool,
    pipe: str | None,
    data_axes: tuple[str, ...],
    dsize: int,
    moe_mode: str,
    weights_over_data: bool,
) -> ParamSpec:
    runtime = tuple(d.shape)
    logical = tuple(
        cfg.vocab_size if ax == "vocab" else s for ax, s in zip(d.axes, runtime)
    )
    nbody = sum(1 for ax in d.axes if ax != "layers")

    assigned: list[tuple[str, ...]] = [() for _ in runtime]
    if pipe and d.stacked and d.axes[0] == "layers":
        assigned[0] = (pipe,)
    if has_model:
        for i, ax in enumerate(d.axes):
            if ax == "expert":
                eligible = moe_mode == "ep"
            elif ax == "expert_mlp":
                eligible = moe_mode == "tp" and parallel.tensor_parallel
            else:
                eligible = ax in _TP_AXES and parallel.tensor_parallel and nbody >= 2
            if eligible:
                assigned[i] = (parallel.model_axis,)
                break

    # ZeRO/FSDP dimension: largest free dim the data axes can tile, preferring
    # evenly-divisible ones so runtime shards never need padding.
    data_dim: int | None = None
    if data_axes:
        candidates = [i for i, a in enumerate(assigned) if not a and runtime[i] >= dsize]
        if candidates:
            data_dim = min(
                candidates, key=lambda i: (runtime[i] % dsize != 0, -runtime[i], i)
            )

    weight_dims: list[DimSpec] = []
    moment_dims: list[DimSpec] = []
    for i in range(len(runtime)):
        parts = None
        if d.parts is not None and i == d.parts_dim:
            parts = tuple(SubFragment(n, s) for n, s in d.parts)
        w_axes = m_axes = assigned[i]
        if i == data_dim:
            m_axes = assigned[i] + data_axes
            if weights_over_data:
                w_axes = m_axes
        weight_dims.append(DimSpec(tuple(w_axes), parts))
        moment_dims.append(DimSpec(tuple(m_axes), parts))

    weights = StateLayoutSpec(tuple(weight_dims), parallel.param_dtype)
    moments = StateLayoutSpec(tuple(moment_dims), parallel.moment_dtype)
    return ParamSpec(
        name=d.path,
        logical_shape=logical,
        runtime_shape=runtime,
        states={
            StateKind.FP32: weights,
            StateKind.EXP_AVG: moments,
            StateKind.EXP_AVG_SQ: moments,
        },
        stacked_dim=d.stacked_dim,
        kind=d.kind,
    )


def make_plan(
    cfg: ModelConfig,
    registry: ParamRegistry,
    parallel: ParallelismConfig,
    mesh: MeshSpec,
) -> ShardingPlan:
    """Apply the rule table to every registered parameter (deterministic in
    its inputs, so equal runs derive structurally equal plans)."""
    if parallel.local_updates:
        raise NotImplementedError(
            "local_updates (params_to_average) is not wired into make_plan yet"
        )
    has_model = mesh.has_axis(parallel.model_axis)
    pipe = (
        parallel.pipe_axis
        if parallel.pipe_axis and mesh.has_axis(parallel.pipe_axis)
        else None
    )
    data_axes = tuple(
        a
        for a in parallel.data_axes
        if mesh.has_axis(a) and a != pipe and a != parallel.model_axis
    )
    dsize = math.prod(mesh.axis_size(a) for a in data_axes) if data_axes else 1
    moe_mode = _moe_mode(cfg, parallel, mesh)
    weights_over_data = parallel.fsdp or parallel.zero >= 3

    specs = {
        d.path: _spec_for_def(
            d,
            cfg,
            parallel,
            has_model=has_model,
            pipe=pipe,
            data_axes=data_axes,
            dsize=dsize,
            moe_mode=moe_mode,
            weights_over_data=weights_over_data,
        )
        for d in registry
    }
    return ShardingPlan(mesh=mesh, param_specs=specs, moe_mode=moe_mode)


# ---------------------------------------------------------------------------
# Activation sharding (the decisions the model computes by)
# ---------------------------------------------------------------------------


def make_sharder(
    parallel: ParallelismConfig, mesh: MeshSpec
) -> Callable[[tuple[int, ...], tuple[str, ...]], PartitionSpec]:
    """The reference's activation-sharding rule as a function of a shape and
    its logical axes, returning the :class:`PartitionSpec` the reference's
    ``make_sharder`` constrains that activation to (all ``None`` where it
    leaves the array alone).

    ``batch`` goes over the data axes; ``heads`` / ``kv_heads`` / ``vocab``
    over the model axis under tensor parallelism, the first one that
    divides; ``seq`` over the model axis under sequence parallelism, but
    only when TP did not claim it for this tensor.  An axis is applied only
    where the dimension divides."""
    data = tuple(a for a in parallel.data_axes if mesh.has_axis(a))
    dsize = math.prod(mesh.axis_size(a) for a in data) if data else 1
    model = parallel.model_axis if mesh.has_axis(parallel.model_axis) else None
    msize = mesh.axis_size(model) if model else 1

    def shard(shape: tuple[int, ...], axes: tuple[str, ...]) -> PartitionSpec:
        if len(shape) != len(axes):
            return PartitionSpec(*([None] * len(shape)))
        entries: list = [None] * len(axes)
        model_used = False
        for i, ax in enumerate(axes):
            if ax == "batch" and data and shape[i] % dsize == 0:
                entries[i] = data if len(data) > 1 else data[0]
            elif (
                ax in ("heads", "kv_heads", "vocab")
                and model
                and parallel.tensor_parallel
                and not model_used
                and shape[i] % msize == 0
            ):
                entries[i] = model
                model_used = True
        if model and parallel.sequence_parallel and not model_used:
            for i, ax in enumerate(axes):
                if ax == "seq" and shape[i] % msize == 0:
                    entries[i] = model
                    break
        return PartitionSpec(*entries)

    return shard


def cache_pspecs(cache, parallel: ParallelismConfig, mesh: MeshSpec):
    """PartitionSpec tree for a decode cache (``models.decode.init_cache``),
    entry for entry the reference's: the leaves may be tensors or anything
    with a ``shape``.

    The batch dim shards over the data axes.  Under tensor parallelism the
    KV-head dim shards over the model axis when it divides; otherwise, with
    ``parallel.shard_cache_seq``, the cache-length dim shards instead of
    replicating the whole cache per rank.  Mamba state shards its head dim,
    conv state its channel dim."""
    data = tuple(a for a in parallel.data_axes if mesh.has_axis(a))
    dsize = math.prod(mesh.axis_size(a) for a in data) if data else 1
    dentry = (data if len(data) > 1 else data[0]) if data else None
    model = (
        parallel.model_axis
        if parallel.tensor_parallel and mesh.has_axis(parallel.model_axis)
        else None
    )
    msize = mesh.axis_size(model) if model else 1

    def spec(path: str, leaf) -> PartitionSpec:
        shape = tuple(leaf.shape)
        name = path.split(".")[-1]
        if name == "pos":
            return PartitionSpec(dentry if dsize and shape[0] % dsize == 0 else None)
        entries: list = [None] * len(shape)
        if dentry is not None and len(shape) > 1 and shape[1] % dsize == 0:
            entries[1] = dentry  # [stack, batch, ...]
        if model is not None:
            if name in ("k", "v", "ck", "cv") and len(shape) == 5:
                if shape[3] % msize == 0:
                    entries[3] = model  # KV heads
                elif parallel.shard_cache_seq and shape[2] % msize == 0:
                    entries[2] = model  # cache length
            elif name == "h" and len(shape) == 5 and shape[2] % msize == 0:
                entries[2] = model  # SSM heads
            elif name == "conv" and len(shape) == 4 and shape[3] % msize == 0:
                entries[3] = model  # conv channels
            elif (
                name in ("c_kv", "k_rope", "slot_pos")
                and parallel.shard_cache_seq
                and len(shape) >= 3
                and shape[2] % msize == 0
            ):
                entries[2] = model
        return PartitionSpec(*entries)

    return tree_map_with_path(spec, cache)


def local_shape(shape: tuple[int, ...], spec: PartitionSpec, mesh: MeshSpec) -> tuple[int, ...]:
    """A rank's shape of an array of ``shape`` laid out by ``spec`` (each
    sharded dim divided by the product of its axes' sizes; the specs here
    shard only dims that divide)."""
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        out.append(n // math.prod(mesh.axis_size(a) for a in axes))
    return tuple(out)


# ---------------------------------------------------------------------------
# The multi-rank runtime: ranks of a torch.distributed group over the mesh
# ---------------------------------------------------------------------------

def batch_axes(parallel: ParallelismConfig, mesh: MeshSpec) -> tuple[str, ...]:
    """The mesh axes the batch dim shards over, major to minor: the
    reference's ``P(bspec, None)`` of ``Trainer._batch_shardings``."""
    return tuple(a for a in parallel.data_axes if mesh.has_axis(a))


def data_coord(mesh: MeshSpec, rank: int, axes: tuple[str, ...]) -> int:
    """Mixed-radix coordinate of ``rank`` over ``axes`` (first axis major)."""
    coords = mesh.coords(rank)
    c = 0
    for a in axes:
        c = c * mesh.axis_size(a) + coords[a]
    return c


def rank_rows(batch_size: int, parallel: ParallelismConfig, mesh: MeshSpec, rank: int) -> slice:
    """The rows of a global batch that ``rank`` computes: its data
    coordinate's even chunk.  Ranks that differ only in model or pipe
    coordinates compute the same rows."""
    axes = batch_axes(parallel, mesh)
    n = math.prod(mesh.axis_size(a) for a in axes) if axes else 1
    if batch_size % n:
        raise ValueError(f"batch {batch_size} does not split over the data axes {axes} ({n})")
    per = batch_size // n
    c = data_coord(mesh, rank, axes)
    return slice(c * per, (c + 1) * per)


def axis_groups(mesh: MeshSpec, axes: tuple[str, ...]) -> list[list[int]]:
    """The mesh ranks that differ only in ``axes``, one list per group, each
    ordered by its coordinate over ``axes`` (first axis major); the groups in
    the order of their lowest rank.  Every rank derives the same lists."""
    axes = tuple(a for a in axes if mesh.has_axis(a))
    groups: dict[tuple, list[int]] = {}
    for r in mesh.ranks():
        coords = mesh.coords(r)
        key = tuple(coords[a] for a in mesh.axis_names if a not in axes)
        groups.setdefault(key, []).append(r)
    for members in groups.values():
        members.sort(key=lambda r: data_coord(mesh, r, axes))
    return sorted(groups.values(), key=lambda m: min(m))


def new_subgroup(group, ranks: list[int], backend=None):
    """A new ``torch.distributed`` group over ``ranks`` (global ranks, all
    of ``group``), of ``group``'s backend unless ``backend`` is given.

    Where ``group`` is the whole default group every process enters, as
    ``dist.new_group`` asks, and a non-member gets no group.  Where it is a
    part of it (the compute ranks of a re-formed group of survivors, whose
    spares never join them: :func:`repro_torch.elastic.reform_group`) only
    ``ranks`` enter, and a non-member gets None."""
    local = group.size() < dist.get_world_size()
    return dist.new_group(ranks, backend=backend or dist.get_backend(group),
                          use_local_synchronization=local)


@dataclasses.dataclass
class RankGroups:
    """One rank's place in a ``torch.distributed`` group laid over a plan's
    mesh: ``rank`` is ``dist.get_rank(group)`` and its mesh rank; ``data``,
    ``model`` and ``pipe`` are its subgroups (None when the axes' size is 1);
    ``data_size`` is the data group's size (the gradient mean's divisor);
    ``members[label]`` the mesh ranks of a subgroup in its rank order."""

    group: "dist.ProcessGroup"
    plan: ShardingPlan
    parallel: ParallelismConfig
    rank: int
    data: "dist.ProcessGroup | None"
    model: "dist.ProcessGroup | None"
    pipe: "dist.ProcessGroup | None"
    data_size: int
    # the mesh ranks of this rank's data and model subgroups, in the
    # subgroups' rank order ([rank] where the subgroup is None)
    members: dict = dataclasses.field(default_factory=dict)

    @property
    def mesh(self) -> MeshSpec:
        return self.plan.mesh

    @classmethod
    def create(cls, group, plan: ShardingPlan, parallel: ParallelismConfig) -> "RankGroups":
        """Check ``group`` against the plan's mesh and create the subgroups.
        Every rank of ``group`` must call this, with equal plans, in the same
        order as its other ``new_group`` calls."""
        if group is None or not dist.is_initialized():
            raise ValueError("a multi-rank run needs an initialized torch.distributed group")
        mesh = plan.mesh
        if group.size() != mesh.size:
            raise ValueError(
                f"the group has {group.size()} ranks; the mesh {dict(mesh.axes)} has {mesh.size}"
            )
        rank = dist.get_rank(group)
        glob = [dist.get_global_rank(group, r) for r in range(group.size())]
        pipe = (parallel.pipe_axis,) if parallel.pipe_axis and mesh.has_axis(parallel.pipe_axis) else ()
        model = (parallel.model_axis,) if mesh.has_axis(parallel.model_axis) else ()
        data = batch_axes(parallel, mesh)
        mine, members_of = {}, {}
        for label, axes in (("data", data), ("model", model), ("pipe", pipe)):
            mine[label], members_of[label] = None, [rank]
            if math.prod(mesh.axis_size(a) for a in axes) <= 1:
                continue  # the same on every rank: no group to create
            for members in axis_groups(mesh, axes):
                g = new_subgroup(group, [glob[r] for r in members])
                if rank in members:
                    # a subgroup ranks its members by their global rank
                    mine[label] = g
                    members_of[label] = sorted(members, key=lambda r: glob[r])
        dsize = math.prod(mesh.axis_size(a) for a in data) if data else 1
        return cls(group=group, plan=plan, parallel=parallel, rank=rank,
                   data=mine["data"], model=mine["model"], pipe=mine["pipe"],
                   data_size=dsize, members=members_of)


def model_layout(spec: ParamSpec, kind: StateKind, mesh: MeshSpec, model_axis: str | None,
                 pipe_axis: str | None = None) -> ShardLayout:
    """The layout of a tensor of ``kind`` split over the model axis alone
    (its data axes dropped, and its pipe axis unless ``pipe_axis`` keeps it):
    a rank's *model-local* tensor, the full data replica of its model shard,
    or with ``pipe_axis`` its *stage-local* one (its stage's layers of the
    stacked dim).  ``model_axis`` None drops the model axis too."""
    keep = {model_axis, pipe_axis} - {None}
    dims = tuple(DimSpec(tuple(a for a in d.axes if a in keep), d.parts)
                 for d in spec.states[kind].dims)
    return compute_layout(spec.runtime_shape, dims, mesh)


def relocal(t: torch.Tensor, src: ShardLayout, dst: ShardLayout, rank: int) -> torch.Tensor:
    """A rank's tensor of layout ``src`` cut to its tensor of ``dst`` (whose
    elements ``src``'s covers; padding zero); ``t`` itself where the two
    are the same region.  A ``t`` of one dim fewer than the layouts is one
    layer of a stacked tensor (:func:`_layer_of`)."""
    if _same_region(src, dst, rank):
        return t
    layer = _layer_of(t, src)
    out = torch.zeros(dst.local_shape[layer:], dtype=t.dtype, device=t.device)
    place(out, _entries(dst, rank, layer), t, _entries(src, rank, layer))
    return out


def _layer_of(t: torch.Tensor, layout: ShardLayout) -> bool:
    """Whether ``t`` is one layer of a rank's tensor of ``layout`` (one dim
    fewer: the leading ``layers`` dim dropped).  Every rank it meets in a
    gather or a cut must hold the same layers of the stack (no axis of the
    exchange splits the layers dim), so a layer's index maps are the
    stack's without their leading dim."""
    return t.dim() == len(layout.local_shape) - 1


def _entries(layout: ShardLayout, rank: int, layer: bool) -> tuple[IndexEntry, ...]:
    """``rank``'s index entries of ``layout``, of one layer of it where
    ``layer``."""
    entries = layout.entries[rank]
    if not layer:
        return entries
    return tuple(IndexEntry(e.atom_slice[1:], e.shard_slice[1:]) for e in entries)


def place(dst: torch.Tensor, dst_entries, src: torch.Tensor, src_entries) -> None:
    """Copy into ``dst`` every element of ``src`` whose runtime coordinates
    both sets of :class:`~repro_torch.core.layout.IndexEntry` cover (each
    maps a region of the runtime tensor to a region of its local tensor)."""
    for e in src_entries:
        for f in dst_entries:
            lo = [max(a[0], b[0]) for a, b in zip(e.atom_slice, f.atom_slice)]
            hi = [min(a[1], b[1]) for a, b in zip(e.atom_slice, f.atom_slice)]
            if any(l >= h for l, h in zip(lo, hi)):
                continue
            d = tuple(slice(s0 + l - a0, s0 + h - a0)
                      for (s0, _), (a0, _), l, h in zip(f.shard_slice, f.atom_slice, lo, hi))
            s_ = tuple(slice(s0 + l - a0, s0 + h - a0)
                       for (s0, _), (a0, _), l, h in zip(e.shard_slice, e.atom_slice, lo, hi))
            dst[d] = src[s_]


def gather_shard(local: torch.Tensor, layout: ShardLayout, target: ShardLayout, rank: int,
                 group, members: list[int]) -> torch.Tensor:
    """Rank ``rank``'s tensor of the ``target`` layout from the shards of
    ``layout`` that the subgroup ``group`` (mesh ranks ``members``, in its
    rank order) holds: one all-gather, or none where the members hold one
    fragment.  Every target element must lie in some member's shard (the
    data subgroup's shards cover the rank's model shard).  Where the rank's
    shard already is the target (no data axis splits it), ``local`` itself.
    A ``local`` of one dim fewer than the layouts is one layer of the
    rank's stacked shard, and the result that layer's target tensor."""
    if _same_region(layout, target, rank):
        return local
    layer = _layer_of(local, layout)
    out = torch.zeros(target.local_shape[layer:], dtype=local.dtype, device=local.device)
    if group is None or len({layout.fragment_id[r] for r in members}) == 1:
        place(out, _entries(target, rank, layer), local, _entries(layout, rank, layer))
        return out
    return _gather_into(out, _entries(target, rank, layer), local, layout, group, members, layer)


def _same_region(a: ShardLayout, b: ShardLayout, rank: int) -> bool:
    """Whether ``rank``'s local tensors of two layouts hold the same elements
    in the same places."""
    return a.local_shape == b.local_shape and a.entries[rank] == b.entries[rank]


def gather_full(local: torch.Tensor, layout: ShardLayout, group,
                members: list[int] | None = None) -> torch.Tensor:
    """The runtime-shaped tensor from every rank's local shard: inverts the
    layout's :class:`~repro_torch.core.layout.IndexEntry` maps (one primary
    rank per fragment; padding dropped).  ``group`` is the whole mesh's
    group, or a subgroup whose members (mesh ranks ``members``, in its rank
    order) together hold every fragment.  A layout with one fragment is
    every rank's whole tensor already: returned as it is.  A ``local`` of
    one dim fewer than the layout is one layer of the rank's stacked shard,
    and the result that layer's runtime tensor."""
    if len(set(layout.fragment_id)) == 1:
        return local
    layer = _layer_of(local, layout)
    shape = layout.global_shape[layer:]
    whole = tuple((0, n) for n in shape)
    out = torch.empty(shape, dtype=local.dtype, device=local.device)
    members = list(range(group.size())) if members is None else members
    return _gather_into(out, (IndexEntry(whole, whole),), local, layout, group, members, layer)


def _gather_into(out: torch.Tensor, out_entries, local: torch.Tensor, layout: ShardLayout,
                 group, members: list[int], layer: bool = False) -> torch.Tensor:
    """``out`` (mapped by ``out_entries``) filled from the members' shards of
    ``layout`` (or of one layer of it), all-gathered over ``group``: one
    member a fragment."""
    shards = [torch.empty_like(local) for _ in members]
    dist.all_gather(shards, local.contiguous(), group=group)
    done = set()
    for r, shard in zip(members, shards):
        if layout.fragment_id[r] not in done:
            done.add(layout.fragment_id[r])
            place(out, out_entries, shard, _entries(layout, r, layer))
    return out


def local_shard(full, layout: ShardLayout, rank: int):
    """Rank ``rank``'s local shard of a runtime-shaped tensor: its
    checkpoint shard (:func:`~repro_torch.core.layout.slice_shard`)."""
    return slice_shard(full, layout, rank)


# ---------------------------------------------------------------------------
# The train step's weights, gathered where the model reads them


def _clock(t: torch.Tensor) -> float:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.perf_counter()


class Exchange(torch.autograd.Function):
    """One read of a weight, ``Exchange.apply(x, gather, scatter)``:
    ``gather(x)`` in the forward, ``scatter(g)`` (the reduction of its
    gradient and the cut back to ``x``'s part) in the backward.  It saves
    no tensor, so a checkpointed layer gathers again when it is
    recomputed."""

    @staticmethod
    def forward(ctx, x, gather, scatter):
        ctx.scatter = scatter
        y = gather(x)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        return ctx.scatter(g), None, None


class WeightGather:
    """A rank's weights as the model computes from them in a partitioned
    train step, gathered from the rank's checkpoint shards where a layer
    reads them (``LM.fsdp``), as the reference's compiled step gathers each
    layer's FSDP shard inside its layer scan.

    A read (:meth:`__call__`) takes the rank's shard of one layer's slice of
    a stacked weight (or of an unstacked weight) and all-gathers it over the
    data subgroup into the rank's *model-local* tensor (:func:`model_layout`:
    under a pipe axis its stage's layers); then, where the model does not
    compute from its model shard, over the model subgroup: the
    :class:`~.tensor_parallel.TensorParallel`'s gathered weights
    (``tp.gather_weight``), or every weight the model axis splits where no
    ``tp`` computes partitioned.  The backward all-reduces the model-local
    gradient over the data subgroup, divides it by the data size (the mean
    over the data replicas, every replica the same bits) and returns the
    rank's shard of it.  Where the data axes do not split a weight (ZeRO-1,
    ``fsdp=False``, a data size of 1) the forward is the identity and the
    backward still all-reduces.

    The model reads every layer's weights inside the function that remat
    checkpoints, so under ``remat="full"`` or ``"dots"`` a layer's weights
    are gathered again when it is recomputed and no layer's stay gathered.

    The one case read otherwise: a stacked weight whose layers dim carries
    the data axes (:attr:`whole`: the plan may choose it on a small mesh) is
    gathered whole over the data axes once a forward, before its layers are
    split (:meth:`stack`); its layers are then read from that tensor.

    The gathers' seconds and bytes (every read, every recompute's) add up in
    ``gather_s`` and ``gather_bytes``, the backward's data all-reduces in
    ``reduce_s`` and ``reduce_bytes``; :attr:`seen` names the weights read
    since :meth:`reset`."""

    def __init__(self, ranks: RankGroups, tp=None, pipe=None):
        par, mesh, specs = ranks.parallel, ranks.mesh, ranks.plan.param_specs
        self.ranks, self.tp = ranks, tp
        model = par.model_axis if mesh.has_axis(par.model_axis) else None
        piped = pipe.axis if pipe is not None else None
        data = set(batch_axes(par, mesh))
        self.shard = {n: s.layout_for(StateKind.FP32, mesh) for n, s in specs.items()}
        self.local = {n: model_layout(s, StateKind.FP32, mesh, model, piped)
                      for n, s in specs.items()}
        # over the model subgroup without a partitioned computation: what the axis splits
        self.model = {}
        if tp is None and model is not None and mesh.axis_size(model) > 1:
            self.model = {n: model_layout(s, StateKind.FP32, mesh, None, piped)
                          for n, s in specs.items()
                          if any(model in d.axes for d in self.shard[n].dims)}
        self.whole = frozenset(n for n, s in specs.items()
                               if s.stacked_dim == 0 and data & set(self.shard[n].dims[0].axes))
        self.reset()

    def reset(self) -> None:
        self.gather_s, self.gather_bytes = 0.0, 0
        self.reduce_s, self.reduce_bytes = 0.0, 0
        self.seen: set[str] = set()

    def stack(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A stacked weight before its layers are split: gathered whole over
        the data subgroup where the data axes lie on its layers dim
        (:attr:`whole`), else ``t``."""
        return self._data(name, t) if name in self.whole else t

    def __call__(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The weight ``name`` (``t``: the rank's shard of it, or of one
        layer of it; one layer of :meth:`stack`'s tensor for :attr:`whole`)
        as the model computes from it."""
        if name not in self.whole:
            t = self._data(name, t)
        if self.tp is not None:
            return self.tp.gather_weight(name, t, self) if name in self.tp.gathered else t
        if name in self.model:
            return self._model(name, t)
        return t

    def _data(self, name: str, t: torch.Tensor) -> torch.Tensor:
        rg, src, dst, dt = self.ranks, self.shard[name], self.local[name], t.dtype
        self.seen.add(name)
        split = not _same_region(src, dst, rg.rank)
        if not split and rg.data is None:
            return t

        def gather(x):
            if not split:
                return x
            t0 = _clock(x)
            y = gather_shard(x, src, dst, rg.rank, rg.data, rg.members["data"])
            self.gather_s += _clock(x) - t0
            self.gather_bytes += x.numel() * x.element_size() * rg.data_size
            return y

        def scatter(g):
            if rg.data is not None:
                t0 = _clock(g)
                g = torch.empty(g.shape, dtype=torch.float32, device=g.device).copy_(g)
                dist.all_reduce(g, group=rg.data)
                g.div_(rg.data_size)
                self.reduce_s += _clock(g) - t0
                self.reduce_bytes += g.numel() * g.element_size()
            return relocal(g, dst, src, rg.rank).to(dt)

        return Exchange.apply(t, gather, scatter)

    def _model(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Over the model subgroup, where every model rank computes the whole
        weight from the same rows: each rank's gradient is complete, and it
        keeps its part."""
        rg, src, dst = self.ranks, self.local[name], self.model[name]

        def gather(x):
            t0 = _clock(x)
            y = gather_shard(x, src, dst, rg.rank, rg.model, rg.members["model"])
            self.gather_s += _clock(x) - t0
            self.gather_bytes += x.numel() * x.element_size() * len(rg.members["model"])
            return y

        return Exchange.apply(t, gather, lambda g: relocal(g, dst, src, rg.rank))


def shard_norm(grads: dict, ranks: RankGroups, model_sum: Callable | None = None,
               pipe_sum: Callable | None = None) -> torch.Tensor:
    """The global norm of gradients of the rank's shards (the weights'
    layouts), each element counted once: a weight's sum of squares summed
    over each subgroup whose axes split it (the data axes under FSDP, the
    model axis, the pipe axis), and once where they replicate it.
    ``model_sum`` and ``pipe_sum`` are the in-place sums over those
    subgroups (timed by their contexts); plain all-reduces by default."""
    par, mesh, specs = ranks.parallel, ranks.mesh, ranks.plan.param_specs

    def plain(group):
        def total(t):
            dist.all_reduce(t, group=group)
            return t
        return total

    over = ((set(batch_axes(par, mesh)), ranks.data, plain(ranks.data)),
            ({par.model_axis}, ranks.model, model_sum or plain(ranks.model)),
            ({par.pipe_axis}, ranks.pipe, pipe_sum or plain(ranks.pipe)))
    sums: dict[tuple[bool, ...], torch.Tensor] = {}
    for n, g in grads.items():
        on = {a for d in specs[n].states[StateKind.FP32].dims for a in d.axes}
        key = tuple(group is not None and bool(on & axes) for axes, group, _ in over)
        sq = g.float().square().sum()
        sums[key] = sums[key] + sq if key in sums else sq
    keys = sorted(sums)
    for i, (_, group, total) in enumerate(over):
        sel = [k for k in keys if k[i]]
        if sel:
            sums.update(zip(sel, total(torch.stack([sums[k] for k in sel])).unbind(0)))
    return torch.sqrt(torch.stack([sums[k] for k in keys]).sum())
