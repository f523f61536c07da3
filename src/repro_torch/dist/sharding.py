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

Compute stays unsharded here: every rank runs the whole model on its rows
of the batch.  Tensor-parallel compute (``make_sharder``), sequence
parallelism and the decode cache's specs (``cache_pspecs``) are ROADMAP
item 11b.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ParallelismConfig
from repro_torch.core.layout import DimSpec, MeshSpec, ShardLayout, SubFragment, slice_shard
from repro_torch.core.patterns import ParamSpec, StateKind, StateLayoutSpec
from repro_torch.models.common import ParamDef, ParamRegistry

__all__ = [
    "PartitionSpec",
    "RankGroups",
    "ShardingPlan",
    "axis_groups",
    "batch_axes",
    "data_coord",
    "gather_full",
    "local_shard",
    "make_plan",
    "rank_rows",
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


@dataclasses.dataclass
class RankGroups:
    """One rank's place in a ``torch.distributed`` group laid over a plan's
    mesh: ``rank`` is ``dist.get_rank(group)`` and its mesh rank; ``data``,
    ``model`` and ``pipe`` are its subgroups (None when the axes' size is 1);
    ``data_size`` is the data group's size (the gradient mean's divisor)."""

    group: "dist.ProcessGroup"
    plan: ShardingPlan
    parallel: ParallelismConfig
    rank: int
    data: "dist.ProcessGroup | None"
    model: "dist.ProcessGroup | None"
    pipe: "dist.ProcessGroup | None"
    data_size: int

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
        backend = dist.get_backend(group)
        glob = [dist.get_global_rank(group, r) for r in range(group.size())]
        pipe = (parallel.pipe_axis,) if parallel.pipe_axis and mesh.has_axis(parallel.pipe_axis) else ()
        model = (parallel.model_axis,) if mesh.has_axis(parallel.model_axis) else ()
        data = batch_axes(parallel, mesh)
        mine = {}
        for label, axes in (("data", data), ("model", model), ("pipe", pipe)):
            mine[label] = None
            if math.prod(mesh.axis_size(a) for a in axes) <= 1:
                continue  # the same on every rank: no group to create
            for members in axis_groups(mesh, axes):
                g = dist.new_group([glob[r] for r in members], backend=backend)
                if rank in members:
                    mine[label] = g
        dsize = math.prod(mesh.axis_size(a) for a in data) if data else 1
        return cls(group=group, plan=plan, parallel=parallel, rank=rank,
                   data=mine["data"], model=mine["model"], pipe=mine["pipe"],
                   data_size=dsize)


def gather_full(local: torch.Tensor, layout: ShardLayout, group) -> torch.Tensor:
    """The runtime-shaped tensor from every rank's local shard: inverts the
    layout's :class:`~repro_torch.core.layout.IndexEntry` maps (one primary
    rank per fragment; padding dropped).  A layout with one fragment is
    every rank's whole tensor already: returned as it is."""
    if len(set(layout.fragment_id)) == 1:
        return local
    shards = [torch.empty_like(local) for _ in range(group.size())]
    dist.all_gather(shards, local.contiguous(), group=group)
    full = torch.empty(layout.global_shape, dtype=local.dtype, device=local.device)
    for r in layout.primary_ranks():
        for e in layout.entries[r]:
            full[e.atom_index()] = shards[r][e.shard_index()]
    return full


def local_shard(full, layout: ShardLayout, rank: int):
    """Rank ``rank``'s local shard of a runtime-shaped tensor: its
    checkpoint shard (:func:`~repro_torch.core.layout.slice_shard`)."""
    return slice_shard(full, layout, rank)
