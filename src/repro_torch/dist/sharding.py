"""The sharding rule table, UCP half (port of ``repro.dist.sharding``).

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

The runtime half of the reference (``PartitionSpec``s, ``make_sharder``,
``cache_pspecs``) waits for the multi-rank runtime (ROADMAP queue 1,
item 11): on one card the logical model lives on one device.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig, ParallelismConfig
from repro_torch.core.layout import DimSpec, MeshSpec, SubFragment
from repro_torch.core.patterns import ParamSpec, StateKind, StateLayoutSpec
from repro_torch.models.common import ParamDef, ParamRegistry

__all__ = ["ShardingPlan", "make_plan", "vocab_multiple"]


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


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """One run's state-distribution description: the mesh, the per-param
    :class:`ParamSpec` table, and the MoE mode (``"none"`` for dense)."""

    mesh: MeshSpec
    param_specs: dict[str, ParamSpec]
    moe_mode: str = "none"


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
