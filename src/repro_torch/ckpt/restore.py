"""Restore onto one device (port of ``repro.ckpt.restore``): the full
``TrainState`` (:func:`state_from_source`, :func:`state_from_stream`) or the
weights alone (:func:`params_from_source`).

The reference asks JAX for each device's index into the runtime-shaped
global array and serves exactly those bytes.  On one card the logical
model lives on one device, so the port enumerates the same Target regions
itself — one per distinct shard of the Target plan's layout of each state
kind, plain ceil-division chunks over the mesh axes of each dim, as a JAX
``NamedSharding`` cuts them — serves each one, and writes it into one
runtime-shaped tensor per parameter and kind on the device.  The plan sets
the checkpoint geometry.

Coded shards (block-quantized moments) are decoded where the state goes: on
a card by the dequantize kernel, with their regions assembled there; on the
CPU by the numpy decode.  Raw shards are served from host mmaps and copied
to the device region by region.

Regions are served as in the reference:

* DIRECT (``transforms=None``) — straight fragment unions through the
  engine's fragment index (:func:`read_region_from_source`);
* RESHARD_STREAM — per the plan table: ``IDENTITY``/``RESLICE`` params
  stream Source fragments, clipped to the logical shape with alignment
  padding zero-filled; ``CONSOLIDATE`` params (fused QKV under a new TP
  degree, a padding change) are assembled in memory by
  :func:`~repro_torch.core.convert.assemble_atom` and served from the atom.

Either way the bytes are the reference's (``repro/ckpt/restore.py:259-310``).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.convert import assemble_atom
from repro_torch.core.engine import CheckpointEngine
from repro_torch.core.layout import DimSpec, MeshSpec, compute_layout
from repro_torch.core.ops import clip_region_to_logical, read_runtime_region
from repro_torch.core.patterns import ParamSpec, ParamTransform, StateKind, TransformClass
from repro_torch.core.pytree import unflatten_from_paths
from repro_torch.core.tensor_io import staging_like, to_staging, torch_dtype
from repro_torch.dist.sharding import ShardingPlan
from repro_torch.train.optimizer import TrainState

__all__ = [
    "params_from_source",
    "read_region_from_source",
    "state_from_source",
    "state_from_stream",
    "target_regions",
]


def _canon_region(
    region: tuple[slice, ...], shape: tuple[int, ...]
) -> tuple[slice, ...]:
    """Normalize an index to concrete unit-step slices over ``shape``."""
    return tuple(slice(*r.indices(s)) for r, s in zip(region, shape))


def read_region_from_source(
    source,
    name: str,
    kind: StateKind,
    region: tuple[slice, ...],
    dtype,
    *,
    engine: CheckpointEngine | None = None,
):
    """Serve a runtime-coordinate region by unioning source fragments.

    The engine's fragment index pre-selects the fragments overlapping the
    region (pairwise disjoint, so each contributes unique elements); the
    remainder, if any, is alignment padding and stays zero.  The region is
    a numpy array, or a tensor on the card when a fragment was decoded
    there."""
    engine = engine or CheckpointEngine()
    idx = engine.index_for(source, name, kind)
    region = _canon_region(region, idx.spec.runtime_shape)
    shape = tuple(r.stop - r.start for r in region)
    hits = [
        (engine.read_fragment(source, rank, name, kind), e, ovs)
        for rank, e, ovs in idx.overlapping(region)
    ]
    covered = sum(math.prod(hi - lo for lo, hi in ovs) for _, _, ovs in hits)
    out = staging_like([h for h, _, _ in hits], shape, dtype, zero=covered < math.prod(shape))
    for shard, e, ovs in hits:
        src_idx = tuple(
            slice(s0 + (lo - a0), s0 + (hi - a0))
            for (a0, _), (s0, _), (lo, hi) in zip(e.atom_slice, e.shard_slice, ovs)
        )
        dst_idx = tuple(
            slice(lo - r.start, hi - r.start) for (lo, hi), r in zip(ovs, region)
        )
        out[dst_idx] = to_staging(out, shard[src_idx])
    return out


def _stream_reader(
    source,
    plan: ShardingPlan,
    transforms: Mapping[str, ParamTransform],
    engine: CheckpointEngine,
):
    """The per-param plan-table region reader of RESHARD_STREAM."""
    src_params = source.manifest.params

    def reader(name, kind, region, dtype):
        tr = transforms[name]  # strict: a hand-built table must be complete
        tgt_spec = plan.param_specs[name]
        if tr.cls is TransformClass.CONSOLIDATE:
            atom = engine.consolidated(
                source, name, kind,
                lambda: _contiguous(assemble_atom(source, src_params[name], kind, engine=engine)),
            )
            return read_runtime_region(atom, tgt_spec, region, dtype)
        # Stream: Source and Target share one runtime coordinate space.  Clip
        # to the logical shape and zero-fill the rest, so alignment padding
        # comes back as zeros, not as whatever the Source left there.
        region = _canon_region(region, tgt_spec.runtime_shape)
        shape = tuple(r.stop - r.start for r in region)
        clipped = clip_region_to_logical(region, tgt_spec.logical_shape)
        if clipped is None:  # region entirely inside padding
            return staging_like([], shape, dtype, zero=True)
        reads, dests, full = clipped
        inner = read_region_from_source(source, name, kind, reads, dtype, engine=engine)
        if full:
            return inner
        out = staging_like([inner], shape, dtype, zero=True)
        out[dests] = inner
        return out

    return reader


def _contiguous(a):
    return a.contiguous() if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)


def target_regions(
    spec: ParamSpec, mesh: MeshSpec, kind: StateKind = StateKind.FP32
) -> list[tuple[slice, ...]]:
    """The distinct device regions of one state kind's runtime array.

    The runtime sharding of a dim is its mesh axes alone (fused
    sub-fragments shape the checkpoint, not the runtime array), chunked by
    ceil division as JAX's ``NamedSharding`` does; replicas share a region.
    """
    dims = tuple(DimSpec(d.axes) for d in spec.states[kind].dims)
    layout = compute_layout(spec.runtime_shape, dims, mesh)
    return [
        layout.entries[r][0].atom_index()
        for r in layout.primary_ranks()
        if layout.entries[r]
    ]


def _reader_for(source, plan, transforms, engine):
    if transforms is None:
        def reader(name, kind, region, dtype):
            return read_region_from_source(source, name, kind, region, dtype, engine=engine)

        return reader
    return _stream_reader(source, plan, transforms, engine)


def _build_flat(reader, plan: ShardingPlan, kind: StateKind, device) -> dict[str, torch.Tensor]:
    """One runtime-shaped tensor per parameter of ``kind`` on ``device``,
    written region by region (a host region is copied there once)."""
    out: dict[str, torch.Tensor] = {}
    for name, spec in plan.param_specs.items():
        dtype = spec.states[kind].dtype
        full = torch.empty(spec.runtime_shape, dtype=torch_dtype(dtype), device=device)
        for region in target_regions(spec, plan.mesh, kind):
            piece = reader(name, kind, region, dtype)
            full[region] = to_staging(full, piece)
        out[name] = full
    return out


def params_from_source(
    source,
    plan: ShardingPlan,
    device: str | torch.device,
    *,
    transforms: Mapping[str, ParamTransform] | None = None,
    engine: CheckpointEngine | None = None,
) -> dict[str, torch.Tensor]:
    """Weights-only restore: flat ``{name: tensor}`` of runtime-shaped fp32
    weights on ``device``.

    ``transforms=None`` means the source layout equals the Target plan's
    (DIRECT); a plan table from
    :func:`~repro_torch.core.plan.stream_transforms` streams a layout change
    (RESHARD_STREAM).  The bytes are the ``.params`` of a full restore.
    """
    engine = engine or CheckpointEngine(device)
    return _build_flat(_reader_for(source, plan, transforms, engine), plan,
                       StateKind.FP32, torch.device(device))


def _build_state(source, plan, device, transforms, engine) -> TrainState:
    device = torch.device(device)
    engine = engine or CheckpointEngine(device)
    reader = _reader_for(source, plan, transforms, engine)
    trees = {
        kind: unflatten_from_paths(_build_flat(reader, plan, kind, device))
        for kind in (StateKind.FP32, StateKind.EXP_AVG, StateKind.EXP_AVG_SQ)
    }
    return TrainState(
        params=trees[StateKind.FP32],
        exp_avg=trees[StateKind.EXP_AVG],
        exp_avg_sq=trees[StateKind.EXP_AVG_SQ],
        step=int(source.manifest.step),
    )


def state_from_source(
    source,
    plan: ShardingPlan,
    device: str | torch.device,
    *,
    engine: CheckpointEngine | None = None,
) -> TrainState:
    """DIRECT: the full TrainState (params, both moments, step) on
    ``device``, from straight fragment unions."""
    return _build_state(source, plan, device, None, engine)


def state_from_stream(
    source,
    plan: ShardingPlan,
    device: str | torch.device,
    transforms: Mapping[str, ParamTransform],
    *,
    engine: CheckpointEngine | None = None,
) -> TrainState:
    """RESHARD_STREAM: the full TrainState under a changed layout, with no
    intermediate checkpoint.  Per the plan table, ``IDENTITY``/``RESLICE``
    params stream Source fragments (clipped to the logical shape, padding
    zero-filled) and ``CONSOLIDATE`` params are assembled in memory — on
    the card for coded kinds — and served from the atom."""
    return _build_state(source, plan, device, transforms, engine)
