"""Weights-only restore onto one device (port of part of ``repro.ckpt.restore``).

The reference asks JAX for each device's index into the runtime-shaped
global array and serves exactly those bytes.  On one card the logical
model lives on one device, so the port enumerates the same Target regions
itself — one per distinct shard of the Target plan's fp32 layout, plain
ceil-division chunks over the mesh axes of each dim, as a JAX
``NamedSharding`` cuts them — serves each one, and assembles them into one
full runtime-shaped tensor per parameter.  The plan sets the checkpoint
geometry; the tensor goes to the device once.

Regions are served as in the reference:

* DIRECT (``transforms=None``) — straight fragment unions through the
  engine's fragment index (:func:`read_region_from_source`);
* RESHARD_STREAM — per the plan table: ``IDENTITY``/``RESLICE`` params
  stream Source fragments, clipped to the logical shape with alignment
  padding zero-filled; ``CONSOLIDATE`` params (fused QKV under a new TP
  degree, a padding change) are assembled in memory by
  :func:`~repro_torch.core.convert.assemble_atom` and served from the atom.

Either way the bytes are the ``.params`` of the reference's full restore
(``repro/ckpt/restore.py:411-415``).
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
from repro_torch.core.tensor_io import resolve_dtype
from repro_torch.dist.sharding import ShardingPlan

__all__ = ["params_from_source", "read_region_from_source", "target_regions"]


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
) -> np.ndarray:
    """Serve a runtime-coordinate region by unioning source fragments.

    The engine's fragment index pre-selects the fragments overlapping the
    region (pairwise disjoint, so each contributes unique elements); the
    remainder, if any, is alignment padding and stays zero.
    """
    engine = engine or CheckpointEngine()
    idx = engine.index_for(source, name, kind)
    region = _canon_region(region, idx.spec.runtime_shape)
    shape = tuple(r.stop - r.start for r in region)
    hits = idx.overlapping(region)
    covered = sum(math.prod(hi - lo for lo, hi in ovs) for _, _, ovs in hits)
    out = engine.alloc(shape, resolve_dtype(dtype), zero=covered < math.prod(shape))
    for rank, e, ovs in hits:
        shard = engine.read_fragment(source, rank, name, kind)
        src_idx = tuple(
            slice(s0 + (lo - a0), s0 + (hi - a0))
            for (a0, _), (s0, _), (lo, hi) in zip(e.atom_slice, e.shard_slice, ovs)
        )
        dst_idx = tuple(
            slice(lo - r.start, hi - r.start) for (lo, hi), r in zip(ovs, region)
        )
        out[dst_idx] = shard[src_idx]
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
                lambda: np.ascontiguousarray(
                    assemble_atom(source, src_params[name], kind, engine=engine)
                ),
            )
            return read_runtime_region(atom, tgt_spec, region, dtype, alloc=engine.alloc)
        # Stream: Source and Target share one runtime coordinate space.  Clip
        # to the logical shape and zero-fill the rest, so alignment padding
        # comes back as zeros, not as whatever the Source left there.
        region = _canon_region(region, tgt_spec.runtime_shape)
        shape = tuple(r.stop - r.start for r in region)
        clipped = clip_region_to_logical(region, tgt_spec.logical_shape)
        if clipped is None:  # region entirely inside padding
            return engine.alloc(shape, resolve_dtype(dtype), zero=True)
        reads, dests, full = clipped
        inner = read_region_from_source(source, name, kind, reads, dtype, engine=engine)
        if full:
            return inner
        out = engine.alloc(shape, resolve_dtype(dtype), zero=True)
        out[dests] = inner
        return out

    return reader


def target_regions(spec: ParamSpec, mesh: MeshSpec) -> list[tuple[slice, ...]]:
    """The distinct device regions of a parameter's fp32 runtime array.

    The runtime sharding of a dim is its mesh axes alone (fused
    sub-fragments shape the checkpoint, not the runtime array), chunked by
    ceil division as JAX's ``NamedSharding`` does; replicas share a region.
    """
    dims = tuple(DimSpec(d.axes) for d in spec.states[StateKind.FP32].dims)
    layout = compute_layout(spec.runtime_shape, dims, mesh)
    return [
        layout.entries[r][0].atom_index()
        for r in layout.primary_ranks()
        if layout.entries[r]
    ]


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
    (RESHARD_STREAM).  Each parameter is assembled on the host from the
    Target plan's regions, then copied to the device once.
    """
    engine = engine or CheckpointEngine()
    if transforms is None:
        def reader(name, kind, region, dtype):
            return read_region_from_source(source, name, kind, region, dtype, engine=engine)
    else:
        reader = _stream_reader(source, plan, transforms, engine)
    out: dict[str, torch.Tensor] = {}
    for name, spec in plan.param_specs.items():
        dtype = spec.states[StateKind.FP32].dtype
        full = np.empty(spec.runtime_shape, resolve_dtype(dtype))
        for region in target_regions(spec, plan.mesh):
            full[region] = reader(name, StateKind.FP32, region, dtype)
        out[name] = torch.from_numpy(full).to(device)
    return out
