"""Restore onto one device (port of ``repro.ckpt.restore``): the full
``TrainState`` (:func:`state_from_source`, :func:`state_from_stream`) or the
weights alone (:func:`params_from_source`).

The reference asks JAX for each device's index into the runtime-shaped
global array and serves exactly those bytes.  On one card the logical
model lives on one device, so the port enumerates the same Target regions
itself — one per distinct shard of the Target plan's layout of each state
kind, plain ceil-division chunks over the mesh axes of each dim, as a JAX
``NamedSharding`` cuts them.  Per state kind it enumerates every
(parameter, region), reads them all, then writes each into one
runtime-shaped tensor per parameter on the device and recycles its staging
buffer.  The plan sets the checkpoint geometry.

A kind whose shards are coded is read through the engine's worker pool
(:meth:`~repro_torch.core.engine.CheckpointEngine.map`, inline in order
when ``workers=1``): each of its files is read, copied to the card and
decoded there, and the pool overlaps that work across files.  A raw kind is
read inline under every profile: a raw region is one copy out of an mmap'd
file, and the pool made raw restores no faster (PERF.md §5).

All file I/O routes through a
:class:`~repro_torch.core.engine.CheckpointEngine`: its fragment index
picks the fragments of a region, its handle cache opens each shard file
once (and decodes a coded one once, whatever the number of regions and
threads that ask), and its arena stages host regions.  A restore given no
engine reads through the device's default engine and drops what it cached
of the checkpoint when it ends; a caller that passes an engine owns its
caches.

Coded shards (block-quantized moments) are decoded where the state goes: on
a card by the dequantize kernel, with their regions assembled there; on the
CPU by the numpy decode.  Raw shards are served from host arrays and copied
to the device region by region.

Regions are served as in the reference:

* DIRECT (``transforms=None``) — straight fragment unions through the
  engine's fragment index (:func:`read_region_from_source`);
* RESHARD_STREAM — per the plan table: ``IDENTITY``/``RESLICE`` params
  stream Source fragments, clipped to the logical shape with alignment
  padding zero-filled; ``CONSOLIDATE`` params (fused QKV under a new TP
  degree, a padding change) are assembled in memory by
  :func:`~repro_torch.core.convert.assemble_atom` (once, single-flight,
  into the engine's atom cache) and served from the atom.

Either way the bytes are the reference's (``repro/ckpt/restore.py:259-310``).

VIA_UCP (:func:`state_from_ucp`, :func:`params_from_ucp`) serves the same
Target regions from a UCP atom checkpoint instead: each atom is opened once
(``CheckpointEngine.read_atom``) and every region is cut from it by
:func:`~repro_torch.core.ops.read_runtime_region`, padding zero-filled and
averaged atoms broadcast, as the reference's ``state_from_ucp``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Mapping

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core.convert import assemble_atom
from repro_torch.core.engine import CheckpointEngine, default_engine
from repro_torch.core.layout import DimSpec, MeshSpec, compute_layout
from repro_torch.core.ops import clip_region_to_logical, gen_ucp_metadata, read_runtime_region
from repro_torch.core.patterns import ParamSpec, ParamTransform, StateKind, TransformClass
from repro_torch.core.pytree import unflatten_from_paths
from repro_torch.core.tensor_io import array_nbytes, staging_like, to_staging, torch_dtype
from repro_torch.dist.sharding import ShardingPlan
from repro_torch.train.optimizer import TrainState

__all__ = [
    "RestoreStats",
    "build_param_arrays",
    "params_from_source",
    "params_from_ucp",
    "read_region_from_source",
    "state_from_source",
    "state_from_stream",
    "state_from_ucp",
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
    engine = engine or default_engine()
    idx = engine.index_for(source, name, kind)
    region = _canon_region(region, idx.spec.runtime_shape)

    def build():
        shape = tuple(r.stop - r.start for r in region)
        hits = [
            (engine.read_fragment(source, rank, name, kind), e, ovs)
            for rank, e, ovs in idx.overlapping(region)
        ]
        covered = sum(math.prod(hi - lo for lo, hi in ovs) for _, _, ovs in hits)
        obs.add("restore.region_reads")
        obs.add("restore.region_fragments", len(hits))
        out = staging_like([h for h, _, _ in hits], shape, dtype,
                           zero=covered < math.prod(shape), alloc=engine.alloc)
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

    # Fan-out sources (``share_regions``, e.g. serve.PeerFragmentSource) pool
    # identical region reads across a fleet: assembled once into the
    # engine's byte-bounded cache, served to every reader.
    if getattr(source, "share_regions", False):
        return engine.shared_region(source, name, kind, region, dtype, build)
    return build()


def _stream_reader(
    source,
    plan: ShardingPlan,
    transforms: Mapping[str, ParamTransform],
    engine: CheckpointEngine,
):
    """The per-param plan-table region reader of RESHARD_STREAM."""
    src_params = source.manifest.params

    def reader(name, kind, regions, dtype):
        tr = transforms[name]  # strict: a hand-built table must be complete
        tgt_spec = plan.param_specs[name]
        if tr.cls is TransformClass.CONSOLIDATE:
            atom = engine.consolidated(
                source, name, kind,
                lambda: _contiguous(assemble_atom(source, src_params[name], kind, engine=engine)),
            )
            return [read_runtime_region(atom, tgt_spec, region, dtype, alloc=engine.alloc)
                    for region in regions]
        return [_stream_region(source, name, kind, tgt_spec, region, dtype, engine)
                for region in regions]

    return reader


def _stream_region(source, name, kind, tgt_spec, region, dtype, engine):
    # Stream: Source and Target share one runtime coordinate space.  Clip
    # to the logical shape and zero-fill the rest, so alignment padding
    # comes back as zeros, not as whatever the Source left there.
    region = _canon_region(region, tgt_spec.runtime_shape)
    shape = tuple(r.stop - r.start for r in region)
    clipped = clip_region_to_logical(region, tgt_spec.logical_shape)
    if clipped is None:  # region entirely inside padding
        return staging_like([], shape, dtype, zero=True, alloc=engine.alloc)
    reads, dests, full = clipped
    inner = read_region_from_source(source, name, kind, reads, dtype, engine=engine)
    if full:
        return inner
    out = staging_like([inner], shape, dtype, zero=True, alloc=engine.alloc)
    out[dests] = inner
    engine.recycle(inner)
    return out


def _consolidated(transforms: Mapping[str, ParamTransform] | None) -> frozenset[str]:
    """The params a plan table assembles in memory (none for DIRECT)."""
    return frozenset(name for name, tr in (transforms or {}).items()
                     if tr.cls is TransformClass.CONSOLIDATE)


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
        def reader(name, kind, regions, dtype):
            return [read_region_from_source(source, name, kind, region, dtype, engine=engine)
                    for region in regions]

        return reader
    return _stream_reader(source, plan, transforms, engine)


@contextlib.contextmanager
def _engine_for(source, device, engine: CheckpointEngine | None):
    """The caller's engine (whose caches the caller owns), else the
    device's default engine, which keeps nothing of ``source`` after the
    restore."""
    if engine is not None:
        yield engine
        return
    engine = default_engine(device)
    try:
        yield engine
    finally:
        engine.release(source)


def _coded_kinds(source) -> set[StateKind]:
    """The state kinds that have a coded shard in ``source``."""
    return {StateKind(key.rsplit("@", 1)[1])
            for key, tag in source.manifest.shard_codecs.items() if tag != "raw"}


class RestoreStats:
    """Bytes and arrays one restore served (the reference's accounting; the
    ``restore.bytes_read`` and ``restore.arrays`` counters count the same)."""

    def __init__(self):
        self.bytes_read = 0
        self.arrays = 0


_FIELDS = {StateKind.FP32: "params", StateKind.EXP_AVG: "exp_avg",
           StateKind.EXP_AVG_SQ: "exp_avg_sq"}


def _device_done(device: torch.device) -> None:
    """End a traced span after the card's queued work: CUDA work is
    asynchronous, so a span closed at enqueue would undercount it.  No sync
    while tracing is off (the disabled path stays free)."""
    if device.type == "cuda" and obs.active() is not None:
        torch.cuda.synchronize(device)


def _build_flat(
    reader, plan: ShardingPlan, kind: StateKind, device, engine: CheckpointEngine,
    *, pool: bool, whole: frozenset[str] = frozenset(), stats: RestoreStats | None = None,
    names=None,
) -> dict[str, torch.Tensor]:
    """One runtime-shaped tensor per parameter of ``kind`` on ``device``
    (of the parameters in ``names``, when given).

    Every (parameter, region) of the kind is read up front (through the
    engine's pool when ``pool``, else inline): one job a region, but one job
    for all the regions of a parameter in ``whole``, whose consolidated atom
    is then built once and cut for each (an atom larger than the engine's
    cache — mixtral-8x22b's expert tensors, 1.6-3.2 GB — would otherwise be
    evicted between concurrent region jobs and assembled, its coded shards
    decoded, again).  Then each region is copied into its tensor (a host
    region goes to the device once) and its staging buffer recycled.
    Batching per kind bounds the staging to one copy of that kind.

    The two halves are the reference's ``restore.prefetch`` (reads,
    assembly, decode) and ``restore.materialize`` (the copies into the
    device tensors) spans; on a card each closes after a synchronize while
    a tracer is enabled."""
    jobs = []
    for name, spec in plan.param_specs.items():
        if names is not None and name not in names:
            continue
        regions = target_regions(spec, plan.mesh, kind)
        groups = [regions] if name in whole else [[region] for region in regions]
        jobs += [(name, spec.states[kind].dtype, group) for group in groups]

    def read(job):
        return reader(job[0], kind, job[2], job[1])

    field = _FIELDS[kind]
    with obs.span("restore.prefetch", field=field, regions=sum(len(j[2]) for j in jobs)):
        pieces = engine.map(read, jobs) if pool else [read(j) for j in jobs]
        _device_done(device)
    out: dict[str, torch.Tensor] = {}
    with obs.span("restore.materialize", field=field):
        for i, (name, dtype, regions) in enumerate(jobs):
            full = out.get(name)
            if full is None:
                shape = plan.param_specs[name].runtime_shape
                full = out[name] = torch.empty(shape, dtype=torch_dtype(dtype), device=device)
                if stats is not None:
                    stats.arrays += 1
                obs.add("restore.arrays")
            for region, piece in zip(regions, pieces[i]):
                n = array_nbytes(piece)
                if stats is not None:
                    stats.bytes_read += n
                obs.add("restore.bytes_read", n)
                full[region] = to_staging(full, piece)
                engine.recycle(piece)
            pieces[i] = None
        _device_done(device)
    return out


def build_param_arrays(
    source,
    plan: ShardingPlan,
    device: str | torch.device,
    *,
    transforms: Mapping[str, ParamTransform] | None = None,
    names=None,
    stats: RestoreStats | None = None,
    engine: CheckpointEngine | None = None,
) -> dict[str, torch.Tensor]:
    """The serving side's building block: flat ``{name: tensor}`` of
    runtime-shaped fp32 weights on ``device``, no optimizer moments.

    ``transforms=None`` means the source layout equals the Target plan's
    (DIRECT); a plan table from
    :func:`~repro_torch.core.plan.stream_transforms` streams a layout change
    (RESHARD_STREAM).  ``names`` restricts the restore to a subset of the
    parameters: how a delta publication updates a live replica in place."""
    with _engine_for(source, device, engine) as engine:
        return _build_flat(_reader_for(source, plan, transforms, engine), plan,
                           StateKind.FP32, torch.device(device), engine,
                           pool=StateKind.FP32 in _coded_kinds(source),
                           whole=_consolidated(transforms), stats=stats, names=names)


def params_from_source(
    source,
    plan: ShardingPlan,
    device: str | torch.device,
    *,
    transforms: Mapping[str, ParamTransform] | None = None,
    engine: CheckpointEngine | None = None,
    stats: RestoreStats | None = None,
) -> dict[str, torch.Tensor]:
    """Weights-only restore: flat ``{name: tensor}`` of runtime-shaped fp32
    weights on ``device`` (:func:`build_param_arrays` of every parameter).
    The bytes are the ``.params`` of a full restore."""
    return build_param_arrays(source, plan, device, transforms=transforms, stats=stats,
                              engine=engine)


def _build_state(
    reader, plan, device, step: int, engine: CheckpointEngine, coded: set[StateKind],
    whole: frozenset[str] = frozenset(), stats: RestoreStats | None = None,
) -> TrainState:
    trees = {
        kind: unflatten_from_paths(
            _build_flat(reader, plan, kind, device, engine, pool=kind in coded, whole=whole,
                        stats=stats))
        for kind in (StateKind.FP32, StateKind.EXP_AVG, StateKind.EXP_AVG_SQ)
    }
    return TrainState(
        params=trees[StateKind.FP32],
        exp_avg=trees[StateKind.EXP_AVG],
        exp_avg_sq=trees[StateKind.EXP_AVG_SQ],
        step=step,
    )


def _ucp_reader(ucp, plan: ShardingPlan, engine: CheckpointEngine):
    # every Target param has an atom of its logical shape, or this raises
    gen_ucp_metadata(plan.param_specs, plan.mesh, ucp.manifest.atoms)

    def reader(name, kind, regions, dtype):
        atom = engine.read_atom(ucp, name, kind)
        return [read_runtime_region(atom, plan.param_specs[name], region, dtype,
                                    alloc=engine.alloc) for region in regions]

    return reader


def state_from_source(
    source,
    plan: ShardingPlan,
    device: str | torch.device,
    *,
    engine: CheckpointEngine | None = None,
    stats: RestoreStats | None = None,
) -> TrainState:
    """DIRECT (and HOT_DIRECT): the full TrainState (params, both moments,
    step) on ``device``, from straight fragment unions of any fragment
    source — shard files, or a hot snapshot's surviving replicas."""
    device = torch.device(device)
    with _engine_for(source, device, engine) as engine:
        reader = _reader_for(source, plan, None, engine)
        return _build_state(reader, plan, device, int(source.manifest.step), engine,
                            _coded_kinds(source), stats=stats)


def state_from_stream(
    source,
    plan: ShardingPlan,
    device: str | torch.device,
    transforms: Mapping[str, ParamTransform],
    *,
    engine: CheckpointEngine | None = None,
    stats: RestoreStats | None = None,
) -> TrainState:
    """RESHARD_STREAM (and HOT_RESHARD): the full TrainState under a changed
    layout, with no intermediate checkpoint.  Per the plan table,
    ``IDENTITY``/``RESLICE`` params stream Source fragments (clipped to the
    logical shape, padding zero-filled) and ``CONSOLIDATE`` params are
    assembled in memory — on the card for coded kinds — and served from the
    atom."""
    device = torch.device(device)
    with _engine_for(source, device, engine) as engine:
        reader = _reader_for(source, plan, transforms, engine)
        return _build_state(reader, plan, device, int(source.manifest.step), engine,
                            _coded_kinds(source), _consolidated(transforms), stats)


def state_from_ucp(
    ucp,
    plan: ShardingPlan,
    device: str | torch.device,
    *,
    engine: CheckpointEngine | None = None,
    stats: RestoreStats | None = None,
) -> TrainState:
    """VIA_UCP: the full TrainState on ``device`` from a UCP atom checkpoint
    (any Source layout; the Target plan's logical shapes must match the
    atoms')."""
    device = torch.device(device)
    with _engine_for(ucp, device, engine) as engine:
        reader = _ucp_reader(ucp, plan, engine)  # atoms are raw: read inline
        return _build_state(reader, plan, device, int(ucp.manifest.step), engine, set(),
                            stats=stats)


def params_from_ucp(
    ucp,
    plan: ShardingPlan,
    device: str | torch.device,
    *,
    engine: CheckpointEngine | None = None,
) -> dict[str, torch.Tensor]:
    """Weights-only VIA_UCP restore: flat ``{name: tensor}`` of runtime-shaped
    fp32 weights on ``device``, read from the ``fp32`` atoms alone — the
    ``.params`` of :func:`state_from_ucp`."""
    device = torch.device(device)
    with _engine_for(ucp, device, engine) as engine:
        return _build_flat(_ucp_reader(ucp, plan, engine), plan, StateKind.FP32, device, engine,
                           pool=False)
