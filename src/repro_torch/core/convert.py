"""Distributed checkpoint → UCP conversion (paper Algorithm 1), port of
``repro.core.convert``.

:func:`convert_to_ucp` is the explicit export tool
(``CheckpointManager.export_ucp``) and the resume fallback of last resort:
the resume hot path streams Source fragments straight into the Target
layout (RESHARD_STREAM) and never writes atoms.  The per-parameter
transform kernel is shared: :func:`assemble_atom` consolidates one
parameter state from any fragment source, and both the export here and the
in-memory consolidation of the stream restore
(``repro_torch.ckpt.restore.state_from_stream``) call it, so the two paths
give the same bytes by construction.

Parallelism: Union is independent per parameter (paper: "can execute in
parallel at individual parameter level"), so ``convert_to_ucp`` fans the
parameters out over the engine's worker pool; ``workers=1`` is the
reference's serial profile.  ``streaming=True`` unions a parameter that
needs no strip or average straight into a memory-mapped atom file
(constant working memory).  Coded moment shards read through an engine made
for a CUDA device are decoded on the card (the dequantize kernel, launched
from the worker that converts the parameter) and their atom comes to the
host to be written.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from .atoms import AtomInfo, UcpCheckpoint, UcpManifest
from .dist_ckpt import DistCheckpoint
from .engine import CheckpointEngine
from .ops import strip_padding
from .patterns import STATE_KINDS, ParamSpec, StateKind
from .tensor_io import content_digest, staging_like, to_staging, torch_dtype

__all__ = ["ConvertStats", "assemble_atom", "convert_to_ucp"]


def assemble_atom(
    source,
    spec: ParamSpec,
    kind: StateKind,
    *,
    out: np.ndarray | None = None,
    engine: CheckpointEngine | None = None,
) -> np.ndarray:
    """Consolidate one parameter state into its (logical) atom.

    Scatters every available fragment of ``source`` into a runtime-shaped
    buffer (replicated and unique params have one distinct fragment, which
    is the atom; fragment params concatenate, fused sub-fragments and stage
    partitions included), then strips the padding (and averages replicas of
    ``params_to_average``).  ``out``: optional destination of logical
    shape; when no strip or average is needed, fragments go straight in.
    Fragments decoded on a card (coded shards read through a CUDA engine)
    make the atom a tensor on that card, unless ``out`` is a host array.
    """
    mesh = source.manifest.mesh
    layout = spec.layout_for(kind, mesh)
    direct = (
        out is not None
        and not spec.average
        and tuple(spec.runtime_shape) == tuple(spec.logical_shape)
    )
    shards = [
        (rank, engine.read_fragment(source, rank, spec.name, kind) if engine is not None
         else source.read_fragment(rank, spec.name, kind))
        for rank in source.writing_ranks(spec.name, kind)
    ]
    target = out if direct else staging_like(
        [s for _, s in shards], spec.runtime_shape, spec.states[kind].dtype, zero=True
    )
    for rank, shard in shards:
        for e in layout.entries[rank]:
            target[e.atom_index()] = to_staging(target, shard[e.shard_index()])

    atom = target if direct else strip_padding(target, spec)
    if out is not None and not direct:
        out[...] = to_staging(out, atom)
        atom = out
    return atom


@dataclasses.dataclass
class ConvertStats:
    params: int = 0
    atoms_written: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    wall_time_s: float = 0.0

    def throughput_mb_s(self) -> float:
        if self.wall_time_s == 0:
            return float("inf")
        return (self.bytes_written / 1e6) / self.wall_time_s


def _convert_one(
    ckpt: DistCheckpoint,
    ucp: UcpCheckpoint,
    spec: ParamSpec,
    streaming: bool,
    engine: CheckpointEngine,
) -> tuple[int, int, int, dict[StateKind, str]]:
    """Union + StripPadding + Save for one parameter (all state kinds).

    Returns ``(bytes_read, bytes_written, atoms_written, digests)`` — one
    atom file per state kind the parameter carries; ``digests`` records each
    atom's content digest for the manifest."""
    read = written = atoms = 0
    digests: dict[StateKind, str] = {}
    for kind in STATE_KINDS:
        if kind not in spec.states:
            continue
        dtype = spec.states[kind].dtype
        can_stream = (
            streaming
            and not spec.average
            and tuple(spec.runtime_shape) == tuple(spec.logical_shape)
        )
        if can_stream:
            out = ucp.create_atom_memmap(spec.name, kind, tuple(spec.logical_shape), dtype)
            atom = assemble_atom(ckpt, spec, kind, out=out, engine=engine)
            out.flush()
        else:
            atom = assemble_atom(ckpt, spec, kind, engine=engine)
            if isinstance(atom, torch.Tensor):
                atom = atom.contiguous().cpu()  # off the card once, then hashed and written
            else:
                atom = np.ascontiguousarray(atom)
            ucp.write_atom(spec.name, kind, atom)
        digests[kind] = content_digest(atom)
        item = torch.empty(0, dtype=torch_dtype(dtype)).element_size()
        read += int(np.prod(spec.runtime_shape)) * item
        written += atom.nbytes
        atoms += 1
    return read, written, atoms, digests


def convert_to_ucp(
    ckpt: DistCheckpoint | str,
    out_dir: str,
    *,
    names: Sequence[str] | None = None,
    workers: int | None = None,
    streaming: bool = True,
    engine: CheckpointEngine | None = None,
) -> tuple[UcpCheckpoint, ConvertStats]:
    """Convert a committed distributed checkpoint into a UCP atom checkpoint.

    Algorithm 1: per parameter, pattern-match → Union → StripPadding →
    Save, parallel at parameter granularity.  ``engine`` supplies the
    worker pool and the handle cache, and decodes coded shards (on its
    card, if it has one).  An explicit ``workers`` that disagrees with the
    engine's width wins (a private pool on the engine's device serves this
    call), as in ``write_distributed``; with neither, a private host pool
    of width 4.  The atoms' content digests land in the manifest before
    COMMIT.
    """
    if isinstance(ckpt, (str, Path)):
        ckpt = DistCheckpoint.open(ckpt)
    if not ckpt.is_committed:
        raise ValueError(f"refusing to convert uncommitted checkpoint {ckpt.root}")

    manifest = ckpt.manifest
    wanted = set(names) if names is not None else None
    todo = {n: s for n, s in manifest.params.items() if wanted is None or n in wanted}
    atoms = {
        n: AtomInfo(
            name=n,
            logical_shape=tuple(s.logical_shape),
            dtypes={k: st.dtype for k, st in s.states.items()},
            stacked_dim=s.stacked_dim,
            kind=s.kind,
        )
        for n, s in todo.items()
    }
    ucp = UcpCheckpoint.create(
        out_dir,
        UcpManifest(
            step=manifest.step,
            atoms=atoms,
            scalars=dict(manifest.scalars),
            provenance={
                "source_checkpoint": str(ckpt.root),
                "source_mesh": manifest.mesh.to_json(),
                "source_config": manifest.config_fingerprint,
                "source_save_mode": manifest.save_mode,
            },
        ),
    )

    t0 = time.perf_counter()
    owns_engine = False
    if workers is not None and (engine is None or engine.workers != workers):
        device = engine.device if engine is not None else None
        engine = CheckpointEngine(device, workers=max(1, workers))
        owns_engine = True
    elif engine is None:
        engine = CheckpointEngine(workers=4)
        owns_engine = True
    stats = ConvertStats(params=len(todo))
    specs = list(todo.values())
    try:
        results = engine.map(lambda s: _convert_one(ckpt, ucp, s, streaming, engine), specs)
    finally:
        if owns_engine:
            engine.close()
    for spec, (r, w, a, digests) in zip(specs, results):
        stats.bytes_read += r
        stats.bytes_written += w
        stats.atoms_written += a
        ucp.manifest.atoms[spec.name] = dataclasses.replace(
            ucp.manifest.atoms[spec.name], digests=digests
        )
    ucp._write_manifest()  # digests land before COMMIT
    ucp.commit()
    stats.wall_time_s = time.perf_counter() - t0
    return ucp, stats
