"""Consolidation of one parameter state (port of ``repro.core.convert``).

:func:`assemble_atom` is the per-parameter transform kernel of paper
Algorithm 1, shared in the reference by the UCP export and by the
in-memory consolidation of the streaming reshard.  The port uses it for the
latter; the ``convert_to_ucp`` export waits for ROADMAP queue 1, item 3.
"""

from __future__ import annotations

import numpy as np

from .engine import CheckpointEngine
from .ops import strip_padding
from .patterns import ParamSpec, StateKind
from .tensor_io import staging_like, to_staging

__all__ = ["assemble_atom"]


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
    make the atom a tensor on that card.
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
        out[...] = atom
        atom = out
    return atom
