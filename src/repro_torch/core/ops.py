"""The UCP transformation operators used on the restore path
(port of part of ``repro.core.ops``).

``strip_padding``           remove alignment padding (runtime → logical shape)
                            and collapse the replica dim of ``params_to_average``
``clip_region_to_logical``  the canonical-padding rule of every load path
``read_runtime_region``     serve a runtime-coordinate region from an atom
``gen_ucp_metadata``        the Target-side fragment geometry (``LoadPlan``)

Numpy, as in the reference; an atom that is a torch tensor (coded moments
decoded on the card) stays a tensor on its device.  ``extract``, ``union`` and
``load_param_shard`` wait for the UCP export path (ROADMAP queue 1, item 3:
the rest of the checkpoint path).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from .layout import MeshSpec, ShardLayout
from .patterns import ParamSpec, StateKind
from .tensor_io import staging_like

__all__ = [
    "strip_padding",
    "clip_region_to_logical",
    "read_runtime_region",
    "gen_ucp_metadata",
    "LoadPlan",
    "ParamLoadPlan",
]


def strip_padding(runtime_atom: np.ndarray, spec: ParamSpec) -> np.ndarray:
    """Runtime-shaped consolidated tensor → logical atom.

    Crops per-dim alignment padding; for ``params_to_average`` averages the
    leading replica dim (Algorithm 1: ``Sum(fp_1..fp_n)/n``).
    """
    crop = tuple(slice(0, s) for s in spec.logical_shape)
    if spec.average and isinstance(runtime_atom, torch.Tensor):
        return runtime_atom.to(torch.float64).mean(dim=0)[crop].to(runtime_atom.dtype)
    if spec.average:
        body = runtime_atom.astype(np.float64).mean(axis=0)
        return body[crop].astype(runtime_atom.dtype)
    return runtime_atom[crop]


@dataclasses.dataclass(frozen=True)
class ParamLoadPlan:
    """Target-side geometry of one parameter state (paper: GenUcpMetadata)."""

    name: str
    kind: StateKind
    spec: ParamSpec
    layout: ShardLayout
    target_dtype: str


@dataclasses.dataclass(frozen=True)
class LoadPlan:
    mesh: MeshSpec
    params: dict[str, dict[StateKind, ParamLoadPlan]]


def gen_ucp_metadata(
    target_params: Mapping[str, ParamSpec], target_mesh: MeshSpec
) -> LoadPlan:
    """Partition metadata for every (param, kind) on the Target.  (The
    reference's optional validation against a UCP atom index comes with the
    VIA_UCP path.)"""
    return LoadPlan(
        mesh=target_mesh,
        params={
            name: {
                kind: ParamLoadPlan(
                    name=name,
                    kind=kind,
                    spec=spec,
                    layout=spec.layout_for(kind, target_mesh),
                    target_dtype=st.dtype,
                )
                for kind, st in spec.states.items()
            }
            for name, spec in target_params.items()
        },
    )


def clip_region_to_logical(
    region: Sequence[slice], logical_shape: Sequence[int]
) -> tuple[tuple[slice, ...], tuple[slice, ...], bool] | None:
    """Clip a canonical runtime-coordinate region to the logical tensor.

    Alignment padding beyond ``logical_shape`` is zero-filled, never served
    from stored bytes.  Returns ``(reads, dests, full)`` — the in-logical
    sub-region to read, where it lands in the output, and whether it covers
    the whole region — or None when the region lies entirely in padding.
    """
    reads: list[slice] = []
    dests: list[slice] = []
    full = True
    for r, lim in zip(region, logical_shape):
        hi = min(r.stop, lim)
        if hi <= r.start:
            return None
        if hi < r.stop:
            full = False
        reads.append(slice(r.start, hi))
        dests.append(slice(0, hi - r.start))
    return tuple(reads), tuple(dests), full


def read_runtime_region(atom, spec: ParamSpec, region: tuple[slice, ...], dtype):
    """Read a runtime-coordinate region from a logical atom (numpy, or a
    tensor whose device the region stays on), zero-filling alignment
    padding and broadcasting the replica dim of ``params_to_average``
    parameters."""
    rt = spec.runtime_shape
    region = tuple(slice(*r.indices(s)) for r, s in zip(region, rt))
    shape = tuple(r.stop - r.start for r in region)
    body = region[1:] if spec.average else region
    clipped = clip_region_to_logical(body, spec.logical_shape)
    if clipped is None:  # region entirely inside padding
        return staging_like([atom], shape, dtype, zero=True)
    reads, dests, full = clipped
    out = staging_like([atom], shape, dtype, zero=not full)
    piece = atom[reads]
    if spec.average:
        out[(slice(None), *dests)] = piece[None]
    else:
        out[dests] = piece
    return out
