"""Mesh strings (port of ``repro.launch.mesh``).

The reference builds a JAX device mesh from ``--mesh``; on one card the
port only needs the mesh's description, a
:class:`~repro_torch.core.layout.MeshSpec`, which sets the checkpoint
geometry.
"""

from __future__ import annotations

from repro_torch.core.layout import MeshSpec

__all__ = ["parse_mesh_string", "mesh_spec_from_string"]


def parse_mesh_string(s: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """'data=4,model=2' → (('data','model'), (4,2))."""
    names, sizes = [], []
    for part in s.split(","):
        k, v = part.split("=")
        names.append(k.strip())
        sizes.append(int(v))
    return tuple(names), tuple(sizes)


def mesh_spec_from_string(s: str) -> MeshSpec:
    names, sizes = parse_mesh_string(s)
    return MeshSpec(tuple(zip(names, sizes)))
