"""Mesh strings (port of ``repro.launch.mesh``).

The reference builds a JAX device mesh from ``--mesh``; on one card the
port only needs the mesh's description, a
:class:`~repro_torch.core.layout.MeshSpec`, which sets the checkpoint
geometry.  :func:`make_production_mesh` describes the dry run's production
topology (``repro_torch.launch.dryrun``) the same way: no device is touched.
"""

from __future__ import annotations

from repro_torch.core.layout import MeshSpec

__all__ = ["make_production_mesh", "parse_mesh_string", "mesh_spec_from_string"]


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production topology: 16×16 = 256 ranks over
    ``data × model``, or two of them, 2×16×16 = 512, with a leading ``pod``
    axis.  A description only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(tuple(zip(axes, shape)))


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
