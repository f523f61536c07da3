"""The UCP atom-checkpoint format (paper §3.1), port of ``repro.core.atoms``.

An atom checkpoint is the consolidated, parallelism-agnostic representation
of one parameter: up to three tensor files (``fp32`` master weight,
``exp_avg``, ``exp_avg_sq``) plus enough metadata to re-fragment it onto
any Target.

Layout on disk, file for file and JSON key for JSON key the reference's::

    <ucp_dir>/
        MANIFEST.json              # step, scalars, atom index, provenance
        atoms/<param.name>/fp32.npy
        atoms/<param.name>/exp_avg.npy
        atoms/<param.name>/exp_avg_sq.npy
        COMMIT                     # written last

Atoms store the *logical* shape — alignment padding stripped, the replica
dimension of ``params_to_average`` parameters averaged out — which is why a
Target with another mesh, TP width, vocab-padding multiple or precision
policy can consume them.  An atom directory written by either package reads
in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Mapping

from . import clock, codec
from .patterns import STATE_KINDS, StateKind
from .tensor_io import digest_matches, load_tensor, open_memmap, save_tensor

__all__ = ["AtomInfo", "UcpManifest", "UcpCheckpoint", "UCP_FORMAT_VERSION"]

UCP_FORMAT_VERSION = "repro-ucp/v1"


@dataclasses.dataclass(frozen=True)
class AtomInfo:
    """Index entry for one atom (one parameter).

    ``digests`` maps state kind → content digest (``sha256:...``; older
    manifests ``crc32:...``) of the atom tensor, recorded by
    ``convert_to_ucp`` and checked by :meth:`UcpCheckpoint.validate`.
    ``codecs`` maps state kind → codec tag (absent == ``raw``): conversion
    writes raw atoms, so only external writers fill it in; a coded atom is
    decoded where it is read.
    """

    name: str
    logical_shape: tuple[int, ...]
    dtypes: dict[StateKind, str]  # dtype each state kind is stored as
    stacked_dim: int | None = None
    kind: str = "dense"
    digests: dict[StateKind, str] = dataclasses.field(default_factory=dict)
    codecs: dict[StateKind, str] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        out = {
            "name": self.name,
            "logical_shape": list(self.logical_shape),
            "dtypes": {k.value: v for k, v in self.dtypes.items()},
            "stacked_dim": self.stacked_dim,
            "kind": self.kind,
            "digests": {k.value: v for k, v in self.digests.items()},
        }
        if self.codecs:  # sparse: all-raw manifests round-trip unchanged
            out["codecs"] = {k.value: v for k, v in self.codecs.items()}
        return out

    @classmethod
    def from_json(cls, d: Mapping) -> "AtomInfo":
        return cls(
            name=str(d["name"]),
            logical_shape=tuple(int(x) for x in d["logical_shape"]),
            dtypes={StateKind(k): str(v) for k, v in d["dtypes"].items()},
            stacked_dim=d.get("stacked_dim"),
            kind=str(d.get("kind", "dense")),
            digests={StateKind(k): str(v) for k, v in d.get("digests", {}).items()},
            codecs={StateKind(k): str(v) for k, v in d.get("codecs", {}).items()},
        )


@dataclasses.dataclass
class UcpManifest:
    step: int
    atoms: dict[str, AtomInfo]
    scalars: dict[str, Any]
    provenance: dict[str, Any]  # source mesh / config fingerprint / ckpt path
    format_version: str = UCP_FORMAT_VERSION
    created_at: float = 0.0

    def to_json(self) -> dict:
        return {
            "format_version": self.format_version,
            "step": self.step,
            "atoms": {n: a.to_json() for n, a in self.atoms.items()},
            "scalars": self.scalars,
            "provenance": self.provenance,
            "created_at": self.created_at,
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "UcpManifest":
        if d.get("format_version") != UCP_FORMAT_VERSION:
            raise ValueError(f"unsupported UCP format {d.get('format_version')!r}")
        return cls(
            step=int(d["step"]),
            atoms={n: AtomInfo.from_json(a) for n, a in d["atoms"].items()},
            scalars=dict(d["scalars"]),
            provenance=dict(d["provenance"]),
            created_at=float(d.get("created_at", 0.0)),
        )


class UcpCheckpoint:
    """Reader/writer for a universal (atom) checkpoint directory."""

    def __init__(self, root: str | os.PathLike, manifest: UcpManifest):
        self.root = Path(root)
        self.manifest = manifest

    # ------------------------------------------------------------------ paths
    def atom_dir(self, name: str) -> Path:
        return self.root / "atoms" / name

    def atom_path(self, name: str, kind: StateKind) -> Path:
        return self.atom_dir(name) / f"{kind.value}.npy"

    @property
    def commit_path(self) -> Path:
        return self.root / "COMMIT"

    @property
    def is_committed(self) -> bool:
        return self.commit_path.exists()

    # ------------------------------------------------------------------ write
    @classmethod
    def create(cls, root: str | os.PathLike, manifest: UcpManifest) -> "UcpCheckpoint":
        root = Path(root)
        (root / "atoms").mkdir(parents=True, exist_ok=True)
        manifest.created_at = clock.now()
        ckpt = cls(root, manifest)
        ckpt._write_manifest()
        return ckpt

    def _write_manifest(self) -> None:
        tmp = self.root / "MANIFEST.json.tmp"
        tmp.write_text(json.dumps(self.manifest.to_json(), indent=1))
        os.replace(tmp, self.root / "MANIFEST.json")

    def write_atom(self, name: str, kind: StateKind, arr) -> int:
        """Write one atom (a numpy array, or a tensor of any dtype: it is
        copied to the host first); returns its bytes."""
        self.atom_dir(name).mkdir(parents=True, exist_ok=True)
        save_tensor(self.atom_path(name, kind), arr)
        return arr.nbytes

    def create_atom_memmap(self, name: str, kind: StateKind, shape: tuple[int, ...], dtype: str):
        """Open a writable atom for streaming Union (constant working memory;
        an extended dtype's atom is the void of its width, under the
        reference's ``.npy`` header)."""
        self.atom_dir(name).mkdir(parents=True, exist_ok=True)
        return open_memmap(self.atom_path(name, kind), shape, dtype)

    def commit(self) -> None:
        tmp = self.root / "COMMIT.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"step": self.manifest.step, "t": clock.now()}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.commit_path)

    # ------------------------------------------------------------------- read
    @classmethod
    def open(cls, root: str | os.PathLike) -> "UcpCheckpoint":
        root = Path(root)
        manifest = UcpManifest.from_json(json.loads((root / "MANIFEST.json").read_text()))
        return cls(root, manifest)

    def read_atom(
        self, name: str, kind: StateKind, *, mmap: bool = True, device=None, cache=None
    ):
        """Open one atom: a raw numpy atom as a (mmap'd) array, a bf16/fp8 one
        as a CPU tensor; a coded atom decoded at the read point, on
        ``device`` when that is a CUDA device (the dequantize kernel).
        ``cache``: an optional :class:`~repro_torch.core.engine.HandleCache`
        — a restore serving R regions of a parameter then opens its atom
        once."""
        info = self.manifest.atoms[name]
        path = self.atom_path(name, kind)
        tag = info.codecs.get(kind, "raw")
        if tag == "raw":
            loader = lambda: load_tensor(path, dtype=info.dtypes[kind], mmap=mmap)
        else:
            loader = lambda: codec.decode_file(path, tag, dtype=info.dtypes[kind], device=device)
        if cache is not None:
            return cache.get(path, loader)
        return loader()

    def validate(self) -> list[str]:
        """Integrity check: every indexed atom file exists with the right
        shape, and (when the manifest carries digests) its content bytes
        match the digest recorded at conversion time."""
        problems: list[str] = []
        for name, info in self.manifest.atoms.items():
            for kind in STATE_KINDS:
                if kind not in info.dtypes:
                    continue
                p = self.atom_path(name, kind)
                if not p.exists():
                    problems.append(f"missing atom file {p}")
                    continue
                arr = self.read_atom(name, kind)
                if tuple(arr.shape) != tuple(info.logical_shape):
                    problems.append(
                        f"{name}@{kind.value}: shape {tuple(arr.shape)} != {info.logical_shape}"
                    )
                    continue
                want = info.digests.get(kind)
                if want is not None and not digest_matches(arr, want):
                    problems.append(
                        f"{name}@{kind.value}: content digest mismatch (recorded {want})"
                    )
        return problems

