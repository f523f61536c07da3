"""The *distributed* checkpoint format (port of ``repro.core.dist_ckpt``).

Layout on disk, byte-compatible with the JAX package::

    <ckpt_dir>/step_<N>/
        MANIFEST.json                      # mesh, param specs, scalars, config
        ranks/rank_00000/<name>@<kind>.npy # local (padded) shard arrays
        ...
        COMMIT                             # written last: atomic completion

Every rank persists exactly the shards it owns; replicated fragments are
written once, by the lowest rank of each replica group (``save_mode="dedup"``).

The port reads every manifest the reference writes, delta provenance
included (``shard_sources``/``base_dirs`` resolve a shard to the step
directory that holds its bytes).  :meth:`DistCheckpoint.read_shard` is the
one decode point of coded shards (:mod:`repro_torch.core.codec`): every
reader above it serves coded checkpoints unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from . import clock, codec
from .layout import MeshSpec, ShardLayout
from .patterns import ParamSpec, StateKind
from .tensor_io import content_digest, load_tensor, save_tensor

__all__ = [
    "DistManifest",
    "DistCheckpoint",
    "shard_filename",
    "shard_digest_key",
    "writing_ranks_for",
    "FORMAT_VERSION",
]

FORMAT_VERSION = "repro-dist/v1"


def shard_filename(name: str, kind: StateKind) -> str:
    return f"{name}@{kind.value}.npy"


def shard_digest_key(rank: int, name: str, kind: StateKind) -> str:
    """Manifest key of one shard's content digest (mirrors the file layout)."""
    return f"rank_{rank:05d}/{name}@{kind.value}"


def writing_ranks_for(spec: ParamSpec, layout: ShardLayout, save_mode: str) -> list[int]:
    """Which ranks persist one (param, kind) under ``save_mode``.

    ``average`` params never dedup: every replica holds different data.
    """
    if save_mode == "all" or spec.average:
        return [r for r in layout.mesh.ranks() if layout.entries[r]]
    return [r for r in layout.primary_ranks() if layout.entries[r]]


@dataclasses.dataclass
class DistManifest:
    """Self-describing header of a distributed checkpoint.

    Field for field the reference's ``DistManifest``; :meth:`to_json` emits
    the same keys (the sparse codec and delta tables only when non-empty),
    so ``repro.core.dist_ckpt.DistManifest.from_json`` reads what this
    writes and vice versa.
    """

    step: int
    mesh: MeshSpec
    params: dict[str, ParamSpec]
    scalars: dict[str, Any]
    config_fingerprint: dict[str, Any]
    save_mode: str = "dedup"  # "dedup" | "all" | "delta"
    format_version: str = FORMAT_VERSION
    created_at: float = 0.0
    shard_digests: dict[str, str] = dataclasses.field(default_factory=dict)
    shard_codecs: dict[str, str] = dataclasses.field(default_factory=dict)
    shard_pre_digests: dict[str, str] = dataclasses.field(default_factory=dict)
    base_step: int | None = None
    shard_sources: dict[str, int] = dataclasses.field(default_factory=dict)
    base_dirs: dict[str, str] = dataclasses.field(default_factory=dict)

    def codec_tag(self, key: str) -> str:
        """Codec tag of one shard (``"raw"`` when absent from the table)."""
        return self.shard_codecs.get(key, "raw")

    def to_json(self) -> dict:
        out = {
            "format_version": self.format_version,
            "step": self.step,
            "mesh": self.mesh.to_json(),
            "params": {n: p.to_json() for n, p in self.params.items()},
            "scalars": self.scalars,
            "config_fingerprint": self.config_fingerprint,
            "save_mode": self.save_mode,
            "created_at": self.created_at,
            "shard_digests": self.shard_digests,
        }
        if self.shard_codecs:
            out["shard_codecs"] = self.shard_codecs
        if self.shard_pre_digests:
            out["shard_pre_digests"] = self.shard_pre_digests
        if self.base_step is not None:
            out["base_step"] = self.base_step
            out["shard_sources"] = self.shard_sources
            out["base_dirs"] = self.base_dirs
        return out

    @classmethod
    def from_json(cls, d: Mapping) -> "DistManifest":
        if d.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint format {d.get('format_version')!r}")
        return cls(
            step=int(d["step"]),
            mesh=MeshSpec.from_json(d["mesh"]),
            params={n: ParamSpec.from_json(p) for n, p in d["params"].items()},
            scalars=dict(d["scalars"]),
            config_fingerprint=dict(d["config_fingerprint"]),
            save_mode=str(d.get("save_mode", "dedup")),
            created_at=float(d.get("created_at", 0.0)),
            shard_digests={str(k): str(v) for k, v in d.get("shard_digests", {}).items()},
            shard_codecs={str(k): str(v) for k, v in d.get("shard_codecs", {}).items()},
            shard_pre_digests={
                str(k): str(v) for k, v in d.get("shard_pre_digests", {}).items()
            },
            base_step=int(d["base_step"]) if d.get("base_step") is not None else None,
            shard_sources={str(k): int(v) for k, v in d.get("shard_sources", {}).items()},
            base_dirs={str(k): str(v) for k, v in d.get("base_dirs", {}).items()},
        )


class DistCheckpoint:
    """Reader/writer for one committed (or in-progress) distributed checkpoint."""

    def __init__(self, root: str | os.PathLike, manifest: DistManifest):
        self.root = Path(root)
        self.manifest = manifest

    # ------------------------------------------------------------------ paths
    def rank_dir(self, rank: int) -> Path:
        return self.root / "ranks" / f"rank_{rank:05d}"

    def own_shard_path(self, rank: int, name: str, kind: StateKind) -> Path:
        """Where this checkpoint *writes* the shard (never an ancestor's tree)."""
        return self.rank_dir(rank) / shard_filename(name, kind)

    def shard_path(self, rank: int, name: str, kind: StateKind) -> Path:
        """Chain-resolved read path of one shard (provenance is flattened at
        save time, so this is one hop)."""
        owner = self.manifest.shard_sources.get(shard_digest_key(rank, name, kind))
        if owner is None:
            return self.own_shard_path(rank, name, kind)
        base = self.root.parent / self.manifest.base_dirs[str(owner)]
        return base / "ranks" / f"rank_{rank:05d}" / shard_filename(name, kind)

    @property
    def commit_path(self) -> Path:
        return self.root / "COMMIT"

    @property
    def is_committed(self) -> bool:
        return self.commit_path.exists()

    @property
    def cache_key(self) -> str:
        """Engine index-cache identity (a delta's key names its base step)."""
        if self.manifest.base_step is None:
            return str(self.root)
        return f"{self.root}@delta:{self.manifest.base_step}"

    # ------------------------------------------------------------------ write
    @classmethod
    def create(cls, root: str | os.PathLike, manifest: DistManifest) -> "DistCheckpoint":
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        manifest.created_at = clock.now()
        ckpt = cls(root, manifest)
        ckpt.rewrite_manifest()
        return ckpt

    def rewrite_manifest(self) -> None:
        """(Re)write MANIFEST.json atomically."""
        tmp = self.root / "MANIFEST.json.tmp"
        tmp.write_text(json.dumps(self.manifest.to_json(), indent=1))
        os.replace(tmp, self.root / "MANIFEST.json")

    def write_shard(
        self, rank: int, name: str, kind: StateKind, shard: np.ndarray,
        *, fsync: bool = True,
    ) -> int:
        """Persist one rank's local shard; returns bytes written."""
        self.rank_dir(rank).mkdir(parents=True, exist_ok=True)
        save_tensor(self.own_shard_path(rank, name, kind), shard, fsync=fsync)
        return shard.nbytes

    def writing_ranks(self, name: str, kind: StateKind) -> list[int]:
        """Which ranks persist this (param, kind) under the manifest save_mode."""
        spec = self.manifest.params[name]
        layout = spec.layout_for(kind, self.manifest.mesh)
        return writing_ranks_for(spec, layout, self.manifest.save_mode)

    def commit(self) -> None:
        """Atomic completion marker, written last and fsync'd.  A directory
        without COMMIT is garbage to discovery (crash-during-save safety)."""
        tmp = self.root / "COMMIT.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"step": self.manifest.step, "t": clock.now()}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.commit_path)

    # ------------------------------------------------------------------- read
    @classmethod
    def open(cls, root: str | os.PathLike) -> "DistCheckpoint":
        root = Path(root)
        manifest = DistManifest.from_json(json.loads((root / "MANIFEST.json").read_text()))
        return cls(root, manifest)

    def read_shard(
        self, rank: int, name: str, kind: StateKind, *, mmap: bool = True, device=None
    ):
        """Open one shard: a raw shard as a (mmap'd) numpy array; a coded one
        decoded, on ``device`` when that is a CUDA device (the dequantize
        kernel) and with numpy otherwise."""
        path = self.shard_path(rank, name, kind)
        tag = self.manifest.codec_tag(shard_digest_key(rank, name, kind))
        dtype = self.manifest.params[name].states[kind].dtype
        if tag == "raw":
            return load_tensor(path, dtype=dtype, mmap=mmap)
        return codec.decode_file(path, tag, dtype=dtype, device=device)

    def read_fragment(self, rank: int, name: str, kind: StateKind, *, device=None):
        """FragmentSource read: one persisted shard file."""
        return self.read_shard(rank, name, kind, device=device)

    def validate(self) -> list[str]:
        """Integrity check: every expected shard file exists and its served
        content matches the digest recorded at save time (a coded shard is
        decoded first).  Returns the problems; empty means clean."""
        problems: list[str] = []
        for name, spec in self.manifest.params.items():
            for kind in spec.states:
                for rank in self.writing_ranks(name, kind):
                    key = shard_digest_key(rank, name, kind)
                    path = self.shard_path(rank, name, kind)
                    if not path.exists():
                        problems.append(f"missing shard file {path}")
                        continue
                    want = self.manifest.shard_digests.get(key)
                    if want is None:
                        continue  # pre-digest checkpoint: existence only
                    try:
                        arr = self.read_shard(rank, name, kind)
                    except (OSError, ValueError) as e:  # unreadable == corrupt
                        problems.append(f"unreadable shard {path}: {e}")
                        continue
                    try:
                        got = content_digest(arr, want.split(":", 1)[0])
                    except ValueError:
                        problems.append(f"{key}: unrecognized recorded digest {want!r}")
                        continue
                    if got != want:
                        problems.append(f"{key}: digest {got} != recorded {want}")
        return problems
