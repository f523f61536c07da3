"""The *distributed* checkpoint format (port of ``repro.core.dist_ckpt``).

Layout on disk, byte-compatible with the JAX package::

    <ckpt_dir>/step_<N>/
        MANIFEST.json                      # mesh, param specs, scalars, config
        ranks/rank_00000/<name>@<kind>.npy # local (padded) shard arrays
        ...
        COMMIT                             # written last: atomic completion

Every rank persists exactly the shards it owns; replicated fragments are
written once, by the lowest rank of each replica group (``save_mode="dedup"``).

**Delta checkpoints** (``save_mode="delta"``): a delta step directory
holds only the shards whose content digest changed since its base; every
unchanged shard is a manifest reference (``shard_sources``: digest key →
owning step, flattened through the chain at save time, so resolution is one
hop).  ``shard_path`` resolves each shard to the sibling step directory
that holds its bytes, so every reader (DIRECT, RESHARD_STREAM, the UCP
export, validation) serves a chain through the same fragment reads.  The
write side (:func:`resolve_delta_base`, :func:`flatten_provenance`,
:func:`check_chain_committed`) is the reference's, so either package reads
and extends the other's chains.

:meth:`DistCheckpoint.read_shard` is the one decode point of coded shards
(:mod:`repro_torch.core.codec`): every reader above it serves coded
checkpoints unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np

import repro_torch.obs as obs
from repro_torch.chaos.points import fault_point

from . import clock, codec
from .layout import MeshSpec, ShardLayout
from .patterns import ParamSpec, StateKind
from .tensor_io import content_digest, load_tensor, save_tensor

__all__ = [
    "DistManifest",
    "DistCheckpoint",
    "check_chain_committed",
    "delta_incompatibility",
    "flatten_provenance",
    "resolve_delta_base",
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
    # "delta" enumerates like "dedup": a delta skips the unchanged members
    return [r for r in layout.primary_ranks() if layout.entries[r]]


def delta_incompatibility(base: "DistManifest", mesh, params, save_mode: str) -> str | None:
    """Why a delta against ``base`` is invalid (None: a delta is fine).

    A delta inherits unchanged shards by reference, which is sound only
    when the new snapshot's shard geometry is the base's: the same mesh,
    parameter set and per-param specs, and a matching write set (``"all"``
    enumerates other owners than ``"dedup"``/``"delta"``).  Callers fall
    back to a full save (a rebase) when this returns a reason.
    """
    if save_mode == "all" or base.save_mode == "all":
        return "save_mode 'all' has a different write set; delta requires dedup"
    if not base.shard_digests:
        return "base checkpoint predates content digests; nothing to diff against"
    if base.mesh != mesh:
        return f"mesh changed {dict(base.mesh.axes)} -> {dict(mesh.axes)}"
    if set(base.params) != set(params):
        return "parameter set changed"
    for name, spec in params.items():
        if base.params[name].to_json() != spec.to_json():
            return f"param spec changed for {name}"
    return None


def resolve_delta_base(base, root, mesh, params, save_mode: str):
    """Resolve and vet a delta base: ``(base, "")`` when a delta against it
    is valid, else ``(None, reason)`` and the caller rebases to a full save.

    ``base`` is a :class:`DistCheckpoint` or a zero-argument callable that
    returns one (resolved here, on the writing thread, so a queued delta
    diffs against the newest step that actually committed)."""
    if callable(base):
        base = base()
    if base is None:
        return None, "no committed base checkpoint"
    if not base.is_committed:
        return None, f"base {base.root} is not committed"
    if base.root.parent != Path(root).parent:
        return None, (
            f"base {base.root} is not a sibling of {root}; "
            "chain resolution requires sibling step directories"
        )
    reason = delta_incompatibility(base.manifest, mesh, params, save_mode)
    if reason:
        return None, reason
    return base, ""


def flatten_provenance(manifest: "DistManifest", base: "DistCheckpoint", inherited_keys) -> None:
    """Record delta provenance on ``manifest``: every inherited shard maps to
    the step that actually wrote its bytes (one hop through the base's own,
    already flat, provenance), and every owning step to its sibling
    directory name."""
    bm = base.manifest
    sources = {k: bm.shard_sources.get(k, bm.step) for k in inherited_keys}
    manifest.base_step = bm.step
    manifest.shard_sources = sources
    manifest.base_dirs = {
        str(owner): base.root.name if owner == bm.step else bm.base_dirs[str(owner)]
        for owner in set(sources.values())
    }


def check_chain_committed(ckpt: "DistCheckpoint") -> None:
    """Pre-commit guard of a delta: every ancestor directory it references
    must still be a committed checkpoint.  A delta whose chain was collected
    meanwhile stays uncommitted wreckage (the chain is servable from the
    last commit), never a committed but unservable step."""
    for chain_root in ckpt.chain_roots()[1:]:
        if not (chain_root / "COMMIT").exists():
            raise RuntimeError(
                f"delta for step {ckpt.manifest.step} references "
                f"{chain_root}, which is no longer a committed checkpoint"
            )


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

    def pre_encode_digests(self) -> dict[str, str]:
        """The pre-encode digest table a delta diffs against: the served
        digests overlaid with the sparse lossy-shard entries (for an all-raw
        checkpoint, ``shard_digests`` itself)."""
        if not self.shard_pre_digests:
            return self.shard_digests
        return {**self.shard_digests, **self.shard_pre_digests}

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

    def owner_step(self, rank: int, name: str, kind: StateKind) -> int:
        """The step whose directory holds this shard's bytes."""
        return self.manifest.shard_sources.get(
            shard_digest_key(rank, name, kind), self.manifest.step
        )

    def referenced_steps(self) -> set[int]:
        """Ancestor steps whose directories hold some of this checkpoint's
        shards (empty for a full checkpoint); GC keeps them alive."""
        return set(self.manifest.shard_sources.values())

    def chain_roots(self) -> list[Path]:
        """This root and every ancestor directory it references: every
        directory a reader of this checkpoint may open files in."""
        return [self.root] + [self.root.parent / d for d in self.manifest.base_dirs.values()]

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
        """Persist one rank's local shard; returns bytes written.
        ``fsync=False`` leaves the flush to the caller (the parallel saver
        fsyncs each file in the worker that wrote it, before COMMIT)."""
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
        with obs.span("ckpt.commit", step=self.manifest.step):
            fault_point("dist.pre_commit", step=self.manifest.step, root=str(self.root))
            tmp = self.root / "COMMIT.tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps({"step": self.manifest.step, "t": clock.now()}))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.commit_path)
            fault_point("dist.committed", step=self.manifest.step, root=str(self.root))

    # ------------------------------------------------------------------- read
    @classmethod
    def open(cls, root: str | os.PathLike) -> "DistCheckpoint":
        root = Path(root)
        manifest = DistManifest.from_json(json.loads((root / "MANIFEST.json").read_text()))
        return cls(root, manifest)

    def read_shard(
        self, rank: int, name: str, kind: StateKind, *, mmap: bool = True, device=None,
        cache=None,
    ):
        """Open one shard: a raw shard as a (mmap'd) numpy array; a coded one
        decoded, on ``device`` when that is a CUDA device (the dequantize
        kernel) and with numpy otherwise.  ``cache``: an optional
        :class:`~repro_torch.core.engine.HandleCache`, so repeated opens of
        one file reuse one handle (and one decode)."""
        path = self.shard_path(rank, name, kind)
        tag = self.manifest.codec_tag(shard_digest_key(rank, name, kind))
        dtype = self.manifest.params[name].states[kind].dtype
        if tag == "raw":
            loader = lambda: load_tensor(path, dtype=dtype, mmap=mmap)
        else:
            loader = lambda: codec.decode_file(path, tag, dtype=dtype, device=device)
        if cache is not None:
            return cache.get(path, loader)
        return loader()

    def read_fragment(self, rank: int, name: str, kind: StateKind, *, engine=None, device=None):
        """FragmentSource read: one persisted shard file, through the
        engine's handle cache (and on its decode device) when one is given."""
        if engine is not None:
            return engine.read_shard(self, rank, name, kind)
        return self.read_shard(rank, name, kind, device=device)

    def iter_param_fragments(self, name: str, kind: StateKind, *, engine=None, device=None):
        """Yield ``(rank, layout, shard)`` for every persisted fragment owner:
        the read side of the paper's Extract, one owning rank at a time,
        materializing nothing (mmap; coded shards decode as they are read).
        ``engine``: its handle cache shares file opens across callers."""
        layout = self.manifest.params[name].layout_for(kind, self.manifest.mesh)
        for rank in self.writing_ranks(name, kind):
            if engine is not None:
                yield rank, layout, engine.read_shard(self, rank, name, kind)
            else:
                yield rank, layout, self.read_shard(rank, name, kind, device=device)

    def total_bytes(self) -> int:
        """Bytes of the shard files in this directory (its own, not the
        ancestors' a delta references)."""
        return sum(p.stat().st_size for p in self.root.glob("ranks/**/*.npy"))

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
