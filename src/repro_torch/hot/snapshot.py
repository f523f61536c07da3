"""The hot tier's in-memory checkpoint objects (port of ``repro.hot.snapshot``).

A :class:`HotSnapshot` is one step's distributed checkpoint held in host
memory instead of on disk: the same :class:`~repro_torch.core.dist_ckpt.DistManifest`
header, with each persisted fragment stored as a host shard array (staged
through the engine's :class:`~repro_torch.core.engine.BufferArena`) plus the
set of ranks whose memory holds a replica of it (see ``replicate.py``).
Fragments are numpy arrays, or CPU tensors for the dtypes numpy cannot hold
(bf16 moments), exactly the shards ``write_distributed`` would write.

``HotSnapshot`` is a fragment source — ``manifest`` / ``writing_ranks`` /
``read_fragment`` / ``cache_key`` — so the engine's indexed region reads
serve from memory and from disk through one code path.  After rank
failures, ``writing_ranks`` enumerates only fragments with a surviving
holder and ``cache_key`` changes (a generation bump), so a stale fragment
index is never consulted.  ``device`` records where the captured state
lived: the drain encodes coded fragments there (the quantize kernel on a
card).

:class:`HotTier` is the ring buffer of snapshots with a byte budget:
``capture`` appends the newest and evicts the oldest once the modeled
aggregate host residency (fragment bytes × holders, what a real
deployment's hosts would pin) exceeds the budget.  Evicted buffers recycle
through the arena.

One process simulates every rank: replica copies are byte-identical by
construction, so each fragment's bytes are stored once with their holder
ranks; ``fail_ranks`` drops dead holders and frees a fragment only when its
last holder is gone — the observable semantics of per-host replica loss.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import deque
from typing import Any, Iterable, Mapping

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.chaos.points import fault_point
from repro_torch.ckpt.saver import _to_host
from repro_torch.core.dist_ckpt import DistManifest, shard_digest_key, writing_ranks_for
from repro_torch.core.engine import CheckpointEngine, default_engine
from repro_torch.core.layout import slice_shard
from repro_torch.core.patterns import StateKind
from repro_torch.core.tensor_io import (
    EXTENDED_DTYPES, array_nbytes, content_digest, digest_matches, resolve_dtype, to_extended,
    torch_dtype,
)

from .replicate import ReplicaStats, ReplicationPolicy, place_holders

__all__ = ["HotFragment", "HotSnapshot", "HotTier"]

_uid_counter = itertools.count(1)


def _host_array(arr, dtype: str):
    """``arr`` as a host array of the checkpoint dtype ``dtype``: numpy, or a
    CPU tensor for the dtypes numpy cannot hold (as ``write_distributed``
    normalizes its snapshot)."""
    if isinstance(arr, torch.Tensor):
        return _to_host(arr.to(torch_dtype(dtype)))
    if dtype in EXTENDED_DTYPES:
        return to_extended(arr, dtype)  # numbers cast through torch, never viewed
    return np.asarray(arr).astype(resolve_dtype(dtype), copy=False)


@dataclasses.dataclass
class HotFragment:
    """One stored fragment: bytes + replica holders + capture-time digest."""

    owner: int
    data: Any  # host numpy array (or CPU tensor of an extended dtype)
    holders: tuple[int, ...]
    digest: str

    def alive(self, failed: set[int]) -> bool:
        return any(h not in failed for h in self.holders)


class HotSnapshot:
    """One step's peer-replicated in-memory checkpoint (a fragment source)."""

    def __init__(self, step: int, manifest: DistManifest, *, uid: str | None = None,
                 device: str | torch.device = "cpu"):
        self.step = int(step)
        self.manifest = manifest
        self.uid = uid or f"snap{next(_uid_counter)}"
        self.device = torch.device(device)
        self.failed_ranks: set[int] = set()
        self._gen = 0
        # (name, kind.value, owner) -> fragment;  (name, kind.value) -> owners
        self._frags: dict[tuple[str, str, int], HotFragment] = {}
        self._owners: dict[tuple[str, str], tuple[int, ...]] = {}

    # --------------------------------------------------- fragment source API
    @property
    def cache_key(self) -> str:
        """Changes on every failure event, so the engine never serves a
        region from a fragment index built before availability changed."""
        return f"hot://{self.uid}/step_{self.step}#g{self._gen}"

    def writing_ranks(self, name: str, kind: StateKind) -> list[int]:
        """Owners of fragments that still have a surviving replica holder."""
        kv = getattr(kind, "value", str(kind))
        return [
            o
            for o in self._owners.get((name, kv), ())
            if self._frags[(name, kv, o)].alive(self.failed_ranks)
        ]

    def read_fragment(self, rank: int, name: str, kind: StateKind, *, engine=None):
        kv = getattr(kind, "value", str(kind))
        frag = self._frags[(name, kv, rank)]
        if not frag.alive(self.failed_ranks):
            raise KeyError(f"{name}@{kv} owner {rank}: every replica holder failed")
        return frag.data

    # --------------------------------------------------------------- content
    def add_fragment(self, name: str, kind: StateKind, owner: int, data,
                     holders: tuple[int, ...], digest: str) -> None:
        kv = getattr(kind, "value", str(kind))
        self._frags[(name, kv, owner)] = HotFragment(owner, data, holders, digest)
        self._owners[(name, kv)] = self._owners.get((name, kv), ()) + (owner,)

    def fragments(self) -> list[tuple[str, str, HotFragment]]:
        """Live ``(name, kind_value, fragment)`` triples (stable order)."""
        return [
            (name, kv, f)
            for (name, kv, _), f in sorted(self._frags.items())
            if f.alive(self.failed_ranks)
        ]

    def shard_digests(self) -> dict[str, str]:
        """Capture-time digests in disk-manifest form (the drain reuses them)."""
        return {
            shard_digest_key(f.owner, name, StateKind(kv)): f.digest
            for (name, kv, _), f in sorted(self._frags.items())
        }

    @property
    def stored_nbytes(self) -> int:
        """Bytes stored once per fragment (simulation memory)."""
        return sum(array_nbytes(f.data) for f in self._frags.values())

    @property
    def resident_nbytes(self) -> int:
        """Modeled aggregate host residency: bytes × surviving holders."""
        return sum(
            array_nbytes(f.data) * sum(1 for h in f.holders if h not in self.failed_ranks)
            for f in self._frags.values()
        )

    # -------------------------------------------------------------- failures
    def fail_ranks(self, ranks: Iterable[int], *, engine=None) -> list[str]:
        """Lose ``ranks``' host memory; free fragments with no survivor.

        Returns the keys of fragments that became unrecoverable (empty ==
        the snapshot still covers the full state).
        """
        self.failed_ranks |= set(int(r) for r in ranks)
        self._gen += 1
        dead: list[str] = []
        for key, frag in list(self._frags.items()):
            if not frag.alive(self.failed_ranks):
                name, kv, owner = key
                dead.append(f"{name}@{kv} owner {owner}")
                if engine is not None:
                    engine.recycle(frag.data)
                frag.data = np.empty(0, np.uint8)  # the bytes are gone
        return dead

    def missing_fragments(self) -> list[str]:
        """Captured fragments whose every holder has failed."""
        return [
            f"{name}@{kv} owner {owner}"
            for (name, kv, owner), f in sorted(self._frags.items())
            if not f.alive(self.failed_ranks)
        ]

    def is_complete(self) -> bool:
        return not self.missing_fragments()

    # -------------------------------------------------------------- integrity
    def verify(self) -> list[str]:
        """Re-digest every surviving fragment against its capture digest."""
        problems: list[str] = []
        for name, kv, frag in self.fragments():
            if not digest_matches(frag.data, frag.digest):
                problems.append(
                    f"{name}@{kv} owner {frag.owner}: content does not "
                    f"match captured digest {frag.digest}"
                )
        return problems

    def release(self, engine: CheckpointEngine | None = None) -> None:
        """Return every buffer to the arena (ring eviction / clear)."""
        if engine is not None:
            for frag in self._frags.values():
                engine.recycle(frag.data)
        self._frags.clear()
        self._owners.clear()
        self._gen += 1


class HotTier:
    """Ring buffer of peer-replicated in-memory snapshots with a byte budget."""

    def __init__(
        self,
        *,
        replication: int = 1,
        max_snapshots: int = 4,
        max_bytes: int = 2 << 30,
        engine: CheckpointEngine | None = None,
        save_mode: str = "dedup",
    ):
        self.policy = ReplicationPolicy(replication)
        self.max_snapshots = int(max_snapshots)
        if self.max_snapshots < 1:
            raise ValueError(f"max_snapshots must be >= 1, got {max_snapshots}")
        self.max_bytes = int(max_bytes)
        self.engine = engine or default_engine()
        self.save_mode = save_mode
        self.failed_ranks: set[int] = set()  #: guarded by self._lock
        self._ring: deque[HotSnapshot] = deque()  #: guarded by self._lock
        self._lock = threading.Lock()
        self.captures = 0  #: guarded by self._lock
        self.evictions = 0  #: guarded by self._lock

    # ---------------------------------------------------------------- capture
    def capture(
        self,
        snap: Mapping[str, Mapping[StateKind, Any]],
        plan,
        step: int,
        *,
        scalars: Mapping[str, Any] | None = None,
        config_fingerprint: Mapping[str, Any] | None = None,
        device: str | torch.device = "cpu",
    ) -> tuple[HotSnapshot, ReplicaStats]:
        """Stage one host snapshot into the ring (the hot "save").

        ``snap`` is ``snapshot_state(state)`` output (host arrays);
        ``device`` is where that state lives (the drain encodes there).
        Fragments are sliced exactly like the disk save path (same writing
        ranks, same shard geometry, same digests), so a drained hot snapshot
        is byte-identical to a ``write_distributed`` of the same state.
        """
        fault_point("hot.capture", step=int(step))
        with obs.span("hot.capture", step=int(step)) as sp:
            hs, stats = self._capture(
                snap, plan, step, scalars=scalars, config_fingerprint=config_fingerprint,
                device=device,
            )
            sp.set(fragments=stats.fragments, resident_bytes=stats.resident_bytes)
        obs.add("hot.captures")
        obs.add("hot.fragments", stats.fragments)
        obs.add("hot.stored_bytes", stats.stored_bytes)
        obs.add("hot.resident_bytes", stats.resident_bytes)
        obs.add("hot.mirrored_bytes", stats.mirrored_bytes)
        return hs, stats

    def _capture(
        self,
        snap: Mapping[str, Mapping[StateKind, Any]],
        plan,
        step: int,
        *,
        scalars: Mapping[str, Any] | None = None,
        config_fingerprint: Mapping[str, Any] | None = None,
        device: str | torch.device = "cpu",
    ) -> tuple[HotSnapshot, ReplicaStats]:
        manifest = DistManifest(
            step=int(step),
            mesh=plan.mesh,
            params=dict(plan.param_specs),
            scalars=dict(scalars or {}) | {"step": int(step)},
            config_fingerprint=dict(config_fingerprint or {}),
            save_mode=self.save_mode,
        )
        hs = HotSnapshot(step, manifest, device=device)
        stats = ReplicaStats()
        engine = self.engine

        jobs: list[tuple[str, StateKind, int, Any, Any]] = []
        for name, spec in plan.param_specs.items():
            for kind, arr in snap[name].items():
                arr = _host_array(arr, spec.states[kind].dtype)
                layout = spec.layout_for(kind, plan.mesh)
                for rank in writing_ranks_for(spec, layout, self.save_mode):
                    jobs.append((name, kind, rank, arr, layout))

        with self._lock:
            failed = frozenset(self.failed_ranks)  # one consistent view per capture

        def stage(job):
            name, kind, rank, arr, layout = job
            shard = slice_shard(arr, layout, rank, alloc=engine.alloc)
            spec = plan.param_specs[name]
            holders = place_holders(
                layout, rank, self.policy,
                natural_replication=not spec.average and self.save_mode != "all",
                exclude=failed,  # dead buddies never count as holders
            )
            return name, kind, rank, shard, holders, content_digest(shard)

        for name, kind, rank, shard, holders, digest in engine.map(stage, jobs):
            hs.add_fragment(name, kind, rank, shard, holders, digest)
            spec = plan.param_specs[name]
            if spec.average or self.save_mode == "all":
                natural = 1  # replicas diverge (or are stored per rank)
            else:
                layout = spec.layout_for(kind, plan.mesh)
                natural = len([
                    r for r in layout.ranks_for_fragment(layout.fragment_id[rank])
                    if r not in failed
                ])
            n = array_nbytes(shard)
            stats.fragments += 1
            stats.stored_bytes += n
            stats.resident_bytes += n * len(holders)
            if natural >= len(holders):
                stats.natural_fragments += 1
            else:
                stats.mirrored_bytes += n * (len(holders) - natural)

        with self._lock:
            if self.failed_ranks:
                # ranks already lost before this capture hold nothing
                hs.fail_ranks(self.failed_ranks, engine=engine)
            self._ring.append(hs)
            self.captures += 1
            self._evict_locked()
        return hs, stats

    def _evict_locked(self) -> None:  # repro: holds[self._lock]
        def over_budget() -> bool:
            return (
                len(self._ring) > self.max_snapshots
                or sum(s.resident_nbytes for s in self._ring) > self.max_bytes
            )

        while len(self._ring) > 1 and over_budget():
            old = self._ring.popleft()
            old.release(self.engine)
            self.evictions += 1
            obs.add("hot.evictions")

    # ----------------------------------------------------------------- lookup
    def snapshots(self) -> list[HotSnapshot]:
        """Oldest → newest."""
        with self._lock:
            return list(self._ring)

    def latest(self) -> HotSnapshot | None:
        with self._lock:
            return self._ring[-1] if self._ring else None

    @property
    def resident_nbytes(self) -> int:
        with self._lock:
            return sum(s.resident_nbytes for s in self._ring)

    # --------------------------------------------------------------- failures
    def fail_ranks(self, ranks: Iterable[int]) -> dict[int, list[str]]:
        """Simulate losing ``ranks``' host memory across every snapshot.

        Returns {step: unrecoverable fragment keys} for snapshots that lost
        coverage (recovery planning skips those).
        """
        ranks = set(int(r) for r in ranks)
        out: dict[int, list[str]] = {}
        with self._lock:
            # under the lock: a concurrent _capture reads this set
            self.failed_ranks |= ranks
            for s in self._ring:
                dead = s.fail_ranks(ranks, engine=self.engine)
                if dead:
                    out[s.step] = dead
        return out

    def clear(self) -> None:
        with self._lock:
            while self._ring:
                self._ring.popleft().release(self.engine)
