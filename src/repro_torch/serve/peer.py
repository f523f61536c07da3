"""PeerFragmentSource: serve checkpoint fragments from the fleet, not disk
(port of ``repro.serve.peer``).

The third fragment source (after the disk
:class:`~repro_torch.core.dist_ckpt.DistCheckpoint` and the in-memory
:class:`~repro_torch.hot.snapshot.HotSnapshot`): one reader's view of one
:class:`~repro_torch.serve.registry.Publication`.  Every restore path
(indexed region reads, the streaming reshard plan table, in-memory
consolidation) works on it unchanged; only where the bytes come from
changes.

**The fetch ladder**, per shard:

1. *local*: this reader already fetched and verified it;
2. *peers, in binomial-tree order*: the reader's tree position is the
   current holder count ``p``; it tries the holders at positions
   ``fanout_ladder(p)`` (parent, then each higher ancestor: the shape that
   bounds any holder's serving load at O(log N)), then any other holder;
3. *disk*: the published checkpoint's shard file, read fresh into host
   memory (never through a shared handle cache, so the disk-bytes census
   counts every real disk touch).  A coded shard decodes with numpy here:
   no card tensor ever enters the peer store.

Every peer-fetched buffer is checked against the publication's content
digest before use; a mismatch evicts the corrupt holder from the registry
and falls to the next tier (``refetches`` in the stats), never silently.
Disk is the last tier, so a corrupt *file* raises
:class:`~repro_torch.core.tensor_io.IntegrityError`.

Fetches of one shard are single-flight across the fleet (a per-content-key
lock), so a thundering herd on a cold shard costs one disk read, and the
winner serves the rest as a peer.

``share_regions = True`` opts into the engine's serving hot set
(:meth:`~repro_torch.core.engine.CheckpointEngine.shared_region`): readers
that also share an engine (replica threads on one serving host) get each
assembled Target region, and each consolidated atom through the shared
``cache_key``, built once per fleet.
"""

from __future__ import annotations

import dataclasses
import threading

import repro_torch.obs as obs
from repro_torch.chaos.points import fault_point
from repro_torch.core.dist_ckpt import shard_digest_key, writing_ranks_for
from repro_torch.core.patterns import StateKind
from repro_torch.core.tensor_io import IntegrityError, array_nbytes, digest_matches
from repro_torch.hot.replicate import fanout_ladder

from .registry import Publication, PublicationRegistry

__all__ = ["FanoutStats", "PeerFragmentSource"]


@dataclasses.dataclass
class FanoutStats:
    """Thread-safe tally of one fleet's (or one reader's) fetches.

    Every ``_add`` also counts into the obs counters under
    ``serve.<field>`` (names precomputed: one global read and a branch when
    tracing is off), so a trace of a fleet sync carries the same tallies."""

    disk_fetches: int = 0
    disk_bytes_read: int = 0
    peer_fetches: int = 0
    peer_bytes_read: int = 0
    local_hits: int = 0
    digest_failures: int = 0
    refetches: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def _add(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
        obs.add(_OBS_COUNTERS[field], n)

    def as_dict(self) -> dict[str, int]:
        with self._lock:
            return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


# field -> obs counter name, precomputed so the disabled path never formats.
_OBS_COUNTERS = {f.name: f"serve.{f.name}" for f in dataclasses.fields(FanoutStats)}


def pub_cache_key(registry: PublicationRegistry, seq: int) -> str:
    """The engine cache key of one publication of ``registry``."""
    return f"pub://{registry.uid}/seq{seq}"


class PeerFragmentSource:
    """One reader's fragment source over a publication and the peer store."""

    # Opt into CheckpointEngine.shared_region (see the module docstring).
    share_regions = True

    def __init__(
        self,
        registry: PublicationRegistry,
        publication: Publication,
        reader_id: str,
        *,
        stats: FanoutStats | None = None,
    ):
        self.registry = registry
        self.publication = publication
        self.reader_id = str(reader_id)
        self.stats = stats or FanoutStats()
        self._ckpt = publication.checkpoint
        # Shards this reader fetched and verified (it is a registered holder
        # of exactly these).
        self._local: dict[str, object] = {}  #: guarded by self._local_lock
        self._local_lock = threading.Lock()

    # --------------------------------------------------- fragment source
    @property
    def manifest(self):
        return self.publication.manifest

    @property
    def cache_key(self) -> str:
        """Shared by every reader of one publication: fragment indexes,
        consolidated atoms and shared regions are per-*fleet* cache entries
        (the publication is immutable: it is the content's identity)."""
        return pub_cache_key(self.registry, self.publication.seq)

    def writing_ranks(self, name: str, kind: StateKind) -> list[int]:
        spec = self.manifest.params[name]
        layout = spec.layout_for(kind, self.manifest.mesh)
        return writing_ranks_for(spec, layout, self.manifest.save_mode)

    def read_fragment(self, rank: int, name: str, kind: StateKind, *, engine=None):
        key = shard_digest_key(rank, name, kind)
        digest = self.publication.digests.get(key)
        if digest is None:
            raise KeyError(
                f"publication seq {self.publication.seq} carries no digest for {key}; "
                "cannot fetch it safely"
            )
        skey = f"{key}@{digest}"
        with self._local_lock:
            held = self._local.get(skey)
        if held is not None:
            self.stats._add("local_hits")
            return held
        # Single-flight per content key across the fleet: a cold shard is
        # fetched once (one disk read) and the winner serves the rest.
        with self.registry.fetch_lock(skey):
            with self._local_lock:
                held = self._local.get(skey)
            if held is not None:
                self.stats._add("local_hits")
                return held
            data = self._fetch_verified(skey, digest, rank, name, kind)
            self.registry.register_holder(self.reader_id, skey, data)
            with self._local_lock:
                self._local[skey] = data
            return data

    # ------------------------------------------------------- fetch ladder
    def _fetch_verified(self, skey: str, digest: str, rank: int, name: str, kind: StateKind):
        with obs.span("serve.fetch", reader=self.reader_id, param=name, rank=rank,
                      kind=kind.value) as sp:
            fault_point("peer.fetch", reader=self.reader_id, rank=rank, name=name,
                        kind=kind.value)
            holders = self.registry.holders(skey)
            position = len(holders)  # this reader's fan-out tree node index
            order = [holders[i] for i in fanout_ladder(position) if i < len(holders)]
            order += [h for h in holders if h not in order and h != self.reader_id]
            tried = 0
            for holder in order:
                data = self.registry.fetch(skey, holder)
                if data is None:
                    continue  # holder evicted between listing and fetch
                tried += 1
                if digest_matches(data, digest):
                    self.stats._add("peer_fetches")
                    self.stats._add("peer_bytes_read", array_nbytes(data))
                    if tried > 1:
                        self.stats._add("refetches")
                    sp.set(tier="peer", retries=tried - 1)
                    return data
                # A corrupt peer copy: evict the holder and fall to the next
                # tier (detected and counted, never served).
                self.stats._add("digest_failures")
                obs.event("serve.digest_mismatch", holder=holder, param=name, rank=rank,
                          kind=kind.value)
                self.registry.drop_holder(skey, holder)
            # The root tier: the published checkpoint on disk, read fresh into
            # host memory (no shared handle cache, no card).
            data = self._ckpt.read_shard(rank, name, kind, mmap=False)
            self.stats._add("disk_fetches")
            self.stats._add("disk_bytes_read", array_nbytes(data))
            if tried:
                self.stats._add("refetches")
            sp.set(tier="disk", retries=tried)
            if not digest_matches(data, digest):
                raise IntegrityError(
                    f"{skey}: disk copy at {self._ckpt.shard_path(rank, name, kind)} "
                    "does not match the published digest (last fetch tier)"
                )
            return data

    # ------------------------------------------------------------- helpers
    @property
    def held_nbytes(self) -> int:
        with self._local_lock:
            return sum(array_nbytes(a) for a in self._local.values())
