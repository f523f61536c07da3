"""The publication registry: announce committed checkpoints to a fleet
(port of ``repro.serve.registry``).

One training job *publishes*; many serving replicas *subscribe*.  A
publication is an immutable announcement of one committed
:class:`~repro_torch.core.dist_ckpt.DistCheckpoint`: the manifest
(geometry), the full content-digest table (every shard, inherited delta
shards included: the save path writes a complete table), and the
*changed-shard set* relative to the previous announcement, which makes
steady-state delta publishes cheap: a replica that is current up to the
previous publication fetches only the diff.

The registry is also the fleet's *peer byte store*: every reader
registers the shards it fetched and verified, keyed by content
(``digest key @ digest``), so later readers pull from peers instead of
disk.  The in-process store keeps each shard's host bytes once and an
ordered holder list: byte-identical replicas, with per-holder corruption
(``poison_holder``), without multiplying memory.  It holds host arrays
only (numpy, or a CPU tensor for a dtype numpy cannot hold), never a card
tensor.  Content the newest publication no longer references is collected
on the next publish, so a long-running fleet's store tracks the live
checkpoint, not its history.

Everything is in-process and thread-safe: replicas are threads against one
registry, as the hot tier simulates ranks.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.chaos.points import fault_point
from repro_torch.core.dist_ckpt import DistCheckpoint, DistManifest
from repro_torch.core.tensor_io import array_nbytes

__all__ = ["Publication", "PublicationRegistry", "Subscription"]

_uid_counter = itertools.count(1)


def _own_copy(data):
    """A private host copy of one shard's bytes (the caller's buffer may be
    arena staging that gets recycled)."""
    if isinstance(data, torch.Tensor):
        return data.detach().to("cpu", copy=True)
    return np.array(data, copy=True)


def _rotted(data):
    """A copy of ``data`` with its first byte flipped (a replica whose host
    memory rotted: the reader's digest check must catch it)."""
    bad = _own_copy(data)
    if isinstance(bad, torch.Tensor):
        flat = bad.reshape(-1).view(torch.uint8).numpy()
    else:
        flat = bad.reshape(-1).view(np.uint8)
    if flat.size:
        flat[0] ^= 0xFF  # a single-byte rot: the digest must catch it
    return bad


@dataclasses.dataclass(frozen=True)
class Publication:
    """One announced committed step (immutable).

    ``changed`` is the set of digest keys whose content differs from the
    *previous* publication on this registry (every key, for the first).
    ``kind`` is ``"full"`` for the first announcement and ``"delta"``
    afterwards: the *announcement* diff, whether the checkpoint itself was
    saved full or incremental.
    """

    seq: int
    step: int
    checkpoint: DistCheckpoint
    manifest: DistManifest
    digests: dict[str, str]  # shard_digest_key -> content digest (full table)
    changed: frozenset[str]  # digest keys whose content changed vs seq-1
    kind: str  # "full" | "delta"

    @property
    def changed_params(self) -> frozenset[str]:
        """Parameter names with at least one changed shard (any state kind)."""
        # key = "rank_NNNNN/<name>@<kind>"; names never contain "@".
        return frozenset(key.split("/", 1)[1].rsplit("@", 1)[0] for key in self.changed)


class Subscription:
    """One reader's feed of publications (delivered in announce order)."""

    def __init__(self, reader_id: str, current: Publication | None):
        self.reader_id = reader_id
        self._q: queue.Queue[Publication] = queue.Queue()
        if current is not None:
            self._q.put(current)

    def _deliver(self, pub: Publication) -> None:
        self._q.put(pub)

    def poll(self) -> list[Publication]:
        """Drain every pending publication, oldest first (empty: current)."""
        out: list[Publication] = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out

    def wait(self, timeout: float | None = None) -> Publication | None:
        """Block for the next publication (None on timeout)."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None


class PublicationRegistry:
    """Publish/subscribe hub and the fleet's content-addressed peer store."""

    def __init__(self, *, name: str | None = None):
        self.uid = name or f"reg{next(_uid_counter)}"
        self._lock = threading.Lock()
        self._subs: list[Subscription] = []  #: guarded by self._lock
        self._current: Publication | None = None  #: guarded by self._lock
        self._seq = 0  #: guarded by self._lock
        # Peer store: content key ("digest_key@digest") -> bytes, and the
        # ordered holder ids (registration order == fan-out tree position).
        self._store: dict[str, object] = {}  #: guarded by self._lock
        self._holders: dict[str, list[str]] = {}  #: guarded by self._lock
        self._poison: set[tuple[str, str]] = set()  #: guarded by self._lock -- (holder, skey)
        self._fetch_locks: dict[str, threading.Lock] = {}  #: guarded by self._lock
        self.store_evictions = 0

    # ------------------------------------------------------------- publish
    def publish(self, ckpt: DistCheckpoint) -> Publication:
        """Announce one committed checkpoint to every subscriber.

        Requires a committed checkpoint with a complete digest table: the
        digests are what peer-fetch verification and delta diffs key on,
        so an undigested checkpoint cannot be distributed safely."""
        with obs.span("serve.publish", step=int(ckpt.manifest.step)) as sp:
            pub = self._publish(ckpt)
            sp.set(seq=pub.seq, kind=pub.kind, changed=len(pub.changed))
        obs.add("serve.publications")
        obs.add("serve.changed_shards", len(pub.changed))
        return pub

    def _publish(self, ckpt: DistCheckpoint) -> Publication:
        fault_point("registry.publish.begin", step=int(ckpt.manifest.step))
        if not ckpt.is_committed:
            raise ValueError(f"refusing to publish uncommitted checkpoint {ckpt.root}")
        digests = dict(ckpt.manifest.shard_digests)
        if not digests:
            raise ValueError(
                f"refusing to publish {ckpt.root}: manifest carries no "
                "content digests (nothing to verify peer fetches against)"
            )
        with self._lock:
            prev = self._current
            if prev is None:
                changed, kind = frozenset(digests), "full"
            else:
                changed = frozenset(k for k, d in digests.items() if prev.digests.get(k) != d)
                kind = "delta"
            self._seq += 1
            pub = Publication(seq=self._seq, step=int(ckpt.manifest.step), checkpoint=ckpt,
                              manifest=ckpt.manifest, digests=digests, changed=changed,
                              kind=kind)
            self._current = pub
            # GC the peer store: drop content the new publication no longer
            # references (an updated shard has a new digest, so a new key).
            live = {f"{k}@{d}" for k, d in digests.items()}
            for skey in [k for k in self._store if k not in live]:
                del self._store[skey]
                self._holders.pop(skey, None)
                self._fetch_locks.pop(skey, None)
                self.store_evictions += 1
            self._poison = {(h, s) for h, s in self._poison if s in live}
            subs = list(self._subs)
        # The crash-mid-publish window: the store GC ran and ``_current`` is
        # swapped, but no subscriber has been told.  Readers on the previous
        # publication can still fetch every byte (a peer miss falls back to
        # the committed disk files).
        fault_point("registry.publish.deliver", step=pub.step, seq=pub.seq)
        for sub in subs:
            sub._deliver(pub)
        return pub

    def current(self) -> Publication | None:
        with self._lock:
            return self._current

    def subscribe(self, reader_id: str) -> Subscription:
        """Join the fleet: the current publication (if any) is delivered at
        once, later ones as they are announced."""
        with self._lock:
            sub = Subscription(reader_id, self._current)
            self._subs.append(sub)
            return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    # ---------------------------------------------------------- peer store
    def fetch_lock(self, skey: str) -> threading.Lock:
        """Per-content-key single-flight lock: a cold shard asked for by N
        readers at once is fetched by one of them (one disk read); the rest
        then find a registered peer."""
        with self._lock:
            return self._fetch_locks.setdefault(skey, threading.Lock())

    def holders(self, skey: str) -> list[str]:
        """Ordered holder ids of one content key (registration order: a
        holder's position is its fan-out tree node index)."""
        with self._lock:
            return list(self._holders.get(skey, ()))

    def register_holder(self, reader_id: str, skey: str, data) -> int:
        """Record that ``reader_id`` now holds verified bytes of ``skey``;
        returns its tree position.  The first registration stores a copy of
        the bytes (once: replicas are byte-identical by construction)."""
        with self._lock:
            held = self._holders.setdefault(skey, [])
            if reader_id in held:
                return held.index(reader_id)
            if skey not in self._store:
                self._store[skey] = _own_copy(data)
            held.append(reader_id)
            return len(held) - 1

    def fetch(self, skey: str, holder_id: str):
        """One peer fetch: ``holder_id``'s copy of ``skey`` (None if the
        holder no longer has it).  A poisoned holder returns corrupted
        bytes: the caller's digest check is what catches it."""
        with self._lock:
            if holder_id not in self._holders.get(skey, ()):
                return None
            data = self._store.get(skey)
            if data is None:
                return None
            if (holder_id, skey) in self._poison:
                return _rotted(data)
            return data

    def drop_holder(self, skey: str, holder_id: str) -> None:
        """Evict one holder of one content key (a failed digest check, or a
        replica leaving): it is never offered as a peer of those bytes
        again."""
        with self._lock:
            held = self._holders.get(skey)
            if held and holder_id in held:
                held.remove(holder_id)
            self._poison.discard((holder_id, skey))

    def poison_holder(self, holder_id: str, skey: str) -> None:
        """Test hook: ``holder_id``'s copy of ``skey`` serves corrupted
        bytes on fetch (a replica whose host memory rotted)."""
        with self._lock:
            self._poison.add((holder_id, skey))

    @property
    def stored_nbytes(self) -> int:
        with self._lock:
            return sum(array_nbytes(a) for a in self._store.values())
