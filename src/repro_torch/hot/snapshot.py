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

Under a group (``HotTier(group=...)``: every rank a process holding only
its own shards) each holder keeps its own host copy in its own process.
A capture stages the rank's own shard where it is the fragment's owner or
a natural holder (replicas of one fragment hold the same bytes, so nothing
moves for them), and buddy mirrors receive the owner's bytes over the
group (:func:`exchange_fragments`: uint8 views of host arrays through
gloo), each checked against the owner's digest.  Every rank keeps the whole
index (name, kind, owner, holders, digest, size) and the bytes it holds
(``data`` is None for the rest).  Placement, the ring budget and recovery
planning read the index alone, so every rank takes the same decisions; a
failure is one event that every rank checks it agrees on, and a failed
rank empties its own ring.  The capture's statistics are the rank's: what
it owns (fragments, stored bytes), what it holds (resident bytes) and what
it received (mirrored bytes), so each sums over the ranks to a one-process
capture's of the gathered state.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from collections import deque
from typing import Any, Iterable, Mapping

import numpy as np
import torch
import torch.distributed as dist

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

from .replicate import ReplicaStats, ReplicationPolicy, mirror_targets, natural_holders, place_holders

__all__ = ["HotFragment", "HotSnapshot", "HotTier", "exchange_fragments", "host_empty"]

# The largest message of a fragment exchange: a fragment moves as chunks of
# at most this many bytes, each under its own tag.
EXCHANGE_CHUNK = 256 << 20

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


def host_empty(shape, dtype: str):
    """An uninitialized host array of the checkpoint dtype ``dtype``, of the
    type :func:`_host_array` gives (a CPU tensor for an extended dtype,
    else numpy), of exactly its size (no arena bucket)."""
    if dtype in EXTENDED_DTYPES:
        return torch.empty(tuple(shape), dtype=torch_dtype(dtype))
    return np.empty(tuple(shape), resolve_dtype(dtype))


def _byte_chunks(arr) -> list[torch.Tensor]:
    """``arr``'s element bytes as uint8 CPU tensors of at most
    ``EXCHANGE_CHUNK`` bytes (views: a receive lands in ``arr``)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    flat = t.reshape(-1).view(torch.uint8)
    return [flat[i:i + EXCHANGE_CHUNK] for i in range(0, flat.numel(), EXCHANGE_CHUNK)]


def n_chunks(nbytes: int) -> int:
    """The messages (and so the tags) one fragment of ``nbytes`` moves as."""
    return -(-nbytes // EXCHANGE_CHUNK)


def exchange_fragments(sends, recvs, group) -> tuple[int, int]:
    """Move host fragments between the ranks of ``group`` as one batch of
    point-to-point operations; returns (bytes sent, bytes received).

    ``sends`` and ``recvs`` are ``(group rank of the peer, host array,
    tag)``: a receive lands in its (contiguous) array, and a fragment of
    ``n`` bytes moves as :func:`n_chunks` messages tagged ``tag``,
    ``tag + 1``, ... .  Every rank enumerates the exchange in one global
    order, so the tags of a send and of its receive agree; a rank with
    nothing to move posts nothing."""
    ops, sent, received = [], 0, 0
    for peers, op in ((sends, dist.isend), (recvs, dist.irecv)):
        for peer, arr, tag in peers:
            for k, piece in enumerate(_byte_chunks(arr)):
                ops.append(dist.P2POp(op, piece, dist.get_global_rank(group, peer), group,
                                      tag + k))
            if op is dist.isend:
                sent += array_nbytes(arr)
            else:
                received += array_nbytes(arr)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return sent, received


@dataclasses.dataclass
class HotFragment:
    """One stored fragment: bytes + replica holders + capture-time digest.

    ``data`` is None where this process holds no copy (a rank of a group
    that is not among the holders, or whose copy was lost); ``nbytes`` is
    the fragment's size either way."""

    owner: int
    data: Any  # host numpy array (or CPU tensor of an extended dtype), or None
    holders: tuple[int, ...]
    digest: str
    nbytes: int = 0

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
        # This process's rank under a group (None: one process holds every
        # fragment).
        self.rank: int | None = None
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
        if frag.data is None:
            raise KeyError(f"{name}@{kv} owner {rank}: rank {self.rank} holds no copy "
                           f"(holders {frag.holders}); fetch it from one")
        return frag.data

    # --------------------------------------------------------------- content
    def add_fragment(self, name: str, kind: StateKind, owner: int, data,
                     holders: tuple[int, ...], digest: str, nbytes: int | None = None) -> None:
        kv = getattr(kind, "value", str(kind))
        n = array_nbytes(data) if nbytes is None else int(nbytes)
        self._frags[(name, kv, owner)] = HotFragment(owner, data, holders, digest, n)
        self._owners[(name, kv)] = self._owners.get((name, kv), ()) + (owner,)

    def fragment(self, name: str, kind: StateKind, owner: int) -> HotFragment:
        """The index entry of one fragment (alive or not)."""
        return self._frags[(name, getattr(kind, "value", str(kind)), owner)]

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
        """Bytes stored once per surviving fragment (simulation memory)."""
        return sum(f.nbytes for f in self._frags.values() if f.alive(self.failed_ranks))

    @property
    def resident_nbytes(self) -> int:
        """Modeled aggregate host residency: bytes × surviving holders (from
        the index, so every rank of a group reckons the same)."""
        return sum(
            f.nbytes * sum(1 for h in f.holders if h not in self.failed_ranks)
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
        lost_here = self.rank is not None and self.rank in self.failed_ranks
        dead: list[str] = []
        for key, frag in list(self._frags.items()):
            alive = frag.alive(self.failed_ranks)
            if not alive:
                name, kv, owner = key
                dead.append(f"{name}@{kv} owner {owner}")
            if (not alive or lost_here) and frag.data is not None:
                if engine is not None:
                    engine.recycle(frag.data)
                # the bytes are gone (a new entry: a queued drain keeps its
                # own reference to the old one)
                self._frags[key] = dataclasses.replace(
                    frag, data=np.empty(0, np.uint8) if self.rank is None else None)
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
            if frag.data is not None and not digest_matches(frag.data, frag.digest):
                problems.append(
                    f"{name}@{kv} owner {frag.owner}: content does not "
                    f"match captured digest {frag.digest}"
                )
        return problems

    def release(self, engine: CheckpointEngine | None = None) -> None:
        """Return every buffer to the arena (ring eviction / clear)."""
        if engine is not None:
            for frag in self._frags.values():
                if frag.data is not None:
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
        group=None,
    ):
        """``group``: a gloo group of the plan's mesh size whose ranks are
        processes; this tier is then one rank's (see the module notes), and
        its captures and failures are collectives over ``group``, issued
        from one thread."""
        self.group = group
        self.rank = None if group is None else dist.get_rank(group)
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

        Under a group ``snap`` holds this rank's local shards, and every
        rank captures together (a collective): see the module notes.
        """
        fault_point("hot.capture", step=int(step))
        with obs.span("hot.capture", step=int(step)) as sp:
            hs, stats = self._capture(
                snap, plan, step, scalars=scalars, config_fingerprint=config_fingerprint,
                device=device, span=sp,
            )
            sp.set(**dataclasses.asdict(stats))
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
        span=obs.NULL_SPAN,
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
        with self._lock:
            failed = frozenset(self.failed_ranks)  # one consistent view per capture
        if self.group is not None:
            stats = self._capture_group(snap, plan, hs, failed, span)
        else:
            stats = self._capture_one(snap, plan, hs, failed)
        with self._lock:
            if self.failed_ranks:
                # ranks already lost before this capture hold nothing
                hs.fail_ranks(self.failed_ranks, engine=self.engine)
            self._ring.append(hs)
            self.captures += 1
            self._evict_locked()
        return hs, stats

    def _capture_one(self, snap, plan, hs: HotSnapshot, failed: frozenset[int]) -> ReplicaStats:
        """One process: every rank's fragment sliced out of the whole
        snapshot, its bytes stored once."""
        stats = ReplicaStats()
        engine = self.engine
        jobs: list[tuple[str, StateKind, int, Any, Any]] = []
        for name, spec in plan.param_specs.items():
            for kind, arr in snap[name].items():
                arr = _host_array(arr, spec.states[kind].dtype)
                layout = spec.layout_for(kind, plan.mesh)
                for rank in writing_ranks_for(spec, layout, self.save_mode):
                    jobs.append((name, kind, rank, arr, layout))

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
        return stats

    def _capture_group(self, snap, plan, hs: HotSnapshot, failed: frozenset[int],
                       span) -> ReplicaStats:
        """One rank of a group: stage what this rank holds of its own
        shards, receive its buddies' mirrored fragments, and agree on the
        index (the module notes).  Any rank's problem raises on every rank.
        The wall splits into ``span``'s attributes: ``stage_s`` (slice and
        digest), ``exchange_s`` (the mirror exchange, ``sent_bytes`` out and
        ``received_bytes`` in) and ``verify_s`` (the mirrors' digests)."""
        rank, group, engine = self.rank, self.group, self.engine
        if group.size() != plan.mesh.size:
            raise ValueError(f"the hot tier's group has {group.size()} ranks; the plan's mesh "
                             f"{dict(plan.mesh.axes)} has {plan.mesh.size}")
        hs.rank = rank
        t0 = time.perf_counter()
        # The whole index, in one order on every rank: (name, kind, owner,
        # holders, natural holders, mirrors, bytes, dtype, shape, natural count).
        index, local = [], {}
        for name, spec in plan.param_specs.items():
            natural_rep = not spec.average and self.save_mode != "all"
            for kind, arr in snap[name].items():
                dtype = spec.states[kind].dtype
                layout = spec.layout_for(kind, plan.mesh)
                arr = _host_array(arr, dtype)
                if tuple(arr.shape) != tuple(layout.local_shape):
                    raise ValueError(f"{name}@{kind.value}: the snapshot holds {tuple(arr.shape)}, "
                                     f"rank {rank}'s shard is {tuple(layout.local_shape)}")
                # contiguous: a receive lands in its buffer, a send reads its own
                local[(name, kind)] = (arr.contiguous() if isinstance(arr, torch.Tensor)
                                       else np.ascontiguousarray(arr))
                nbytes = math.prod(layout.local_shape) * resolve_dtype(dtype).itemsize
                for owner in writing_ranks_for(spec, layout, self.save_mode):
                    holders = place_holders(layout, owner, self.policy,
                                            natural_replication=natural_rep, exclude=failed)
                    natural = natural_holders(layout, owner, natural_replication=natural_rep)
                    n_nat = 1 if not natural_rep else len(natural - failed)
                    index.append((name, kind, owner, holders, natural,
                                  mirror_targets(layout, owner, holders,
                                                 natural_replication=natural_rep),
                                  nbytes, dtype, layout.local_shape, n_nat))
        # this rank's own shards: owned, or held as a natural replica
        staged = [i for i, e in enumerate(index)
                  if e[2] == rank or (rank in e[3] and rank in e[4])]
        mine = dict(zip(staged, engine.map(lambda i: content_digest(local[index[i][:2]]),
                                           staged)))
        t1 = time.perf_counter()
        owned = {i: d for i, d in mine.items() if index[i][2] == rank}
        everyone: list = [None] * group.size()
        dist.all_gather_object(everyone, owned, group=group)
        digest = {i: d for part in everyone for i, d in part.items()}
        # the buddy mirrors: the owner's bytes to each mirror holder
        sends, recvs, received, tag = [], [], {}, 0
        for i, (name, kind, owner, _h, _n, mirrors, nbytes, dtype, shape, _) in enumerate(index):
            for h in mirrors:
                if nbytes and owner == rank:
                    sends.append((h, local[(name, kind)], tag))
                if nbytes and h == rank:
                    received[i] = host_empty(shape, dtype)
                    recvs.append((owner, received[i], tag))
                tag += n_chunks(nbytes)
        sent_b, recv_b = exchange_fragments(sends, recvs, group)
        t2 = time.perf_counter()
        got = dict(zip(received, engine.map(lambda i: content_digest(received[i]), received)))
        problems = [
            f"{index[i][0]}@{index[i][1].value} owner {index[i][2]}: rank {rank}'s "
            f"{'mirror' if i in received else 'replica'} digest {d} is not the owner's "
            f"{digest[i]}"
            for i, d in (*mine.items(), *got.items()) if d != digest[i]
        ]
        dist.all_gather_object(everyone, problems, group=group)
        problems = [p for part in everyone for p in part]
        if problems:
            raise ValueError(f"hot capture of step {hs.step} under a group: "
                             + "; ".join(problems[:5]))
        stats = ReplicaStats()
        for i, (name, kind, owner, holders, natural, _m, nbytes, _d, _s, n_nat) in enumerate(index):
            data = received.get(i)
            if data is None and rank in holders and rank in natural:
                data = local[(name, kind)]
            hs.add_fragment(name, kind, owner, data, holders, digest[i], nbytes)
            if data is not None:
                stats.resident_bytes += nbytes
            if i in received:
                stats.mirrored_bytes += nbytes
            if owner == rank:
                stats.fragments += 1
                stats.stored_bytes += nbytes
                stats.natural_fragments += n_nat >= len(holders)
        span.set(stage_s=t1 - t0, exchange_s=t2 - t1, verify_s=time.perf_counter() - t2,
                 sent_bytes=sent_b, received_bytes=recv_b)
        return stats

    def leave_group(self) -> None:
        """Forget the group (it died with a rank): this tier becomes one
        process's, serving what its snapshots hold."""
        self.group, self.rank = None, None

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
        if self.group is not None:
            # one event: every rank must lose the same ranks
            everyone: list = [None] * self.group.size()
            dist.all_gather_object(everyone, sorted(ranks), group=self.group)
            if any(e != sorted(ranks) for e in everyone):
                raise ValueError(f"the ranks disagree on the failed ranks: {everyone}")
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
