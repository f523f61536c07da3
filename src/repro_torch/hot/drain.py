"""Drain: background promotion of hot snapshots to durable disk checkpoints
(port of ``repro.hot.drain``).

Host memory is not durable: a correlated failure (whole-job preemption,
power loss) erases every replica.  The drainer promotes every Nth hot
snapshot to an ordinary committed
:class:`~repro_torch.core.dist_ckpt.DistCheckpoint` on a background thread,
so training pays the in-memory capture at every hot step and the disk never
(CheckFreq-style overlap, one tier down).

Promotion is a byte copy, not a re-slice: the snapshot already holds
exactly the shards the disk format wants (same writing ranks, same
geometry), and the capture-time content digests ride along into the disk
manifest.  Writes fan out over the engine's worker pool with the same
pipelined-fsync-then-COMMIT discipline as ``write_distributed``, so a crash
mid-drain leaves an uncommitted directory that discovery ignores and GC
removes.

Coded promotion (a :class:`~repro_torch.core.codec.CodecPolicy`): a coded
fragment is encoded where the captured state lived.  A snapshot of a state
on a card uploads each coded fragment there and encodes it with the
block-quant kernels, as ``write_distributed`` encodes a card state's
shards; a host state keeps the plain codec.  The files are byte-identical
either way.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.chaos.points import fault_point
from repro_torch.ckpt.saver import SaveResult
from repro_torch.core.codec import CODEC_RAW, CodecPolicy, encode_shard
from repro_torch.core.dist_ckpt import (
    DistCheckpoint,
    DistManifest,
    check_chain_committed,
    flatten_provenance,
    resolve_delta_base,
    shard_digest_key,
)
from repro_torch.core.engine import CheckpointEngine, default_engine
from repro_torch.core.patterns import StateKind
from repro_torch.core.tensor_io import array_nbytes, content_digest, fsync_path

from .snapshot import HotSnapshot

__all__ = ["HotDrainer", "persist_snapshot"]


def _on_device(data, device: torch.device):
    """A host fragment as a tensor on ``device`` when that is a card (the
    quantize kernel encodes it there), else the host array itself."""
    if device.type != "cuda":
        return data
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(data))
    return t.to(device)


def persist_snapshot(
    snapshot: HotSnapshot,
    root,
    *,
    engine: CheckpointEngine | None = None,
    fragments: list | None = None,
    base: "DistCheckpoint | Callable[[], DistCheckpoint | None] | None" = None,
    save_mode: str | None = None,
    codec: CodecPolicy | None = None,
) -> SaveResult:
    """Write one hot snapshot to disk as a committed distributed checkpoint.

    The result is byte-identical to ``write_distributed`` of the same state
    (same shard files, same digests); refuses to persist a snapshot that
    lost fragments to rank failures or was emptied by ring eviction (a
    committed checkpoint with holes would be worse than none).

    ``fragments``: an eagerly captured ``snapshot.fragments()`` list.  The
    background drainer captures it at enqueue time, so a ring eviction
    (``release()``) between enqueue and execution cannot empty the job —
    the list's references keep the bytes alive (arena reclamation is
    refcount-gated).

    ``save_mode="delta"`` promotes the snapshot as a delta against ``base``
    (a committed checkpoint, or a callable resolved on the drain thread):
    only fragments whose capture digest changed are written.  A missing or
    incompatible base degrades to a full promotion (a rebase).

    ``codec``: encode fragments at promotion time, on the snapshot's device
    (see the module notes).  Snapshots stay raw in memory; capture digests
    are the pre-encode digests, so the delta diff against a coded base
    still holds.
    """
    with obs.timed("hot.drain", step=snapshot.step) as sw:
        return _persist_snapshot_traced(
            sw, snapshot, root, engine=engine, fragments=fragments,
            base=base, save_mode=save_mode, codec=codec,
        )


def _persist_snapshot_traced(
    sw,
    snapshot: HotSnapshot,
    root,
    *,
    engine: CheckpointEngine | None = None,
    fragments: list | None = None,
    base: "DistCheckpoint | Callable[[], DistCheckpoint | None] | None" = None,
    save_mode: str | None = None,
    codec: CodecPolicy | None = None,
) -> SaveResult:
    if fragments is None:
        # A direct call checks completeness now (the drainer checks at
        # enqueue time: after a ring eviction released the snapshot,
        # missing_fragments() is vacuously empty).
        missing = snapshot.missing_fragments()
        if missing:
            raise ValueError(
                f"refusing to persist incomplete hot snapshot step "
                f"{snapshot.step}: missing {missing[:3]}"
                f"{'...' if len(missing) > 3 else ''}"
            )
        fragments = snapshot.fragments()
    if not fragments:
        raise ValueError(
            f"refusing to persist empty hot snapshot step {snapshot.step} "
            "(released by ring eviction before the drain ran?)"
        )
    engine = engine or default_engine()
    serial = engine.workers == 1
    device = snapshot.device
    m = snapshot.manifest
    if codec is not None and codec.is_raw:
        codec = None  # an all-raw policy is no policy: the plain byte path
    fallback_reason = ""
    if save_mode == "delta":
        base, fallback_reason = resolve_delta_base(base, root, m.mesh, m.params, m.save_mode)
    else:
        base = None
    # Capture digests are the pre-encode digests; the delta diff runs
    # against the base's pre-encode table, whatever codec either used.
    digests = {
        shard_digest_key(f.owner, name, StateKind(kv)): f.digest
        for name, kv, f in fragments
    }
    base_pre = base.manifest.pre_encode_digests() if base is not None else {}
    inherited_keys = [k for k, d in digests.items() if base_pre.get(k) == d]
    # Initial tables: capture digests for written shards (fixed up below
    # for coded ones), the base's entries for inherited shards.
    served_tbl = dict(digests)
    pre_tbl: dict[str, str] = {}
    codec_tbl: dict[str, str] = {}
    for k in inherited_keys:
        served_tbl[k] = base.manifest.shard_digests[k]
        if base_pre[k] != served_tbl[k]:
            pre_tbl[k] = base_pre[k]
        t = base.manifest.codec_tag(k)
        if t != CODEC_RAW:
            codec_tbl[k] = t
    manifest = DistManifest(
        step=m.step,
        mesh=m.mesh,
        params=dict(m.params),
        scalars=dict(m.scalars),
        config_fingerprint=dict(m.config_fingerprint),
        save_mode="delta" if base is not None else m.save_mode,
        # the full table, inherited fragments included, so the next delta
        # diffs against this manifest alone
        shard_digests=served_tbl,
        shard_codecs=codec_tbl,
        shard_pre_digests=pre_tbl,
    )
    if base is not None:
        flatten_provenance(manifest, base, inherited_keys)
    ckpt = DistCheckpoint.create(root, manifest)
    jobs = [
        (name, StateKind(kv), frag.owner, frag.data,
         codec.tag_for(StateKind(kv)) if codec is not None else CODEC_RAW)
        for name, kv, frag in fragments
        if shard_digest_key(frag.owner, name, StateKind(kv)) not in manifest.shard_sources
    ]

    # A job returns (written, key, served digest, tag, coded raw bytes,
    # coded bytes, device->host bytes).
    def write_one(job):
        name, kind, rank, data, tag = job
        key = shard_digest_key(rank, name, kind)
        with obs.span("drain.shard", rank=rank, param=name, kind=kind.value) as sp:
            fault_point("drain.shard", step=m.step, rank=rank, name=name, kind=kind.value)
            served = None  # the capture digest (raw bytes on disk)
            coded = (0, 0, 0)
            if tag != CODEC_RAW:
                enc = encode_shard(_on_device(data, device), tag)
                tag = enc.tag  # int8ef may have fallen back to raw
                if enc.tag != CODEC_RAW:
                    sp.set(codec=enc.tag)
                    served = content_digest(enc.decoded)
                    d2h = (array_nbytes(enc.decoded) + enc.payload.nbytes
                           if device.type == "cuda" else 0)
                    coded = (array_nbytes(data), int(enc.payload.nbytes), d2h)
                    data = enc.payload
            written = ckpt.write_shard(rank, name, kind, data, fsync=serial)
            if not serial:
                with obs.span("save.fsync"):
                    fsync_path(ckpt.own_shard_path(rank, name, kind))
            return written, key, served, tag, *coded

    results = engine.map(write_one, jobs)
    # Coded shards know their served digest only after encoding: fix up the
    # tables and rewrite the manifest once, still strictly before COMMIT.
    needs_rewrite = False
    for _w, key, served, tag, *_ in results:
        if tag != CODEC_RAW:
            needs_rewrite = True
            manifest.shard_codecs[key] = tag
        if served is not None and served != manifest.shard_digests[key]:
            needs_rewrite = True
            manifest.shard_pre_digests[key] = digests[key]
            manifest.shard_digests[key] = served
    if needs_rewrite:
        with obs.span("save.manifest"):
            ckpt.rewrite_manifest()
    engine.invalidate(ckpt.root)  # a re-drain into the same dir replaced files
    if base is not None:
        check_chain_committed(ckpt)
    fault_point("drain.pre_commit", step=m.step, mode="delta" if base is not None else "full")
    ckpt.commit()
    result = SaveResult(
        snapshot.step,
        Path(str(root)),
        sum(r[0] for r in results),
        sw.elapsed_s,
        mode="delta" if base is not None else "full",
        shards_written=len(jobs),
        shards_inherited=len(fragments) - len(jobs),
        fallback_reason=fallback_reason,
        coded_raw_bytes=sum(r[4] for r in results),
        coded_bytes=sum(r[5] for r in results),
        device_to_host_bytes=sum(r[6] for r in results),
    )
    sw.set(mode=result.mode, bytes=result.bytes_written,
           shards_written=result.shards_written, shards_inherited=result.shards_inherited)
    obs.add(f"save.{result.mode}")
    obs.add("save.bytes_written", result.bytes_written)
    obs.add("save.shards_written", result.shards_written)
    obs.add("save.shards_inherited", result.shards_inherited)
    if fallback_reason:
        obs.event("save.rebase", step=m.step, reason=fallback_reason)
    return result


class HotDrainer:
    """Background thread promoting every ``every``-th hot snapshot to disk.

    ``maybe_drain`` is called once per capture; it enqueues a persist job
    for every Nth snapshot and returns at once (the queue bounds pending
    promotions — each pins its snapshot's buffers — and applies
    backpressure on a slow disk).  Errors surface on the next
    ``check()``/``wait()``, as with ``AsyncSaver``.
    """

    def __init__(
        self,
        *,
        every: int = 1,
        engine: CheckpointEngine | None = None,
        max_pending: int = 2,
    ):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.every = int(every)
        self.engine = engine or default_engine()
        self._seq = 0
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._results: list[SaveResult] = []
        self._errors: list[BaseException] = []
        self._closed = False
        self._pending_lock = threading.Lock()
        self._pending_roots: set[Path] = set()  #: guarded by self._pending_lock
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    @property
    def next_drains(self) -> bool:
        """Whether the next ``maybe_drain`` call enqueues a promotion (lets
        the policy layer decide full or delta before calling)."""
        return (self._seq + 1) % self.every == 0

    def pending_roots(self) -> set[Path]:
        """Directories of promotions still queued or being written: never
        wreckage to GC, as with ``AsyncSaver``."""
        with self._pending_lock:
            return set(self._pending_roots)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._results.append(item())
            except BaseException as e:  # stashed, and re-raised by check()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def maybe_drain(self, snapshot: HotSnapshot, root, *, base=None,
                    save_mode: str | None = None,
                    codec: CodecPolicy | None = None) -> bool:
        """Enqueue the promotion if this snapshot is an Nth one; True if queued.

        ``base``/``save_mode`` pass through to :func:`persist_snapshot`: the
        manager asks for ``save_mode="delta"`` with a base loader the drain
        thread resolves when the job runs, so a queued delta diffs against a
        step that actually committed.
        """
        if self._closed:
            raise RuntimeError("HotDrainer.maybe_drain() after close()")
        self.check()
        self._seq += 1
        if self._seq % self.every:
            return False
        missing = snapshot.missing_fragments()
        if missing:
            raise ValueError(
                f"refusing to drain incomplete hot snapshot step "
                f"{snapshot.step}: missing {missing[:3]}"
                f"{'...' if len(missing) > 3 else ''}"
            )
        fault_point("drain.enqueue", step=snapshot.step)
        engine = self.engine
        # The fragment list NOW: a ring eviction between enqueue and the
        # write releases the snapshot, and persisting the then-empty
        # snapshot would commit a checkpoint with no shards.
        fragments = snapshot.fragments()
        root_path = Path(str(root))
        with self._pending_lock:
            self._pending_roots.add(root_path)
        parent = obs.current()  # handoff token: the drain runs on a worker

        def job() -> SaveResult:
            try:
                with obs.attach(parent), obs.span("hot.drain_job", step=snapshot.step):
                    return persist_snapshot(
                        snapshot, root, engine=engine, fragments=fragments,
                        base=base, save_mode=save_mode, codec=codec,
                    )
            finally:
                with self._pending_lock:
                    self._pending_roots.discard(root_path)

        self._q.put(job)
        return True

    def check(self) -> None:
        """Raise (once) every failure accumulated so far; the first is the cause."""
        if self._errors:
            errs, self._errors = self._errors[:], []
            suffix = f" ({len(errs)} failures)" if len(errs) > 1 else ""
            err = RuntimeError(f"hot snapshot drain failed{suffix}")
            err.failures = tuple(errs)
            raise err from errs[0]

    def wait(self) -> list[SaveResult]:
        self._q.join()
        self.check()
        out, self._results = self._results, []
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=10)
        self.check()
