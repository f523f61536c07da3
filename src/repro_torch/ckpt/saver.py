"""Distributed checkpoint saving (port of ``repro.ckpt.saver``).

snapshot → per-rank shard files → manifest with content digests → COMMIT.
Every simulated rank's shard is sliced out of one snapshot through the same
index maps as the reference, so a checkpoint written here is the one the
reference writes: same files, same bytes, same digests, same manifest apart
from ``created_at`` — serial or parallel, raw or coded, full or delta.

* ``save_mode="dedup"`` writes each fragment once (the lowest rank of its
  replica group), ``"all"`` every replica's copy, and ``"delta"`` only the
  shards whose content changed since a committed base (the rest become
  manifest references into the chain; a missing or incompatible base
  rebases to a full save, with the reason in ``SaveResult``).
* The per-shard jobs run on the engine's worker pool
  (:meth:`~repro_torch.core.engine.CheckpointEngine.map`): ``workers=1``
  is the serial path (each file fsync'd as it is written); a wider pool
  stages through the buffer arena, writes contiguous padding-free raw
  shards straight from the snapshot, and fsyncs each file in the worker
  that wrote it.  Either way COMMIT lands only after every shard is
  durable.
* Shard codecs (:class:`~repro_torch.core.codec.CodecPolicy`): the state
  kinds a codec codes stay on the device in the snapshot, and each of
  their shards is sliced, quantized and dequantized there (the
  block-quant kernels, launched from the worker thread on the device's
  default stream, where the snapshot's copies were made); only q, the
  scales and the bytes the two digests hash go to the host.
* :class:`AsyncSaver` overlaps the writes with training; the delta base it
  diffs against is resolved on its writer thread.
* A multi-rank save (``ranks=(rank,)``, ``group=``): the snapshot holds
  that rank's local shards, and the rank writes the shards it owns (under
  ``dedup`` the fragments it is primary for, under ``all`` its own); every
  rank's digests and errors go to every rank over ``group`` (a group kept
  for checkpoints, so a writer thread never interleaves with the training
  step's collectives), and group rank 0 writes the manifest and then
  COMMIT, after every rank's shards are durable.  The files are the
  single-process save's of the gathered state.  A multi-rank delta diffs
  each rank's own shards against one base that every rank agrees on
  (:func:`agree_delta_base`: rank 0 resolves it, and its base loader pins
  the chain, then broadcasts it); the inherited shards' provenance reaches
  rank 0 with the gathered results.  Rank 0's commit, or its failure,
  reaches every rank (:func:`commit_on_rank0`, :func:`on_rank0`).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.obs as obs
from repro_torch.chaos.points import fault_point
from repro_torch.core.codec import CODEC_RAW, CodecPolicy, encode_shard
from repro_torch.core.dist_ckpt import (
    DistCheckpoint,
    DistManifest,
    check_chain_committed,
    flatten_provenance,
    resolve_delta_base,
    shard_digest_key,
)
from repro_torch.core.engine import CheckpointEngine, default_engine, default_engines
from repro_torch.core.layout import slice_shard
from repro_torch.core.patterns import StateKind
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.core.tensor_io import (
    EXTENDED_DTYPES, array_nbytes, content_digest, dtype_name, fsync_path, resolve_dtype, to_extended,
    torch_dtype,
)
from repro_torch.dist.sharding import ShardingPlan
from repro_torch.train.optimizer import TrainState, init_state

__all__ = [
    "snapshot_state", "snapshot_weights", "write_distributed", "AsyncSaver", "SaveResult",
    "agree_delta_base", "commit_on_rank0", "on_rank0",
]


def _to_host(t: torch.Tensor):
    """A host copy: numpy, or a CPU tensor for the dtypes numpy cannot hold
    (bf16 moments), which ``save_tensor`` writes as the reference does."""
    t = t.detach().cpu()
    return t if dtype_name(t.dtype) in EXTENDED_DTYPES else t.numpy()


def snapshot_state(
    state: TrainState, codec: CodecPolicy | None = None
) -> dict[str, dict[StateKind, np.ndarray | torch.Tensor]]:
    """A consistent cut of the state, flat ``{param: {kind: array}}``.

    Raw kinds are copied to the host (:func:`_to_host`).  Kinds that
    ``codec`` codes stay tensors on their device (a copy, so the writer
    never sees a later step), because their shards are encoded there."""
    trees = {
        StateKind.FP32: state.params,
        StateKind.EXP_AVG: state.exp_avg,
        StateKind.EXP_AVG_SQ: state.exp_avg_sq,
    }
    out: dict[str, dict[StateKind, np.ndarray | torch.Tensor]] = {}
    with obs.span("save.stage"):
        for kind, tree in trees.items():
            coded = codec is not None and codec.tag_for(kind) != CODEC_RAW
            for name, t in flatten_with_paths(tree).items():
                out.setdefault(name, {})[kind] = t.detach().clone() if coded else _to_host(t)
    return out


def snapshot_weights(params: Mapping[str, Any]) -> dict[str, dict[StateKind, np.ndarray]]:
    """Host snapshot of nested weights alone: the state of a run before its
    first step (AdamW's zero moments), so the checkpoint lists all three
    kinds as a reference checkpoint does."""
    return snapshot_state(init_state(params))


@dataclasses.dataclass
class SaveResult:
    step: int
    path: Path
    bytes_written: int
    wall_time_s: float
    # Delta provenance: "full" or "delta"; the shard counts show that a
    # steady-state save really skipped the unchanged majority.
    mode: str = "full"
    shards_written: int = 0
    shards_inherited: int = 0
    fallback_reason: str = ""  # why a requested delta rebased to full
    # Coded shards written by this save: element bytes before encoding, and
    # the bytes each way between device and host (zero when on the host).
    coded_raw_bytes: int = 0
    coded_bytes: int = 0
    device_to_host_bytes: int = 0


def _is_contiguous(a) -> bool:
    return a.is_contiguous() if isinstance(a, torch.Tensor) else a.flags.c_contiguous


def write_distributed(
    snap: Mapping[str, Mapping[StateKind, Any]],
    plan: ShardingPlan,
    step: int,
    root: str | Path,
    *,
    scalars: Mapping[str, Any] | None = None,
    config_fingerprint: Mapping[str, Any] | None = None,
    save_mode: str = "dedup",
    base: "DistCheckpoint | Callable[[], DistCheckpoint | None] | None" = None,
    workers: int | None = None,
    engine: CheckpointEngine | None = None,
    codec: CodecPolicy | None = None,
    ranks: tuple[int, ...] | None = None,
    group=None,
) -> SaveResult:
    """Write one distributed checkpoint (all ranks' shards) and commit.

    Each shard is one job on the engine's pool: slice the rank's local
    (zero-padded) shard out of the snapshot, write it, record its content
    digest; then the manifest, then the COMMIT marker, so a crash never
    leaves a torn checkpoint that discovery would serve.  ``workers > 1``
    fans the jobs out (slicing through the buffer arena, contiguous
    padding-free raw shards written straight from the snapshot, each file
    fsync'd by its worker); ``workers=1`` is the serial path.  Precedence:
    explicit ``workers`` > ``engine.workers`` > the process default width.

    ``save_mode="delta"`` diffs every shard's pre-encode digest against
    ``base`` (a committed :class:`DistCheckpoint`, or a callable resolving
    one on the writing thread) and writes only the changed ones; the
    committed manifest carries the full digest table and the flattened
    provenance of the inherited shards.  An incompatible or missing base
    degrades to a full save, recorded in ``SaveResult.fallback_reason``.

    ``codec`` opts state kinds into block-quantized payloads.  A coded
    shard records its pre-encode digest (the delta key), is encoded, and
    records the served digest of its decoded view; the manifest carries the
    three tables (served digests, pre-encode digests where they differ,
    codec tags where not raw).  An all-raw policy is the plain byte path.

    ``ranks=(rank,)`` with ``group``: one rank's part of a multi-rank save;
    ``snap`` holds that rank's local shards (see the module docstring).
    The result counts the rank's own shards and bytes.
    """
    if ranks is not None and (group is None or len(ranks) != 1):
        raise ValueError("a per-rank save takes ranks=(rank,) and its group")
    with obs.timed("ckpt.save", step=step) as sw:
        return _write_distributed_traced(
            sw, snap, plan, step, root, scalars, config_fingerprint,
            save_mode, base, workers, engine, codec, ranks, group,
        )


def _gather_results(results, error, group, step: int) -> tuple[list, range]:
    """Every rank's job results in group-rank order, and where this rank's
    own lie among them; or raise every rank's failure on every rank."""
    me = dist.get_rank(group)
    mine = ("error", f"rank {me}: {type(error).__name__}: {error}") \
        if error is not None else ("ok", results)
    everyone: list = [None] * group.size()
    dist.all_gather_object(everyone, mine, group=group)
    failures = [p[1] for p in everyone if p[0] == "error"]
    if failures:
        raise RuntimeError(f"distributed save of step {step} failed: " + "; ".join(failures)) \
            from error
    start = sum(len(p[1]) for p in everyone[:me])
    return [r for _, rs in everyone for r in rs], range(start, start + len(results))


def on_rank0(fn, group):
    """``fn()`` run on group rank 0 of ``group`` alone, its value on every
    rank (a barrier too); a failure there raises on every rank."""
    src = dist.get_global_rank(group, 0)
    box: list = [None]
    if dist.get_rank(group) == 0:
        try:
            box = [("ok", fn())]
        except Exception as e:  # repro: allow[except-discipline] -- broadcast, then re-raised on every rank
            dist.broadcast_object_list([("error", f"{type(e).__name__}: {e}")], src=src,
                                       group=group)
            raise
    dist.broadcast_object_list(box, src=src, group=group)
    status, value = box[0]
    if status == "error":
        raise RuntimeError(f"group rank 0 failed: {value}")
    return value


def agree_delta_base(base, root, mesh, params, save_mode: str, group):
    """:func:`resolve_delta_base` of a multi-rank save: ``(base, reason)``
    on every rank of ``group``, one base for all.

    Group rank 0 resolves ``base`` (a callable runs there alone, so only
    rank 0's manager pins the chain) and broadcasts the base's directory
    name, or the reason it rebases; every other rank opens that sibling of
    ``root``."""
    if group is None:
        return resolve_delta_base(base, root, mesh, params, save_mode)
    resolved: list = []

    def resolve():
        resolved[:] = resolve_delta_base(base, root, mesh, params, save_mode)
        return None if resolved[0] is None else resolved[0].root.name, resolved[1]

    name, reason = on_rank0(resolve, group)
    if resolved:  # rank 0
        return resolved[0], reason
    return (None if name is None else DistCheckpoint.open(Path(root).parent / name)), reason


def commit_on_rank0(ckpt: DistCheckpoint, group, *, chain: bool) -> None:
    """The commit of a multi-rank save: group rank 0 checks the delta
    chain (``chain``) and writes COMMIT; every rank returns after COMMIT, or
    all raise."""
    def commit():
        if chain:
            check_chain_committed(ckpt)
        ckpt.commit()

    on_rank0(commit, group)


def _write_distributed_traced(
    sw, snap, plan, step, root, scalars, config_fingerprint,
    save_mode, base, workers, engine, codec, ranks, group,
) -> SaveResult:
    # The body of write_distributed, inside its ``ckpt.save`` span: ``sw``
    # gives the wall time and carries the result's attributes.
    coordinator = group is None or dist.get_rank(group) == 0
    fallback_reason = ""
    error = None  # under a group: this rank's failure, raised on every rank
    if save_mode == "delta":
        with obs.span("save.resolve_base"):
            try:
                base, fallback_reason = agree_delta_base(
                    base, root, plan.mesh, plan.param_specs, save_mode, group
                )
            except Exception as e:  # repro: allow[except-discipline] -- re-raised on every rank by _gather_results
                if group is None:
                    raise
                base, error = None, e
        if base is None:
            save_mode = "dedup"  # rebase: write a full snapshot
    else:
        base = None  # a base means something only to a delta
    if codec is not None and codec.is_raw:
        codec = None
    # The diff runs against the base's pre-encode table: raw new content
    # against raw old content, whatever codec either save used.
    base_digests = base.manifest.pre_encode_digests() if base is not None else None
    manifest = DistManifest(
        step=step,
        mesh=plan.mesh,
        params=dict(plan.param_specs),
        scalars=dict(scalars or {}) | {"step": step},
        config_fingerprint=dict(config_fingerprint or {}),
        save_mode=save_mode,
    )
    if coordinator:
        ckpt = DistCheckpoint.create(root, manifest)
    else:  # only the coordinator writes the manifest
        ckpt = DistCheckpoint(root, manifest)
    caller_engine = engine
    owns_engine = False
    if workers is not None and (engine is None or engine.workers != workers):
        engine = CheckpointEngine(workers=workers)
        owns_engine = True
    elif engine is None:
        engine = default_engine()
    serial = engine.workers == 1

    jobs: list[tuple[int, str, StateKind, Any, Any, str]] = []
    for name, spec in plan.param_specs.items():
        for kind, arr in snap[name].items():
            dt = spec.states[kind].dtype
            tag = codec.tag_for(kind) if codec is not None else CODEC_RAW
            if not isinstance(arr, torch.Tensor) and dt in EXTENDED_DTYPES:
                arr = to_extended(arr, dt)  # numbers cast through torch, never viewed
            if isinstance(arr, torch.Tensor):
                arr = arr.to(torch_dtype(dt))
                if tag == CODEC_RAW:
                    arr = _to_host(arr)
            else:
                arr = arr.astype(resolve_dtype(dt), copy=False)
            layout = spec.layout_for(kind, plan.mesh)
            for rank in ckpt.writing_ranks(name, kind):
                if ranks is None:
                    jobs.append((rank, name, kind, arr, layout, tag))
                elif rank in ranks:  # the snapshot is this rank's shard: nothing to slice
                    jobs.append((rank, name, kind, arr, None, tag))

    def durable(rank, name, kind) -> None:
        # The parallel path's fsync, in the worker that wrote the file, so
        # flushes overlap the other workers' writes; COMMIT still waits.
        if not serial:
            with obs.span("save.fsync"):
                fsync_path(ckpt.own_shard_path(rank, name, kind))

    # A job returns (written, key, served digest, pre digest, tag, inherited,
    # coded raw bytes, coded bytes, device->host bytes).  An inherited shard
    # returns Nones: the aggregation copies the base manifest's entries (the
    # ancestor's file may be coded under another policy).
    def write_one(job):
        rank, name, kind, arr, layout, tag = job
        fault_point("saver.shard", step=step, rank=rank, name=name, kind=kind.value)
        with obs.span("save.shard", rank=rank, param=name, kind=kind.value) as sp:
            return write_one_traced(sp, rank, name, kind, arr, layout, tag)

    def write_one_traced(sp, rank, name, kind, arr, layout, tag):
        key = shard_digest_key(rank, name, kind)
        contiguous_view = None
        if layout is None:  # the rank's own shard, whole
            contiguous_view = arr if _is_contiguous(arr) else (
                arr.contiguous() if isinstance(arr, torch.Tensor) else np.ascontiguousarray(arr))
        else:
            entries = layout.entries[rank]
            if len(entries) == 1 and entries[0].shard_slice == tuple((0, s) for s in layout.local_shape):
                view = arr[entries[0].atom_index()]
                if _is_contiguous(view):
                    contiguous_view = view
        inherited = (0, key, None, None, None, True, 0, 0, 0)
        if tag != CODEC_RAW or base_digests is not None:
            # Digest first (the delta key; zero-copy for a contiguous shard),
            # then write only what changed since the base.
            if contiguous_view is not None:
                shard, data = None, contiguous_view
            else:
                shard = data = slice_shard(arr, layout, rank, alloc=engine.alloc)
            pre = content_digest(data)
            if base_digests is not None and base_digests.get(key) == pre:
                engine.recycle(shard)
                sp.set(inherited=True)
                return inherited
            if tag == CODEC_RAW:
                written = ckpt.write_shard(rank, name, kind, data, fsync=serial)
                engine.recycle(shard)
                durable(rank, name, kind)
                return written, key, pre, pre, CODEC_RAW, False, 0, 0, 0
            enc = encode_shard(data, tag)
            coded = (0, 0, 0)
            if enc.tag == CODEC_RAW:  # int8ef exactness fallback: the raw array is the payload
                host = _to_host(data) if isinstance(data, torch.Tensor) else data
                written = ckpt.write_shard(rank, name, kind, host, fsync=serial)
                served = pre
            else:
                written = ckpt.write_shard(rank, name, kind, enc.payload, fsync=serial)
                served = content_digest(enc.decoded)
                on_device = isinstance(data, torch.Tensor) and data.device.type != "cpu"
                # shard and decoded view hashed, q and scales encoded
                d2h = 2 * array_nbytes(data) + enc.payload.nbytes if on_device else 0
                coded = (array_nbytes(data), written, d2h)
            engine.recycle(shard)
            durable(rank, name, kind)
            sp.set(codec=enc.tag)
            return (written, key, served, pre, enc.tag, False, *coded)
        written = digest = None
        if (not serial or layout is None) and contiguous_view is not None:
            # zero-copy: the shard is one padding-free contiguous rectangle
            # of the snapshot (or the rank's own shard), written without a
            # staging copy
            written = ckpt.write_shard(rank, name, kind, contiguous_view, fsync=serial)
            digest = content_digest(contiguous_view)
        if written is None:
            shard = slice_shard(arr, layout, rank, alloc=engine.alloc)
            written = ckpt.write_shard(rank, name, kind, shard, fsync=serial)
            digest = content_digest(shard)
            engine.recycle(shard)  # the bytes are on disk (or in the page cache)
        durable(rank, name, kind)
        return written, key, digest, digest, CODEC_RAW, False, 0, 0, 0

    res = SaveResult(step, Path(root), 0, 0.0, fallback_reason=fallback_reason)
    try:
        own = None  # where this rank's results lie among every rank's
        if group is None:
            results = engine.map(write_one, jobs)
        else:
            # every rank's digests (and failures) to every rank; returns
            # once every rank's shards are written and durable
            results = []
            if error is None:
                try:
                    results = engine.map(write_one, jobs)
                except Exception as e:  # repro: allow[except-discipline] -- re-raised on every rank by _gather_results
                    error = e
            results, own = _gather_results(results, error, group, step)
        # Digests land in the manifest before COMMIT, for every shard,
        # written and inherited, so the next delta diffs this manifest alone.
        served_tbl: dict[str, str] = {}
        pre_tbl: dict[str, str] = {}
        codec_tbl: dict[str, str] = {}
        for i, (written, key, served, pre, tag, inh, raw_b, coded_b, d2h) in enumerate(results):
            if inh:
                served = base.manifest.shard_digests[key]
                pre = base_digests[key]
                tag = base.manifest.codec_tag(key)
            served_tbl[key] = served
            if pre != served:
                pre_tbl[key] = pre
            if tag != CODEC_RAW:
                codec_tbl[key] = tag
            if own is not None and i not in own:
                continue  # another rank's shard: its bytes are in that rank's result
            if inh:
                res.shards_inherited += 1
            else:
                res.shards_written += 1
            res.bytes_written += written
            res.coded_raw_bytes += raw_b
            res.coded_bytes += coded_b
            res.device_to_host_bytes += d2h
        manifest.shard_digests = served_tbl
        manifest.shard_pre_digests = pre_tbl
        manifest.shard_codecs = codec_tbl
        if base is not None:
            flatten_provenance(manifest, base, [r[1] for r in results if r[5]])
        fault_point("saver.pre_manifest", step=step, mode=save_mode)
        if coordinator:
            with obs.span("save.manifest"):
                ckpt.rewrite_manifest()
        # A re-save into an existing directory must not leave readers on
        # stale handles of the replaced files: invalidate every engine that
        # could hold them (the one written through, the caller's, and the
        # process default of every device).
        for stale in {id(e): e for e in (engine, caller_engine, *default_engines())
                      if e is not None}.values():
            stale.invalidate(ckpt.root)
    finally:
        if owns_engine:
            engine.close()
    if group is None and base is not None:
        check_chain_committed(ckpt)
    fault_point("saver.pre_commit", step=step, mode=save_mode)
    if group is None:
        ckpt.commit()
    else:  # rank 0 checks the chain and commits
        commit_on_rank0(ckpt, group, chain=base is not None)
    res.mode = "delta" if base is not None else "full"
    res.wall_time_s = sw.elapsed_s
    # One accumulation feeds both: the obs counters equal the SaveResult.
    sw.set(mode=res.mode, bytes=res.bytes_written, shards_written=res.shards_written,
           shards_inherited=res.shards_inherited)
    obs.add(f"save.{res.mode}")
    obs.add("save.bytes_written", res.bytes_written)
    obs.add("save.shards_written", res.shards_written)
    obs.add("save.shards_inherited", res.shards_inherited)
    if fallback_reason:
        obs.event("save.rebase", step=step, reason=fallback_reason)
    return res


class AsyncSaver:
    """Background-thread checkpoint writer (compute/I-O overlap).

    ``submit`` snapshots synchronously (the only part that must see a
    consistent state) and enqueues the file writes; training resumes
    immediately.  ``wait()`` drains the queue; errors surface on the next
    call, never silently dropped.  ``max_pending`` bounds the queue: each
    pending job pins a full snapshot, so ``submit`` blocks (backpressure)
    once that many are in flight.  ``pending_roots()`` names the step
    directories still queued or being written, which GC must not treat as
    wreckage.  A delta's ``base`` may be a callable: ``write_distributed``
    resolves it on the writer thread, when the job runs.
    """

    def __init__(self, max_pending: int = 2):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._results: list[SaveResult] = []
        self._errors: list[BaseException] = []
        self._closed = False
        self._pending_lock = threading.Lock()
        self._pending_roots: set[Path] = set()  #: guarded by self._pending_lock
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def pending_roots(self) -> set[Path]:
        """Directories of saves still queued or being written."""
        with self._pending_lock:
            return set(self._pending_roots)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()  # or a wait() after close() blocks forever
                return
            try:
                self._results.append(item())
            except BaseException as e:  # repro: allow[except-discipline] -- worker thread: every failure (incl. injected FaultError) is stashed and re-raised via check()
                self._errors.append(e)
            finally:
                # The job pins its snapshot (a coded kind's copy stays on the
                # card): drop it now, not when the next job arrives.
                item = None
                self._q.task_done()

    def submit(self, state: TrainState, plan: ShardingPlan, step: int, root, **kw):
        if self._closed:
            raise RuntimeError("AsyncSaver.submit() after close(); create a new saver")
        self.check()
        snap = snapshot_state(state, kw.get("codec"))  # blocking: a consistent cut
        if any(isinstance(a, torch.Tensor) and a.is_cuda
               for kinds in snap.values() for a in kinds.values()):
            # the writer thread's kernels must see the snapshot's copies done
            torch.cuda.current_stream().synchronize()
        root_path = Path(root)
        with self._pending_lock:
            self._pending_roots.add(root_path)
        # Explicit span handoff across the queue: the writer thread's spans
        # hang off the span that submitted the save.
        parent = obs.current()

        def job() -> SaveResult:
            try:
                with obs.attach(parent), obs.span("save.async_job", step=step):
                    return write_distributed(snap, plan, step, root, **kw)
            finally:
                # only now may GC treat the directory as wreckage
                with self._pending_lock:
                    self._pending_roots.discard(root_path)

        self._q.put(job)

    def wait(self) -> list[SaveResult]:
        self._q.join()
        self.check()
        out, self._results = self._results, []
        return out

    def check(self) -> None:
        """Raise (once) every failure accumulated so far; the first is the cause."""
        if self._errors:
            errs, self._errors = self._errors[:], []
            suffix = f" ({len(errs)} failures)" if len(errs) > 1 else ""
            err = RuntimeError(f"async checkpoint save failed{suffix}")
            err.failures = tuple(errs)
            raise err from errs[0]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=10)
        self.check()  # a failed last save is not dropped
