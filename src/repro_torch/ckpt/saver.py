"""Distributed checkpoint saving (port of ``repro.ckpt.saver``).

snapshot → per-rank shard files → manifest with content digests → COMMIT.
Every simulated rank's shard is sliced out of one snapshot through the same
index maps as the reference, so a checkpoint written here is the one the
reference's serial path (``workers=1``) writes: same files, same bytes, same
digests, same manifest apart from ``created_at``.

Ported: ``save_mode="dedup"`` (each fragment written once, by the lowest
rank of its replica group) and ``"all"`` on the serial path, shard codecs
(:class:`~repro_torch.core.codec.CodecPolicy`) and :class:`AsyncSaver`.
The state kinds a codec codes stay on the device in the snapshot: each of
their shards is sliced, quantized and dequantized there (the block-quant
kernels), and only q, the scales and the bytes the two digests hash go to
the host.  Delta saves and the parallel writer wait for ROADMAP queue 1,
item 3.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.codec import CODEC_RAW, CodecPolicy, encode_shard
from repro_torch.core.dist_ckpt import DistCheckpoint, DistManifest, shard_digest_key
from repro_torch.core.layout import slice_shard
from repro_torch.core.patterns import StateKind
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.core.tensor_io import (
    EXTENDED_DTYPES, content_digest, dtype_name, resolve_dtype, torch_dtype,
)
from repro_torch.dist.sharding import ShardingPlan
from repro_torch.train.optimizer import TrainState, init_state

__all__ = [
    "snapshot_state", "snapshot_weights", "write_distributed", "AsyncSaver", "SaveResult",
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
    shards_written: int = 0
    # Coded shards only: element bytes before encoding, and the bytes each
    # way between device and host (zero when the shards were on the host).
    coded_raw_bytes: int = 0
    coded_bytes: int = 0
    device_to_host_bytes: int = 0


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes


def write_distributed(
    snap: Mapping[str, Mapping[StateKind, Any]],
    plan: ShardingPlan,
    step: int,
    root: str | Path,
    *,
    scalars: Mapping[str, Any] | None = None,
    config_fingerprint: Mapping[str, Any] | None = None,
    save_mode: str = "dedup",
    codec: CodecPolicy | None = None,
) -> SaveResult:
    """Write one distributed checkpoint (all ranks' shards) and commit.

    Shard by shard: slice the rank's local (zero-padded) shard out of the
    snapshot, write it with an fsync, record its content digest; then the
    manifest, then the COMMIT marker, so a crash never leaves a torn
    checkpoint that discovery would serve.  ``save_mode="all"`` writes
    every replica's copy, ``"dedup"`` each fragment once.

    ``codec`` opts state kinds into block-quantized payloads.  A coded
    shard records its pre-encode digest, is encoded, and records the
    served digest of its decoded view; the manifest carries the three
    tables (served digests, pre-encode digests where they differ, codec
    tags where not raw).  An all-raw policy is the plain byte path.
    """
    t0 = time.perf_counter()
    if save_mode not in ("dedup", "all"):
        raise NotImplementedError(
            f"save_mode={save_mode!r} is not ported yet (ROADMAP queue 1, item 3: delta saves)"
        )
    if codec is not None and codec.is_raw:
        codec = None
    manifest = DistManifest(
        step=step,
        mesh=plan.mesh,
        params=dict(plan.param_specs),
        scalars=dict(scalars or {}) | {"step": step},
        config_fingerprint=dict(config_fingerprint or {}),
        save_mode=save_mode,
    )
    ckpt = DistCheckpoint.create(root, manifest)
    res = SaveResult(step, Path(root), 0, 0.0)
    served_tbl: dict[str, str] = {}
    pre_tbl: dict[str, str] = {}
    codec_tbl: dict[str, str] = {}
    for name, spec in plan.param_specs.items():
        for kind, arr in snap[name].items():
            dt = spec.states[kind].dtype
            tag = codec.tag_for(kind) if codec is not None else CODEC_RAW
            if isinstance(arr, torch.Tensor):
                arr = arr.to(torch_dtype(dt))
                if tag == CODEC_RAW:
                    arr = _to_host(arr)
            else:
                arr = arr.astype(resolve_dtype(dt), copy=False)
            layout = spec.layout_for(kind, plan.mesh)
            for rank in ckpt.writing_ranks(name, kind):
                key = shard_digest_key(rank, name, kind)
                shard = slice_shard(arr, layout, rank)
                pre = content_digest(shard)
                if tag == CODEC_RAW:
                    res.bytes_written += ckpt.write_shard(rank, name, kind, shard, fsync=True)
                    served_tbl[key] = pre
                    continue
                enc = encode_shard(shard, tag)
                on_device = isinstance(shard, torch.Tensor) and shard.device.type != "cpu"
                if enc.tag == CODEC_RAW:  # int8ef exactness fallback
                    host = _to_host(shard) if isinstance(shard, torch.Tensor) else shard
                    written = ckpt.write_shard(rank, name, kind, host, fsync=True)
                    served = pre
                else:
                    written = ckpt.write_shard(rank, name, kind, enc.payload, fsync=True)
                    served = content_digest(enc.decoded)
                    codec_tbl[key] = enc.tag
                    if on_device:  # shard and decoded view hashed, q and scales encoded
                        res.device_to_host_bytes += 2 * _nbytes(shard)
                        res.device_to_host_bytes += enc.payload.nbytes
                    res.coded_raw_bytes += _nbytes(shard)
                    res.coded_bytes += written
                res.bytes_written += written
                served_tbl[key] = served
                if pre != served:
                    pre_tbl[key] = pre
    manifest.shard_digests = served_tbl
    manifest.shard_pre_digests = pre_tbl
    manifest.shard_codecs = codec_tbl
    ckpt.rewrite_manifest()
    ckpt.commit()
    res.shards_written = len(served_tbl)
    res.wall_time_s = time.perf_counter() - t0
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
    wreckage.
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
            except BaseException as e:  # stashed, and re-raised by check()
                self._errors.append(e)
            finally:
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

        def job() -> SaveResult:
            try:
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
