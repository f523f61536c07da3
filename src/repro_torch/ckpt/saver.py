"""Distributed checkpoint saving (port of ``repro.ckpt.saver``).

snapshot → per-rank shard files → manifest with content digests → COMMIT.
Every simulated rank's shard is sliced out of one host snapshot through the
same index maps as the reference, so a checkpoint written here is the one
the reference's serial path (``workers=1``) writes: same files, same bytes,
same digests, same manifest apart from ``created_at``.

Ported: ``save_mode="dedup"`` (each fragment written once, by the lowest
rank of its replica group) on the serial path.  Delta saves, shard codecs,
the parallel writer and ``AsyncSaver`` wait for ROADMAP queue 1, item 3.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from repro_torch.core.dist_ckpt import DistCheckpoint, DistManifest, shard_digest_key
from repro_torch.core.layout import slice_shard
from repro_torch.core.patterns import STATE_KINDS, StateKind
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.core.tensor_io import content_digest, resolve_dtype
from repro_torch.dist.sharding import ShardingPlan

__all__ = ["snapshot", "write_distributed", "SaveResult"]


def snapshot(params: Mapping[str, Any]) -> dict[str, dict[StateKind, np.ndarray]]:
    """Device → host snapshot of the weights, flat ``{name: {kind: ndarray}}``.

    ``params`` is a nested or flat dict of tensors.  The port has no
    optimizer yet, so the Adam moments are zeros — AdamW's initial state —
    and the checkpoint lists all three kinds, exactly as a reference
    checkpoint does.
    """
    out: dict[str, dict[StateKind, np.ndarray]] = {}
    for name, p in flatten_with_paths(params).items():
        host = p.detach().cpu().numpy()
        out[name] = {StateKind.FP32: host} | {
            kind: np.zeros(host.shape, host.dtype) for kind in STATE_KINDS[1:]
        }
    return out


@dataclasses.dataclass
class SaveResult:
    step: int
    path: Path
    bytes_written: int
    wall_time_s: float
    shards_written: int = 0


def write_distributed(
    snap: Mapping[str, Mapping[StateKind, np.ndarray]],
    plan: ShardingPlan,
    step: int,
    root: str | Path,
    *,
    scalars: Mapping[str, Any] | None = None,
    config_fingerprint: Mapping[str, Any] | None = None,
) -> SaveResult:
    """Write one distributed checkpoint (all ranks' shards) and commit.

    Shard by shard: slice the rank's local (zero-padded) shard out of the
    snapshot, write it with an fsync, record its content digest; then the
    manifest, then the COMMIT marker, so a crash never leaves a torn
    checkpoint that discovery would serve.
    """
    t0 = time.perf_counter()
    manifest = DistManifest(
        step=step,
        mesh=plan.mesh,
        params=dict(plan.param_specs),
        scalars=dict(scalars or {}) | {"step": step},
        config_fingerprint=dict(config_fingerprint or {}),
        save_mode="dedup",
    )
    ckpt = DistCheckpoint.create(root, manifest)
    written = 0
    digests: dict[str, str] = {}
    for name, spec in plan.param_specs.items():
        for kind, arr in snap[name].items():
            arr = arr.astype(resolve_dtype(spec.states[kind].dtype), copy=False)
            layout = spec.layout_for(kind, plan.mesh)
            for rank in ckpt.writing_ranks(name, kind):
                shard = slice_shard(arr, layout, rank)
                written += ckpt.write_shard(rank, name, kind, shard, fsync=True)
                digests[shard_digest_key(rank, name, kind)] = content_digest(shard)
    manifest.shard_digests = digests
    ckpt.rewrite_manifest()
    ckpt.commit()
    return SaveResult(
        step, Path(root), written, time.perf_counter() - t0,
        shards_written=len(digests),
    )
