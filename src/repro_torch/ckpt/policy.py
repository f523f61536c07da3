"""CheckpointPolicy: every checkpointing knob, one validated object
(port of ``repro.ckpt.policy``).

Every field and default is the reference's, with its validation and the
``codec=`` tag shorthand.  Knobs whose machinery the port does not have
yet raise ``NotImplementedError`` naming the ROADMAP item that brings it:
the hot tier (``hot_interval``), delta saves (``save_mode="delta"``), the
fan-out registry (``registry``) and the parallel I/O pool (``io_workers``
above 1).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.codec import CodecPolicy

__all__ = ["CheckpointPolicy"]


@dataclasses.dataclass
class CheckpointPolicy:
    """Checkpoint cadence, retention, tiering, delta and codec policy.

    ================== ====================================================
    ``keep_last``      committed steps retained by GC
    ``save_interval``  steps between saves
    ``disk_interval``  steps between durable disk checkpoints (defaults to
                       ``save_interval``; only meaningful with a hot tier)
    ``hot_interval``   steps between in-memory snapshots (None = off)
    ``hot_replication``      extra peer copies per hot fragment
    ``hot_max_snapshots``    ring bound on live hot snapshots
    ``hot_max_bytes``        ring bound on hot arena bytes
    ``async_save``     overlap file I/O with training
    ``max_pending_saves``    backpressure bound on in-flight async saves
    ``io_workers``     checkpoint I/O pool width (None = process default)
    ``save_mode``      "dedup" | "all" | "delta"
    ``full_interval``  every Nth disk save is a full rebase (delta mode)
    ``codec``          a :class:`~repro_torch.core.codec.CodecPolicy`, a
                       codec tag (shorthand for "code the optimizer moments
                       with this tag, keep params raw"), or None (all raw)
    ``registry``       fan-out publication registry
    ================== ====================================================
    """

    keep_last: int = 3
    save_interval: int = 50
    disk_interval: int | None = None
    hot_interval: int | None = None
    hot_replication: int = 1
    hot_max_snapshots: int = 4
    hot_max_bytes: int = 2 << 30
    async_save: bool = True
    max_pending_saves: int = 2
    io_workers: int | None = None
    save_mode: str = "dedup"
    full_interval: int = 8
    codec: CodecPolicy | str | None = None
    registry: object | None = None

    def __post_init__(self):
        if self.save_mode not in ("dedup", "all", "delta"):
            raise ValueError(
                f"save_mode must be 'dedup', 'all' or 'delta', got {self.save_mode!r}"
            )
        for field in ("keep_last", "save_interval", "full_interval", "max_pending_saves"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, got {getattr(self, field)}")
        for field in ("hot_interval", "disk_interval"):
            if getattr(self, field) is not None and getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1, got {getattr(self, field)}")
        if self.hot_replication < 0:
            raise ValueError(f"hot_replication must be >= 0, got {self.hot_replication}")
        if isinstance(self.codec, str):
            # tag shorthand: lossy-tolerant moments, raw (bit-exact) params
            self.codec = CodecPolicy.moments(self.codec)
        elif self.codec is not None and not isinstance(self.codec, CodecPolicy):
            raise TypeError(
                f"codec must be a CodecPolicy, a codec tag string or None, "
                f"got {type(self.codec).__name__}"
            )
        if self.codec is not None and self.codec.is_raw:
            self.codec = None  # all-raw policy == no policy
        missing = [
            (self.hot_interval is not None, "hot_interval", "item 7: hot tier"),
            (self.save_mode == "delta", "save_mode='delta'", "item 3: delta saves"),
            (self.registry is not None, "registry", "item 8: fan-out"),
            (self.io_workers is not None and self.io_workers > 1, "io_workers > 1",
             "item 3: the parallel I/O engine"),
        ]
        for hit, knob, item in missing:
            if hit:
                raise NotImplementedError(f"{knob} is not ported yet (ROADMAP queue 1, {item})")

    @property
    def effective_disk_interval(self) -> int:
        return self.disk_interval if self.disk_interval is not None else self.save_interval
