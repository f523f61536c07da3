"""Named fault points: the hook layer the chaos harness injects through
(port of ``repro.chaos.points``; ``CATALOG`` is the reference's, word for
word).

A fault point is one named, deliberately-chosen spot in the checkpoint
machinery where a real deployment could die or misbehave: between writing
shards and the commit marker, between a GC decision and its rmtree,
between a publication's store-GC and its delivery.  Production code calls
:func:`fault_point` at each of them; when no controller is active the call
is a single global read and a branch — zero-cost no-op — and the modules
carrying the points import nothing but this file.

When a controller is active (:func:`activate`: anything with
``on_point(name, ctx)``, such as
:class:`~repro_torch.chaos.schedule.ChaosController`), each hit reaches
it, and it may raise :class:`FaultError` (a crash), act on the environment
(rank loss, storage loss, peer poisoning, clock skew), or pause the hitting
thread on a gate so a test can build an exact interleaving.  ``CATALOG`` is
the authoritative list of point names; schedules naming an unknown point
are refused when they are built.

Placement rule: a fault point never fires while holding a lock another
fault point's thread might need — pauses must be able to stall a thread
indefinitely without deadlocking the rest of the run.
"""

from __future__ import annotations

import threading
from typing import Any, Mapping, Protocol

__all__ = [
    "CATALOG",
    "FaultError",
    "activate",
    "active_controller",
    "deactivate",
    "fault_point",
]


class FaultError(RuntimeError):
    """An injected crash.  Raised *by the harness, on purpose* out of a
    fault point — harness code recognizes its own faults by this type
    (anywhere in the ``__cause__``/``__context__`` chain) and treats them
    as scheduled failure events, never as bugs."""


# point name -> where it sits / what a fault there models.  One entry per
# fault_point() call site; tests assert the two sets match.
CATALOG: dict[str, str] = {
    "saver.shard": "write_distributed, before persisting one shard (crash mid-save)",
    "saver.pre_manifest": "write_distributed, shards done, digest manifest not yet rewritten",
    "saver.pre_commit": "write_distributed, everything durable except the COMMIT marker",
    "drain.enqueue": "HotDrainer.maybe_drain, promotion about to be queued",
    "drain.shard": "persist_snapshot, before persisting one promoted fragment (crash mid-drain)",
    "drain.pre_commit": "persist_snapshot, all fragments durable except the COMMIT marker",
    "dist.pre_commit": "DistCheckpoint.commit, marker about to be written (any save path)",
    "dist.committed": "DistCheckpoint.commit, marker just became visible",
    "manager.save.begin": "CheckpointManager.save entry (crash before any bytes move)",
    "manager.gc.begin": "CheckpointManager.gc entry (clock-skew / crash before any deletion)",
    "manager.gc.delete": "CheckpointManager.gc, one committed step about to be rmtree'd",
    "manager.gc.wreckage": "CheckpointManager.gc, one uncommitted directory about to be rmtree'd",
    "manager.restore.begin": "CheckpointManager.restore entry (crash mid-resume)",
    "hot.capture": "HotTier.capture entry (rank loss racing an in-flight capture)",
    "registry.publish.begin": "PublicationRegistry.publish entry, before the store GC",
    "registry.publish.deliver": "publish: store GC done, announcement not yet delivered (crash mid-publish)",
    "peer.fetch": "PeerFragmentSource fetch ladder entry for one shard (crash mid-stream)",
}


class Controller(Protocol):
    def on_point(self, name: str, ctx: Mapping[str, Any]) -> None: ...


_controller: Controller | None = None
_activation_lock = threading.Lock()


def fault_point(point: str, /, **ctx: Any) -> None:
    """Hit one named fault point.  No-op unless a controller is active.

    ``point`` is positional-only so ctx keys (``name=...`` for a param
    name, etc.) can never collide with it."""
    c = _controller
    if c is not None:
        c.on_point(point, ctx)


def activate(controller: Controller) -> None:
    """Install ``controller`` as the process-wide fault-point sink."""
    global _controller
    with _activation_lock:
        if _controller is not None:
            raise RuntimeError(
                "a chaos controller is already active; chaos runs are "
                "process-exclusive (deactivate the other one first)"
            )
        _controller = controller


def deactivate(controller: Controller | None = None) -> None:
    """Remove the active controller (idempotent).  Passing the controller
    makes the call a no-op when someone else's is installed."""
    global _controller
    with _activation_lock:
        if controller is not None and _controller is not controller:
            return
        _controller = None


def active_controller() -> Controller | None:
    return _controller
