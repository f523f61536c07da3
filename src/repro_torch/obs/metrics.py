"""Thread-safe counters and gauges.

One flat namespace of dotted metric names (``save.bytes_written``,
``engine.handle.hit``, ``serve.fetch.peer``).  Everything funnels through
one lock — metric updates come from the engine worker pool, the async
saver/drainer threads and peer fetch paths concurrently, and a lost
increment would make the "metrics match the stats dataclasses exactly"
contract flaky.  The lock is uncontended in practice (updates are
nanoseconds apart from milliseconds of I/O).

Counters only ever add; gauges keep their latest value.  Snapshots are
plain dicts so sinks and tests can diff them (capture before, capture
after, subtract).
"""

from __future__ import annotations

import threading

__all__ = ["Metrics", "diff_counters"]


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}  #: guarded by self._lock
        self._gauges: dict[str, float] = {}  #: guarded by self._lock

    def add(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[str, float]:
        with self._lock:
            return dict(self._gauges)


def diff_counters(
    after: dict[str, float], before: dict[str, float]
) -> dict[str, float]:
    """Counter deltas between two snapshots (zero-delta keys dropped)."""
    out: dict[str, float] = {}
    for k, v in after.items():
        d = v - before.get(k, 0)
        if d:
            out[k] = d
    return out
