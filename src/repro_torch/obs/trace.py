"""Span tracer with near-zero disabled cost (the accounting spine).

The pattern is the same as :func:`repro_torch.chaos.points.fault_point`: a
single module-level global read and a branch.  When no tracer is enabled,
:func:`span` returns one shared no-op singleton (no allocation), and
:func:`add`/:func:`event` return after one ``is None`` check — the
instrumented hot paths (per-shard writes, arena allocs, handle-cache
lookups) pay only a function call.  Modules carrying instrumentation
import nothing but ``repro_torch.obs``.

When a :class:`Tracer` is enabled (process-exclusive, like a chaos
controller), :func:`span` returns a real :class:`Span` context manager.
Spans nest through a per-thread stack; crossing a thread boundary (the
engine worker pool, ``AsyncSaver``/``HotDrainer`` queues) needs *explicit*
parent propagation: capture ``obs.current()`` where the work is submitted
and re-establish it in the worker with ``obs.attach(parent)``.  Nothing is
inherited implicitly — a span recorded on a worker thread without a
handoff is simply a root span, which is loud in the exported timeline.

Timestamps are ``time.perf_counter_ns()`` relative to the tracer's epoch:
one monotonic timebase for every thread, so exported ``ts``/``dur`` pairs
are mutually consistent (children lie inside their parents).  Wall-clock
never enters the trace; the injectable ``repro_torch.core.clock`` stays a
commit/GC-policy concern (see its docstring).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Iterator

__all__ = [
    "Span",
    "Tracer",
    "active",
    "add",
    "attach",
    "current",
    "disable",
    "enable",
    "enabled",
    "event",
    "span",
    "timed",
]


_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """One timed operation.  Context manager; re-entrant use is a bug."""

    __slots__ = (
        "name",
        "attrs",
        "span_id",
        "parent_id",
        "tid",
        "thread_name",
        "t0_ns",
        "t1_ns",
        "_tracer",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        parent_id: int | None,
        attrs: dict[str, Any],
    ):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id = parent_id
        self.tid = 0
        self.thread_name = ""
        self.t0_ns = 0
        self.t1_ns = 0

    def set(self, **attrs: Any) -> "Span":
        """Merge attributes into the span (chainable)."""
        self.attrs.update(attrs)
        return self

    @property
    def elapsed_s(self) -> float:
        end = self.t1_ns if self.t1_ns else time.perf_counter_ns()
        return (end - self.t0_ns) / 1e9

    def __enter__(self) -> "Span":
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name
        _stack().append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1_ns = time.perf_counter_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # exited out of order (generator teardown, etc.)
            st.remove(self)
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._finish(self)
        return False

    def record(self, epoch_ns: int) -> dict[str, Any]:
        """Plain-dict form consumed by every sink."""
        return {
            "kind": "span",
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "tid": self.tid,
            "thread": self.thread_name,
            "ts_us": (self.t0_ns - epoch_ns) / 1e3,
            "dur_us": (self.t1_ns - self.t0_ns) / 1e3,
            "attrs": dict(self.attrs),
        }


class _NullSpan:
    """Shared no-op span/context: the disabled-tracer fast path returns
    this singleton, so the hot branch allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Stopwatch:
    """Timing-only fallback for :func:`timed` while tracing is disabled:
    call sites that feed ``wall_time_s`` into their stats dataclasses
    still get a measurement, just no recorded span."""

    __slots__ = ("t0_ns", "t1_ns")

    def __enter__(self) -> "_Stopwatch":
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns = 0
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1_ns = time.perf_counter_ns()
        return False

    def set(self, **attrs: Any) -> "_Stopwatch":
        return self

    @property
    def elapsed_s(self) -> float:
        end = self.t1_ns if self.t1_ns else time.perf_counter_ns()
        return (end - self.t0_ns) / 1e9


class _Attach:
    """Re-establish a captured parent span on this thread (explicit
    cross-thread handoff).  Does not time anything."""

    __slots__ = ("_parent",)

    def __init__(self, parent: Span):
        self._parent = parent

    def __enter__(self) -> Span:
        _stack().append(self._parent)
        return self._parent

    def __exit__(self, exc_type, exc, tb) -> bool:
        st = _stack()
        if st and st[-1] is self._parent:
            st.pop()
        elif self._parent in st:
            st.remove(self._parent)
        return False


class Tracer:
    """Collects finished spans, instant events and counters.

    Always records in memory (`span_records()` — the test recorder);
    extra streaming sinks (e.g. :class:`repro_torch.obs.sinks.JsonlSink`)
    receive each record as it finishes, so a crashed process still leaves
    a partial timeline on disk.
    """

    def __init__(self, sinks: list | None = None):
        from repro_torch.obs.metrics import Metrics  # leaf module, no cycle

        self.metrics = Metrics()
        self.epoch_ns = time.perf_counter_ns()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._spans: list[dict[str, Any]] = []  #: guarded by self._lock
        self._events: list[dict[str, Any]] = []  #: guarded by self._lock
        self._sinks = list(sinks or [])

    # -- producers ---------------------------------------------------------
    def span(self, name: str, parent: Span | None = None, **attrs: Any) -> Span:
        if parent is not None:
            pid = parent.span_id
        else:
            st = _stack()
            pid = st[-1].span_id if st else None
        return Span(self, name, pid, attrs)

    def emit_event(self, name: str, attrs: dict[str, Any]) -> None:
        t = threading.current_thread()
        st = _stack()
        rec = {
            "kind": "event",
            "name": name,
            "parent_id": st[-1].span_id if st else None,
            "tid": t.ident or 0,
            "thread": t.name,
            "ts_us": (time.perf_counter_ns() - self.epoch_ns) / 1e3,
            "attrs": dict(attrs),
        }
        with self._lock:
            self._events.append(rec)
            for s in self._sinks:
                s.on_record(rec)

    def _finish(self, span: Span) -> None:
        rec = span.record(self.epoch_ns)
        with self._lock:
            self._spans.append(rec)
            for s in self._sinks:
                s.on_record(rec)

    # -- consumers ---------------------------------------------------------
    def span_records(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def event_records(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def timeline(self) -> list[dict[str, Any]]:
        """Spans + events merged, time-ordered — the chaos artifact form."""
        with self._lock:
            out = self._spans + self._events
        return sorted(out, key=lambda r: r["ts_us"])

    def counters(self) -> dict[str, float]:
        return self.metrics.counters()

    def summary(self) -> str:
        from repro_torch.obs.sinks import format_summary

        return format_summary(self.span_records(), self.counters())

    def chrome_trace(self) -> dict[str, Any]:
        from repro_torch.obs.sinks import chrome_trace

        return chrome_trace(self)

    def export_chrome(self, path) -> None:
        from repro_torch.obs.sinks import write_chrome_trace

        write_chrome_trace(path, self)

    def close(self) -> None:
        for s in self._sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()


# ---------------------------------------------------------------------------
# The process-wide gate.  Same discipline as chaos/points.py: one global,
# exclusive activation, idempotent guarded deactivation.

_tracer: Tracer | None = None
_activation_lock = threading.Lock()


def enable(tracer: Tracer | None = None) -> Tracer:
    """Install ``tracer`` (or a fresh one) as the process-wide sink."""
    global _tracer
    with _activation_lock:
        if _tracer is not None:
            raise RuntimeError(
                "a tracer is already enabled; tracing is process-exclusive "
                "(disable the other one first)"
            )
        _tracer = tracer if tracer is not None else Tracer()
        return _tracer


def disable(tracer: Tracer | None = None) -> None:
    """Remove the enabled tracer (idempotent).  Passing the tracer makes
    the call a no-op when someone else's is installed."""
    global _tracer
    with _activation_lock:
        if tracer is not None and _tracer is not tracer:
            return
        _tracer = None


def active() -> Tracer | None:
    return _tracer


class _Enabled:
    """``with obs.enabled() as tracer:`` — scoped enable/disable."""

    __slots__ = ("_tracer",)

    def __init__(self, tracer: Tracer | None):
        self._tracer = tracer

    def __enter__(self) -> Tracer:
        self._tracer = enable(self._tracer)
        return self._tracer

    def __exit__(self, exc_type, exc, tb) -> bool:
        disable(self._tracer)
        return False


def enabled(tracer: Tracer | None = None) -> _Enabled:
    return _Enabled(tracer)


# ---------------------------------------------------------------------------
# Hot-path entry points: one global read + branch when disabled.


def span(name: str, /, parent: Span | None = None, **attrs: Any):
    """Open a span.  Returns the shared no-op singleton when disabled."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, parent=parent, **attrs)


def timed(name: str, /, parent: Span | None = None, **attrs: Any):
    """Like :func:`span` but always measures: the disabled path returns a
    plain stopwatch whose ``elapsed_s`` feeds the stats dataclasses.  Use
    at the ~per-save/per-restore granularity, not per-shard."""
    t = _tracer
    if t is None:
        return _Stopwatch()
    return t.span(name, parent=parent, **attrs)


def add(name: str, value: float = 1, /) -> None:
    """Bump a counter.  No-op (one global read + branch) when disabled."""
    t = _tracer
    if t is not None:
        t.metrics.add(name, value)


def gauge(name: str, value: float, /) -> None:
    """Set a gauge to its latest value.  No-op when disabled."""
    t = _tracer
    if t is not None:
        t.metrics.set_gauge(name, value)


def event(name: str, /, **attrs: Any) -> None:
    """Record an instant event (fault-point hit, invariant check, tier
    fallback).  No-op when disabled."""
    t = _tracer
    if t is not None:
        t.emit_event(name, attrs)


def current() -> Span | None:
    """The innermost open span on this thread (the handoff token to
    capture before crossing a thread boundary)."""
    if _tracer is None:
        return None
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def attach(parent: Span | None):
    """Context manager making ``parent`` the current span on this thread.

    The explicit cross-thread handoff: capture ``obs.current()`` at
    submit time, ``with obs.attach(parent):`` in the worker."""
    if _tracer is None or parent is None:
        return NULL_SPAN
    return _Attach(parent)


def iter_children(records: list[dict[str, Any]], span_id: int) -> Iterator[dict]:
    """Direct children of ``span_id`` among span records (shared helper
    for summaries and coverage checks)."""
    for r in records:
        if r.get("parent_id") == span_id and r.get("kind") == "span":
            yield r
