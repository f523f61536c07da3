"""Trace sinks: in-memory recorder, JSONL stream, Chrome trace export.

All sinks consume the plain-dict records produced by
:class:`repro_torch.obs.trace.Tracer` (``kind``: ``span`` or ``event``) — no
sink imports the tracer, so the dependency points one way.

Formats
-------
* **Recorder** — appends records to lists; the test sink.
* **JsonlSink** — one JSON object per line, written as each span
  *finishes* (a crash leaves a partial timeline on disk).  The line form
  is exactly the record dict.
* **Chrome trace** — ``{"traceEvents": [...]}`` loadable by Perfetto /
  ``chrome://tracing``: ``ph:"X"`` complete events for spans (``ts`` /
  ``dur`` in microseconds on one monotonic timebase), ``ph:"i"`` instant
  events, ``ph:"M"`` thread-name metadata, and the final counter
  snapshot under ``otherData.counters``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

__all__ = [
    "JsonlSink",
    "Recorder",
    "chrome_trace",
    "format_summary",
    "validate_chrome_trace",
    "write_chrome_trace",
]


class Recorder:
    """In-memory streaming sink (tests; chaos timelines)."""

    def __init__(self) -> None:
        self.records: list[dict[str, Any]] = []

    def on_record(self, rec: dict[str, Any]) -> None:
        self.records.append(rec)

    def spans(self) -> list[dict[str, Any]]:
        return [r for r in self.records if r["kind"] == "span"]

    def events(self) -> list[dict[str, Any]]:
        return [r for r in self.records if r["kind"] == "event"]


class JsonlSink:
    """Append-per-record JSONL writer.

    Opened lazily on the first record so constructing a tracer with a
    configured-but-unused sink touches no filesystem (the benchmark file
    census counts every byte under its tmp roots)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = None

    def on_record(self, rec: dict[str, Any]) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "w", encoding="utf-8")
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def chrome_trace(tracer) -> dict[str, Any]:
    """Render a tracer's records as a Chrome trace-event document."""
    events: list[dict[str, Any]] = []
    threads: dict[int, str] = {}
    for rec in tracer.span_records():
        threads.setdefault(rec["tid"], rec["thread"])
        events.append(
            {
                "name": rec["name"],
                "cat": rec["name"].split(".", 1)[0],
                "ph": "X",
                "ts": rec["ts_us"],
                "dur": rec["dur_us"],
                "pid": 1,
                "tid": rec["tid"],
                "args": dict(rec["attrs"])
                | {"span_id": rec["span_id"], "parent_id": rec["parent_id"]},
            }
        )
    for rec in tracer.event_records():
        threads.setdefault(rec["tid"], rec["thread"])
        events.append(
            {
                "name": rec["name"],
                "cat": rec["name"].split(".", 1)[0],
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": rec["ts_us"],
                "pid": 1,
                "tid": rec["tid"],
                "args": dict(rec["attrs"]),
            }
        )
    for tid, name in sorted(threads.items()):
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": name},
            }
        )
    events.sort(key=lambda e: e.get("ts", -1))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": "repro-trace/v1",
            "counters": tracer.counters(),
            "gauges": tracer.metrics.gauges(),
        },
    }


def write_chrome_trace(path: str | Path, tracer) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(tracer)), encoding="utf-8")
    return path


def validate_chrome_trace(doc: dict[str, Any]) -> int:
    """Assert the exported document is schema-valid and the timebase is
    consistent: ``ts``/``dur`` non-negative numbers, every span's parent
    interval contains it.  Returns the number of complete events.  Used
    by the CI obs smoke and the tests — one validator, no drift."""
    assert isinstance(doc.get("traceEvents"), list), "missing traceEvents list"
    spans_by_id: dict[int, dict[str, Any]] = {}
    complete = 0
    for ev in doc["traceEvents"]:
        assert ev.get("ph") in ("X", "i", "M"), f"unexpected phase: {ev}"
        if ev["ph"] == "M":
            continue
        assert isinstance(ev.get("name"), str) and ev["name"], ev
        ts = ev.get("ts")
        assert isinstance(ts, (int, float)) and ts >= 0, f"bad ts: {ev}"
        if ev["ph"] == "X":
            dur = ev.get("dur")
            assert isinstance(dur, (int, float)) and dur >= 0, f"bad dur: {ev}"
            spans_by_id[ev["args"]["span_id"]] = ev
            complete += 1
    for ev in spans_by_id.values():
        pid = ev["args"].get("parent_id")
        parent = spans_by_id.get(pid) if pid is not None else None
        if parent is None:
            continue
        # One monotonic timebase: a child never starts before its parent
        # (tolerate a microsecond of rounding at the edges), and same-thread
        # children — genuine call-stack nesting — lie fully inside the
        # parent.  Cross-thread children are async continuations (the
        # AsyncSaver/HotDrainer handoff) and may outlive the submitting
        # span, so only the start bound applies.
        assert ev["ts"] >= parent["ts"] - 1, (ev, parent)
        if ev["tid"] == parent["tid"]:
            assert ev["ts"] + ev["dur"] <= parent["ts"] + parent["dur"] + 1, (
                ev,
                parent,
            )
    assert complete > 0, "trace contains no complete events"
    return complete


def format_summary(
    span_records: list[dict[str, Any]], counters: dict[str, float]
) -> str:
    """Aggregation table: per span name count / total / mean / max ms,
    then the counter snapshot.  The quick ``where did the time go``
    answer without leaving the terminal."""
    agg: dict[str, list[float]] = {}
    for r in span_records:
        agg.setdefault(r["name"], []).append(r["dur_us"] / 1e3)
    lines = [f"{'span':<28} {'count':>6} {'total_ms':>10} {'mean_ms':>9} {'max_ms':>9}"]
    for name in sorted(agg, key=lambda n: -sum(agg[n])):
        ds = agg[name]
        lines.append(
            f"{name:<28} {len(ds):>6} {sum(ds):>10.2f} "
            f"{sum(ds) / len(ds):>9.3f} {max(ds):>9.3f}"
        )
    if counters:
        lines.append("")
        lines.append(f"{'counter':<42} {'value':>14}")
        for name in sorted(counters):
            v = counters[name]
            lines.append(f"{name:<42} {v:>14g}")
    return "\n".join(lines)
