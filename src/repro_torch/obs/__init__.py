"""repro_torch.obs — unified tracing & metrics across the checkpoint lifecycle
(port of ``repro.obs``: standard library only, the reference's names and
record formats).

One accounting spine for what used to be ~10 scattered ``perf_counter``
sites and five disjoint stats dataclasses: spans (where did the time go),
counters (how many bytes/shards/hits), and instant events (fault-point
hits, tier fallbacks, invariant checks).  Disabled cost is one global
read + branch per call site — see ``trace.py``.

Usage::

    import repro_torch.obs as obs

    with obs.enabled() as tracer:
        ...  # any save/restore/hot/serve work
        print(tracer.summary())
        tracer.export_chrome("trace.json")   # Perfetto-loadable

The names are the reference's (:mod:`repro_torch.obs.catalog`); DESIGN.md §9
documents the taxonomy and the sink formats.
"""

from repro_torch.obs.metrics import Metrics, diff_counters
from repro_torch.obs.sinks import (
    JsonlSink,
    Recorder,
    chrome_trace,
    format_summary,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    Span,
    Tracer,
    active,
    add,
    attach,
    current,
    disable,
    enable,
    enabled,
    event,
    gauge,
    span,
    timed,
)

__all__ = [
    "JsonlSink",
    "Metrics",
    "NULL_SPAN",
    "Recorder",
    "Span",
    "Tracer",
    "active",
    "add",
    "attach",
    "chrome_trace",
    "current",
    "diff_counters",
    "disable",
    "enable",
    "enabled",
    "event",
    "format_summary",
    "gauge",
    "span",
    "timed",
    "validate_chrome_trace",
    "write_chrome_trace",
]
