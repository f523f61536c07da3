"""Injectable wall clock for commit/GC time stamps (port of
``repro.core.clock``).

``DistManifest.created_at`` and the COMMIT marker are stamped through
:func:`now`, the one place the checkpoint layer reads the wall clock.  In
production it is ``time.time()``; under the chaos harness
(:mod:`repro_torch.chaos`) the clock is a schedulable fault: ``skew()``
shifts it, ``set_source`` replaces it.  Discovery and GC order checkpoints
by *step directory name*, never by these stamps, so a skewed clock changes
what ``created_at`` and COMMIT record but never which step is "newest".

Durations are measured on :mod:`repro_torch.obs`'s monotonic timebase,
which clock skew never touches.
"""

from __future__ import annotations

import time as _time
from typing import Callable

__all__ = ["now", "reset", "set_source", "skew"]

_offset: float = 0.0
_source: Callable[[], float] | None = None


def now() -> float:
    """Current wall-clock time as the checkpoint layer sees it."""
    src = _source
    base = src() if src is not None else _time.time()
    return base + _offset


def skew(seconds: float) -> float:
    """Shift the clock by ``seconds`` (cumulative); returns the new offset."""
    global _offset
    _offset += float(seconds)
    return _offset


def set_source(fn: Callable[[], float] | None) -> None:
    """Replace the underlying time source (None restores ``time.time``)."""
    global _source
    _source = fn


def reset() -> None:
    """Back to the real clock, zero skew."""
    global _offset, _source
    _offset = 0.0
    _source = None
