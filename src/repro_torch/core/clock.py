"""Wall clock for commit time stamps (port of ``repro.core.clock``).

``DistManifest.created_at`` and the COMMIT marker are stamped through
:func:`now`, the one place the checkpoint layer reads the wall clock.
Discovery orders checkpoints by *step directory name*, never by these
stamps.  The reference makes this clock schedulable for its chaos harness
(``skew``, ``set_source``); those hooks come with the chaos port (ROADMAP
queue 1, item 9).
"""

from __future__ import annotations

import time as _time

__all__ = ["now"]


def now() -> float:
    """Current wall-clock time as the checkpoint layer sees it."""
    return _time.time()
