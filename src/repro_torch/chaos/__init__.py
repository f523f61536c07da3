"""Chaos hooks of the port (port of ``repro.chaos``, the points layer only).

Production modules import :mod:`repro_torch.chaos.points`, and only that,
for their ``fault_point()`` hooks.  The harness, schedules, invariants and
sweep of the reference's ``repro.chaos`` are ROADMAP item 9b.
"""

from __future__ import annotations

from . import points
from .points import (
    CATALOG,
    FaultError,
    activate,
    active_controller,
    deactivate,
    fault_point,
)

__all__ = [
    "CATALOG",
    "FaultError",
    "activate",
    "active_controller",
    "deactivate",
    "fault_point",
    "points",
]
