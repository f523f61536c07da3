"""Deterministic chaos harness of the UCP recovery ladder (port of
``repro.chaos``).

Layering matters here: production modules (``repro_torch.ckpt.saver``,
``repro_torch.hot.drain``, ...) import :mod:`repro_torch.chaos.points`, and
only that, for their ``fault_point()`` hooks, while the harness and the
invariants import those production modules back.  This ``__init__``
therefore re-exports the points layer eagerly and resolves everything else
lazily (PEP 562), so importing a production module never pulls the harness
(and a circular import) in behind it.
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
    "ChaosController",
    "ChaosHarness",
    "ChaosReport",
    "FaultError",
    "FaultSpec",
    "InvariantViolation",
    "Schedule",
    "activate",
    "active_controller",
    "check_invariants",
    "deactivate",
    "fault_point",
    "generate_schedule",
    "points",
    "run_seed",
    "shrink",
    "sweep",
]

_LAZY = {
    "ChaosController": "schedule",
    "FaultSpec": "schedule",
    "Schedule": "schedule",
    "generate_schedule": "schedule",
    "InvariantViolation": "invariants",
    "Violation": "invariants",
    "check_invariants": "invariants",
    "ChaosHarness": "harness",
    "ChaosReport": "harness",
    "run_seed": "sweep",
    "shrink": "sweep",
    "sweep": "sweep",
    "emit_regression_test": "sweep",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
