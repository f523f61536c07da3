"""Checkpoint I/O engine — public re-export (port of ``repro.ckpt.engine``).

The implementation lives in :mod:`repro_torch.core.engine`, so the core
formats (``dist_ckpt``, ``atoms``, ``convert``) use the handle cache and
the worker pool without importing the checkpointing layer.  This module is
the import point for engine users at the checkpointing API level::

    from repro_torch.ckpt.engine import CheckpointEngine

    eng = CheckpointEngine("cuda", workers=8)
    write_distributed(snap, plan, step, root, engine=eng)
    state = state_from_source(ckpt, plan, "cuda", engine=eng)
"""

from repro_torch.core.engine import (
    CheckpointEngine,
    FragmentIndex,
    HandleCache,
    default_engine,
    default_workers,
)

__all__ = [
    "CheckpointEngine",
    "FragmentIndex",
    "HandleCache",
    "default_engine",
    "default_workers",
]
