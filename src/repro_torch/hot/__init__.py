"""The hot in-memory checkpoint tier (port of ``repro.hot``).

Sits *in front of* the disk formats: every ``hot_interval`` steps the
trainer's state is staged into host memory as a :class:`HotSnapshot`
(same shard geometry as the disk format, peer-replicated across buddy
ranks), every Nth snapshot is drained to a durable
:class:`~repro_torch.core.dist_ckpt.DistCheckpoint` in the background, and
recovery walks the tier ladder

    HOT_DIRECT → HOT_RESHARD → DIRECT → RESHARD_STREAM → VIA_UCP

serving from surviving in-memory replicas when it can and falling
through to disk when it cannot (see DESIGN.md §5 and
``repro_torch.hot.recovery``).

* :mod:`repro_torch.hot.snapshot`  — ``HotSnapshot`` (a fragment source)
  and the ``HotTier`` ring buffer with a byte budget
* :mod:`repro_torch.hot.replicate` — buddy-group replica placement (skips
  fragments the sharding plan already replicates)
* :mod:`repro_torch.hot.drain`     — background promotion to disk, coded
  fragments encoded on the captured state's device
* :mod:`repro_torch.hot.recovery`  — tiered resume planning and
  ``state_from_hot``
"""

from .drain import HotDrainer, persist_snapshot
from .recovery import (
    HotRecoveryPlan,
    plan_hot_recovery,
    reshard_compatible,
    state_from_hot,
)
from .replicate import (
    ReplicaStats,
    ReplicationPolicy,
    binomial_parent,
    buddy_group,
    fanout_ladder,
    place_holders,
)
from .snapshot import HotFragment, HotSnapshot, HotTier

__all__ = [
    "HotDrainer",
    "persist_snapshot",
    "HotRecoveryPlan",
    "plan_hot_recovery",
    "reshard_compatible",
    "state_from_hot",
    "ReplicaStats",
    "ReplicationPolicy",
    "binomial_parent",
    "buddy_group",
    "fanout_ladder",
    "place_holders",
    "HotFragment",
    "HotSnapshot",
    "HotTier",
]
