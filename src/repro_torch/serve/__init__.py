"""Checkpoint fan-out: publish committed checkpoints to a serving fleet
(port of ``repro.serve``).

The inference side of UCP: a training job announces each committed step to
a :class:`PublicationRegistry`; N resharding readers subscribe and restore
through :class:`PeerFragmentSource`, the engine's fragment-source protocol
served from *peer replicas that already hold the bytes*, in binomial-tree
order, with disk as the root and fallback tier.  An N-reader fleet costs
O(1) disk traffic:

* every peer-fetched shard is checked against the publication's content
  digest: a corrupt copy evicts its holder and is fetched again from the
  next tier, never served;
* readers sharing an engine also share the *serving hot set*
  (:meth:`~repro_torch.core.engine.CheckpointEngine.shared_region` and the
  consolidated-atom cache keyed by the publication), and the built
  tensors: each Target region, fused atom and weight is assembled once per
  fleet;
* steady-state publishes are *delta-aware*: the announcement carries the
  changed-shard set, and a current :class:`FleetReplica` updates in place
  by rebuilding only the parameters that changed.

Give a :class:`~repro_torch.ckpt.manager.CheckpointManager` a registry
(``CheckpointPolicy(registry=...)``) and every committed save is published.

* :mod:`repro_torch.serve.registry` — publications, subscriptions, the
  content-addressed peer byte store
* :mod:`repro_torch.serve.peer`     — ``PeerFragmentSource`` and the fetch
  ladder
* :mod:`repro_torch.serve.fleet`    — ``FleetReplica``: subscribe, restore,
  in-place delta updates
"""

from .fleet import FleetReplica
from .peer import FanoutStats, PeerFragmentSource
from .registry import Publication, PublicationRegistry, Subscription

__all__ = [
    "FanoutStats",
    "FleetReplica",
    "PeerFragmentSource",
    "Publication",
    "PublicationRegistry",
    "Subscription",
]
