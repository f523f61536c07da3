"""FleetReplica: a subscribed serving reader that stays current in place
(port of ``repro.serve.fleet``).

The consumer side of fan-out: one replica owns a Target sharding plan
(typically a serving layout other than the training one), subscribes to a
:class:`~repro_torch.serve.registry.PublicationRegistry`, and on
``sync()``:

* first publication (or a gap in the feed): a *full* weights-only restore
  through :class:`~repro_torch.serve.peer.PeerFragmentSource`, the region
  reads of a disk restore with the bytes from peers;
* a contiguous run of delta publications: an *in-place* update, where only
  the parameters with a changed fp32 shard are rebuilt and swapped into the
  replica's dict; every other parameter keeps its tensor (the digests prove
  its bytes unchanged), so the result is bit-equal to a full restore of the
  new step.

Replicas restore the *weights* only
(:func:`~repro_torch.ckpt.restore.build_param_arrays`): a serving fleet has
no use for optimizer moments.

Replicas that share an engine also share the *built tensors*: the flat set
of one (publication, Target layout) pair is built single-flight in the
engine's atom cache, and every co-hosted replica's dict holds the same
tensors, so N replica threads on one card cost one restore.  Those tensors
are read-only: an update replaces dict entries and never writes into a
tensor, and serving casts into the replica's own copy
(``lm.registry.cast``).  A built set leaves the memo only after the card
has finished the copies that fill it, and a replica that moves to a newer
publication drops what the engine kept of the one it left, so the card
holds the live weights, not every publication's.
"""

from __future__ import annotations

import hashlib
import json

import torch

import repro_torch.obs as obs
from repro_torch.ckpt.restore import RestoreStats, build_param_arrays
from repro_torch.core.engine import CheckpointEngine, default_engine
from repro_torch.core.plan import TargetSpec, layouts_equal, stream_transforms
from repro_torch.core.pytree import unflatten_from_paths
from repro_torch.dist.sharding import ShardingPlan

from .peer import FanoutStats, PeerFragmentSource, pub_cache_key
from .registry import Publication, PublicationRegistry

__all__ = ["FleetReplica"]


class FleetReplica:
    """One serving replica: subscribe, restore, stay current in place."""

    def __init__(
        self,
        name: str,
        registry: PublicationRegistry,
        plan: ShardingPlan,
        device: str | torch.device = "cuda",
        *,
        engine: CheckpointEngine | None = None,
        stats: FanoutStats | None = None,
    ):
        self.name = str(name)
        self.registry = registry
        self.plan = plan
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but is not available (pass device='cpu')")
        # Always an engine the replica keeps: a restore made without one
        # releases the default engine's cache of the source, and the shared
        # regions and the built set would vanish between replicas.
        self.engine = engine or default_engine(self.device)
        self.stats = stats or FanoutStats()
        self.restore_stats = RestoreStats()
        self.subscription = registry.subscribe(self.name)
        self.step: int | None = None
        self.seq: int | None = None
        self.last_update: frozenset[str] = frozenset()  # params rebuilt by the last sync
        self._flat: dict[str, torch.Tensor] | None = None
        self._plan_key = _plan_fingerprint(plan)

    @property
    def params(self):
        """The live weights, nested (None before the first sync)."""
        return None if self._flat is None else unflatten_from_paths(self._flat)

    def flat_params(self) -> dict[str, torch.Tensor]:
        if self._flat is None:
            raise RuntimeError(f"replica {self.name} has not synced yet")
        return dict(self._flat)

    # -------------------------------------------------------------- syncing
    def sync(self) -> bool:
        """Apply pending publications; True if the replica updated.

        Incremental only when the feed is contiguous from this replica's
        publication (all deltas, no gap); anything else, the first sync
        included, is a full rebuild.  Either way the weights are bit-equal
        to a direct disk restore of the newest published step."""
        pubs = self.subscription.poll()
        if not pubs:
            return False
        with obs.span("serve.sync", replica=self.name) as sp:
            self._sync(pubs, sp)
        obs.add("serve.syncs")
        return True

    def _sync(self, pubs: list[Publication], sp) -> None:
        pub = pubs[-1]
        contiguous = (
            self._flat is not None
            and self.seq is not None
            and pubs[0].seq == self.seq + 1
            and all(p.kind == "delta" for p in pubs)
        )
        source = PeerFragmentSource(self.registry, pub, self.name, stats=self.stats)
        target = TargetSpec(self.plan.mesh, self.plan.param_specs)
        transforms = (None if layouts_equal(pub.manifest, target)
                      else stream_transforms(pub.manifest, target))
        if not contiguous:
            sp.set(mode="full", step=pub.step, params=len(pub.manifest.params))
            self._flat = dict(self._build_shared(source, transforms, None))
            self.last_update = frozenset(self._flat)
        else:
            # In-place delta: rebuild exactly the params with a changed fp32
            # shard anywhere in the drained window (a change to optimizer
            # state alone is invisible to a weights-only replica).
            changed = frozenset(name for p in pubs for name in _changed_fp32_params(p))
            sp.set(mode="delta", step=pub.step, params=len(changed))
            if changed:
                self._flat.update(self._build_shared(source, transforms, changed))
            self.last_update = changed
        if self.seq is not None and self.seq != pub.seq:
            # What the engine keeps of a superseded publication (its regions,
            # atoms and built set) no reader asks for again: drop it, so the
            # card holds the live weights and not every publication's.
            self.engine.invalidate(pub_cache_key(self.registry, self.seq))
        self.seq = pub.seq
        self.step = pub.step

    def _build_shared(self, source: PeerFragmentSource, transforms,
                      names: frozenset[str] | None) -> dict[str, torch.Tensor]:
        """The requested tensors, built once per (publication, Target
        layout, parameter set) *per engine*: co-hosted replicas get the same
        tensors back from the atom cache."""
        sel = "all" if names is None else hashlib.sha256(
            "\0".join(sorted(names)).encode()).hexdigest()[:16]
        key = f"{source.cache_key}::fleet::{self._plan_key}::{sel}"

        def build() -> dict[str, torch.Tensor]:
            flat = build_param_arrays(source, self.plan, self.device, transforms=transforms,
                                      names=None if names is None else set(names),
                                      stats=self.restore_stats, engine=self.engine)
            if self.device.type == "cuda":
                # other replica threads read these tensors: the copies that
                # fill them finish before they leave the memo
                torch.cuda.synchronize(self.device)
            return flat

        return self.engine.memo(key, build)


def _plan_fingerprint(plan: ShardingPlan) -> str:
    """Digest of a Target layout (mesh and every param's spec): two plans
    with equal fingerprints build bit-equal tensors, so it is a safe
    sharing key of the fleet's weight cache."""
    blob = json.dumps(
        {"mesh": plan.mesh.to_json(),
         "params": {n: s.to_json() for n, s in plan.param_specs.items()}},
        sort_keys=True,
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _changed_fp32_params(pub: Publication) -> frozenset[str]:
    """Parameter names whose *weight* shards changed in one publication."""
    out = set()
    for key in pub.changed:
        # key = "rank_NNNNN/<name>@<kind>"; names never contain "@".
        name, kind = key.split("/", 1)[1].rsplit("@", 1)
        if kind == "fp32":
            out.add(name)
    return frozenset(out)
