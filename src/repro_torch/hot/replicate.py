"""Buddy-group replica placement for the hot in-memory tier (port of
``repro.hot.replicate``: pure arithmetic over the layout, the reference's).

Peer replication is what turns a per-rank host-memory snapshot into a
*recoverable* checkpoint: when rank r dies, its fragments survive in the
memory of the peers that mirror it (Checkmate / REFT style).  Placement
answers, for each persisted fragment, *whose host memory holds a copy*.

Two sources of redundancy compose:

* **natural replication** — the sharding plan already replicates many
  fragments across ranks (the DP dimension, replicated norms/biases).
  Those ranks hold byte-identical data at runtime for free, so the hot
  tier records them as holders without copying anything — this is the
  "skip fragments already replicated by the DP dedup" rule.
* **buddy mirroring** — fragments whose natural replica group is smaller
  than the requested redundancy get mirrored onto peer ranks from the
  owner's *buddy group* (contiguous groups of ``replication + 1`` ranks,
  extended ring-wise when the group is exhausted, e.g. the tail group of
  a non-divisible world size).  Buddy groups keep mirror traffic local —
  in a real deployment a group maps to one switch/host neighborhood.

Placement is pure math over the layout (no arrays move here); the tier's
capture path copies bytes once per *stored* fragment regardless of how
many holders record it.

**Binomial fan-out trees** (``binomial_parent`` / ``fanout_ladder``)
generalize the buddy idea from *redundancy* to *distribution*: where a
buddy group answers "who mirrors rank r's fragment", the binomial tree
answers "whom should the p-th consumer of a shard fetch it from" so that
one disk read fans out to N readers in O(log N) per-node load.  Node p's
parent is p with its highest set bit cleared — the classic binomial-tree
broadcast shape (node 0 is the first fetcher, fed by the root tier, e.g.
disk): every node's children are ``p + 2^k`` for each k above its own
width, so no node serves more than O(log N) peers.  The serving fan-out
tier (the reference's ``repro.serve``; ROADMAP item 8 in the port) walks
``fanout_ladder(p)`` — the ancestor chain, nearest first — as its
fetch-preference order, with the remaining holders
and finally the root tier as fallbacks when an ancestor is gone or fails
digest verification.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.layout import ShardLayout

__all__ = [
    "ReplicationPolicy",
    "ReplicaStats",
    "binomial_parent",
    "buddy_group",
    "fanout_ladder",
    "mirror_targets",
    "natural_holders",
    "place_holders",
]


def binomial_parent(index: int) -> int | None:
    """Parent of node ``index`` in the binomial broadcast tree (None for 0).

    Clears the highest set bit: 1→0, 2→0, 3→1, 11→3, ... — node 0 is the
    tree root (the first fetcher, fed directly by the root tier).
    """
    if index < 0:
        raise ValueError(f"index must be >= 0, got {index}")
    if index == 0:
        return None
    return index ^ (1 << (index.bit_length() - 1))


def fanout_ladder(index: int) -> list[int]:
    """Ancestor chain of node ``index``, nearest first, ending at 0.

    ``fanout_ladder(11) == [3, 1, 0]`` — the fetch-preference order of the
    11th consumer of a shard: try the parent, then each higher ancestor,
    and only then fall back outside the tree.  Length is O(log index) =
    popcount(index), which is what bounds any single node's serving load.
    """
    if index < 0:
        raise ValueError(f"index must be >= 0, got {index}")
    out: list[int] = []
    while index > 0:
        index ^= 1 << (index.bit_length() - 1)
        out.append(index)
    return out


@dataclasses.dataclass(frozen=True)
class ReplicationPolicy:
    """How many host memories must hold each fragment.

    ``replication`` is the number of *extra* copies beyond the owner — the
    hot tier survives any simultaneous failure of ``replication`` ranks.
    ``group_size`` overrides the buddy-group width (default
    ``replication + 1``).
    """

    replication: int = 1
    group_size: int | None = None

    def __post_init__(self) -> None:
        if self.replication < 0:
            raise ValueError(f"replication must be >= 0, got {self.replication}")

    def holders_needed(self, world: int) -> int:
        return min(self.replication + 1, world)


@dataclasses.dataclass
class ReplicaStats:
    """Accounting of one capture's replica placement.

    ``HotTier.capture`` folds these fields into the obs counters
    (``hot.fragments`` / ``hot.stored_bytes`` / ``hot.resident_bytes`` /
    ``hot.mirrored_bytes``) so the dataclass and the metric registry can
    never disagree — one accumulation site feeds both."""

    fragments: int = 0          # distinct fragments stored
    natural_fragments: int = 0  # redundancy met by the sharding plan alone
    stored_bytes: int = 0       # bytes stored once per fragment
    mirrored_bytes: int = 0     # extra bytes buddy peers would copy
    resident_bytes: int = 0     # total across all rank memories (holders × size)


def buddy_group(rank: int, world: int, group_size: int) -> list[int]:
    """The contiguous buddy group containing ``rank``.

    Groups tile ``[0, world)`` in order; the tail group may be smaller than
    ``group_size`` when the world size is not divisible (callers extend
    ring-wise past the group when they need more peers).
    """
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for world {world}")
    group_size = max(1, min(group_size, world))
    g0 = (rank // group_size) * group_size
    return list(range(g0, min(g0 + group_size, world)))


def place_holders(
    layout: ShardLayout,
    owner: int,
    policy: ReplicationPolicy,
    *,
    natural_replication: bool = True,
    exclude: frozenset[int] | set[int] = frozenset(),
) -> tuple[int, ...]:
    """Ranks whose host memory holds ``owner``'s fragment (owner first).

    ``natural_replication=False`` disables the free-replica rule — used for
    ``params_to_average`` state, where ranks that share a fragment_id still
    hold *divergent* bytes, so only buddy mirroring provides redundancy.

    ``exclude``: ranks whose host memory is already lost (prior failures).
    Dead ranks are never recorded as holders — a capture taken after a
    failure places its mirrors on the *surviving* peers, so the
    replication guarantee keeps holding going forward instead of silently
    decaying to the dead buddies.
    """
    world = layout.mesh.size
    live_world = world - len(set(exclude) & set(range(world)))
    need = max(1, min(policy.replication + 1, live_world))
    holders: list[int] = [] if owner in exclude else [owner]
    if natural_replication:
        for r in layout.ranks_for_fragment(layout.fragment_id[owner]):
            if r not in holders and r not in exclude:
                holders.append(r)
    natural = len(holders)
    if natural < need:
        for peer in buddy_group(owner, world, policy.group_size or need):
            if len(holders) >= need:
                break
            if peer not in holders and peer not in exclude:
                holders.append(peer)
        # buddy group exhausted (tail group / dead buddies): extend
        # ring-wise over the remaining live ranks.
        for step in range(1, world):
            if len(holders) >= need:
                break
            peer = (owner + step) % world
            if peer not in holders and peer not in exclude:
                holders.append(peer)
    return tuple(holders)


def natural_holders(
    layout: ShardLayout, owner: int, *, natural_replication: bool = True
) -> frozenset[int]:
    """Ranks whose runtime state holds ``owner``'s fragment byte for byte:
    the ranks of its fragment, or the owner alone when replicas diverge
    (``natural_replication=False``, as for :func:`place_holders`)."""
    if not natural_replication:
        return frozenset((owner,))
    return frozenset(layout.ranks_for_fragment(layout.fragment_id[owner]))


def mirror_targets(
    layout: ShardLayout,
    owner: int,
    holders: tuple[int, ...],
    *,
    natural_replication: bool = True,
) -> tuple[int, ...]:
    """The holders that must receive ``owner``'s bytes when every rank is a
    process (the buddy mirrors, in holder order): every holder that is not a
    natural one, which stages its own identical runtime copy instead."""
    natural = natural_holders(layout, owner, natural_replication=natural_replication)
    return tuple(h for h in holders if h not in natural)
