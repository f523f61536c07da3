"""The distribution layer of the port (port of ``repro.dist``).

* :mod:`repro_torch.dist.sharding` — the sharding rule table (the plan's
  checkpoint specs and runtime ``PartitionSpec``s) and the multi-rank
  runtime's helpers: :class:`RankGroups` (a rank's place and subgroups in a
  ``torch.distributed`` group over the mesh), :func:`gather_full`,
  :func:`local_shard`, :func:`rank_rows`.
* :mod:`repro_torch.dist.collectives` — compressed gradient collectives
  (block-wise int8 quantization with error feedback) over a
  ``torch.distributed`` process group.
"""

from .collectives import compressed_psum, dequantize_int8, quantize_int8
from .sharding import (
    PartitionSpec,
    RankGroups,
    ShardingPlan,
    gather_full,
    local_shard,
    make_plan,
    rank_rows,
    vocab_multiple,
)

__all__ = [
    "PartitionSpec",
    "RankGroups",
    "ShardingPlan",
    "compressed_psum",
    "dequantize_int8",
    "gather_full",
    "local_shard",
    "make_plan",
    "quantize_int8",
    "rank_rows",
    "vocab_multiple",
]
