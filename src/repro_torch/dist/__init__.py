"""The distribution layer of the port (port of ``repro.dist``).

* :mod:`repro_torch.dist.sharding` — the sharding rule table (the plan's
  checkpoint specs and runtime ``PartitionSpec``s) and the multi-rank
  runtime's helpers: :class:`RankGroups` (a rank's place and subgroups in a
  ``torch.distributed`` group over the mesh), :func:`gather_full`,
  :func:`local_shard`, :func:`rank_rows`; the activation and decode-cache
  rules :func:`make_sharder` and :func:`cache_pspecs`.
* :mod:`repro_torch.dist.tensor_parallel` — every family's partitioned
  compute over the model axis, or by rows with tensor parallelism off
  (:class:`TensorParallel`, installed as ``LM.tp``).
* :mod:`repro_torch.dist.pipeline` — compute by pipeline stages over a pipe
  axis (:class:`Pipeline`, installed as ``LM.pipe``).
* :mod:`repro_torch.dist.collectives` — compressed gradient collectives
  (block-wise int8 quantization with error feedback) over a
  ``torch.distributed`` process group.
"""

from .collectives import compressed_psum, dequantize_int8, quantize_int8
from .sharding import (
    PartitionSpec,
    RankGroups,
    ShardingPlan,
    cache_pspecs,
    gather_full,
    local_shard,
    make_plan,
    make_sharder,
    rank_rows,
    vocab_multiple,
)
from .pipeline import Pipeline
from .tensor_parallel import TensorParallel

__all__ = [
    "PartitionSpec",
    "Pipeline",
    "RankGroups",
    "ShardingPlan",
    "TensorParallel",
    "cache_pspecs",
    "compressed_psum",
    "dequantize_int8",
    "gather_full",
    "local_shard",
    "make_plan",
    "make_sharder",
    "quantize_int8",
    "rank_rows",
    "vocab_multiple",
]
