"""Universal Checkpointing core, ported: shard geometry, the UCP pattern
language, the distributed on-disk format, the shard codec, UCP atoms and
their conversion (Algorithm 1) and resume planning.

Numpy, like ``repro.core``, with torch where a shard lives on the card (a
coded moment is encoded and decoded there): a checkpoint written by either
package reads in the other.
"""

from .atoms import UCP_FORMAT_VERSION, AtomInfo, UcpCheckpoint, UcpManifest
from .convert import ConvertStats, assemble_atom, convert_to_ucp
from .dist_ckpt import DistCheckpoint, DistManifest, shard_digest_key
from .engine import CheckpointEngine, FragmentIndex, HandleCache, default_engine
from .ops import (
    LoadPlan,
    ParamLoadPlan,
    extract,
    gen_ucp_metadata,
    load_param_shard,
    strip_padding,
    union,
)
from .layout import DimSpec, IndexEntry, MeshSpec, ShardLayout, SubFragment, compute_layout
from .patterns import (
    STATE_KINDS,
    Pattern,
    derive_pattern,
    ParamSpec,
    ParamTransform,
    StateKind,
    StateLayoutSpec,
    TransformClass,
    classify_transform,
    uniform_param_spec,
)
from .plan import ResumeMode, ResumePlan, TargetSpec, plan_resume, stream_transforms
from .pytree import flatten_with_paths, unflatten_from_paths
from .tensor_io import content_digest

__all__ = [
    "UCP_FORMAT_VERSION", "AtomInfo", "UcpCheckpoint", "UcpManifest",
    "ConvertStats", "assemble_atom", "convert_to_ucp",
    "LoadPlan", "ParamLoadPlan", "extract", "gen_ucp_metadata", "load_param_shard",
    "strip_padding", "union",
    "DistCheckpoint", "DistManifest", "shard_digest_key",
    "CheckpointEngine", "FragmentIndex", "HandleCache", "default_engine",
    "DimSpec", "IndexEntry", "MeshSpec", "ShardLayout", "SubFragment", "compute_layout",
    "STATE_KINDS", "Pattern", "derive_pattern", "ParamSpec", "ParamTransform", "StateKind", "StateLayoutSpec",
    "TransformClass", "classify_transform", "uniform_param_spec",
    "ResumeMode", "ResumePlan", "TargetSpec", "plan_resume", "stream_transforms",
    "flatten_with_paths", "unflatten_from_paths",
    "content_digest",
]
