"""Universal Checkpointing core, ported: shard geometry, the UCP pattern
language, the distributed on-disk format, the shard codec and resume
planning.

Numpy, like ``repro.core``, with torch where a shard lives on the card (a
coded moment is encoded and decoded there): a checkpoint written by either
package reads in the other.
"""

from .convert import assemble_atom
from .dist_ckpt import DistCheckpoint, DistManifest, shard_digest_key
from .engine import CheckpointEngine, FragmentIndex
from .layout import DimSpec, IndexEntry, MeshSpec, ShardLayout, SubFragment, compute_layout
from .patterns import (
    STATE_KINDS,
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
    "assemble_atom",
    "DistCheckpoint", "DistManifest", "shard_digest_key",
    "CheckpointEngine", "FragmentIndex",
    "DimSpec", "IndexEntry", "MeshSpec", "ShardLayout", "SubFragment", "compute_layout",
    "STATE_KINDS", "ParamSpec", "ParamTransform", "StateKind", "StateLayoutSpec",
    "TransformClass", "classify_transform", "uniform_param_spec",
    "ResumeMode", "ResumePlan", "TargetSpec", "plan_resume", "stream_transforms",
    "flatten_with_paths", "unflatten_from_paths",
    "content_digest",
]
