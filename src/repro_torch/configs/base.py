"""Configuration system: model, parallelism, training, shapes.

Every assigned architecture is a :class:`ModelConfig` instance in its own
module under ``repro_torch.configs``; ``get_config(name)`` resolves them and
``reduced(cfg)`` produces the CPU-smoke-test variant of the same family
(same structural features, tiny dims).

Design notes
------------
* One config type covers all ten families: feature blocks (``moe``, ``ssm``,
  ``mla``, ``cross_attn``, ``encoder``) are optional sub-configs; the layer
  schedule is expressed as a repeating *pattern* of block kinds plus
  per-layer metadata (sliding-window sizes, MoE on/off) so models can
  ``lax.scan`` over homogeneous stacks.
* Parallelism is configured separately (:class:`ParallelismConfig`) — the
  same model config can be trained under many parallelism configs, which is
  the whole point of Universal Checkpointing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Literal

__all__ = [
    "MoEConfig",
    "SSMConfig",
    "MLAConfig",
    "CrossAttnConfig",
    "EncoderConfig",
    "ModelConfig",
    "ParallelismConfig",
    "TrainConfig",
    "ShapeSpec",
    "SHAPES",
    "get_config",
    "reduced",
    "list_configs",
]


# ---------------------------------------------------------------------------
# Feature sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    every_k_layers: int = 1      # MoE replaces the MLP every k-th layer
    first_dense_layers: int = 0  # leading layers keep a dense MLP
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD, state-space duality) block parameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length (matmul-rich formulation)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class CrossAttnConfig:
    """Interleaved cross-attention to a (stubbed) modality frontend."""

    every_k_layers: int  # a cross-attn layer every k layers
    source_len: int      # number of frontend embeddings (patches/frames)
    source_dim: int      # frontend embedding width (== d_model after projector)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (Whisper backbone)."""

    num_layers: int
    source_len: int  # precomputed frame embeddings (conv frontend is a stub)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    # Attention schedule: sliding window for "local" layers; a repeating
    # pattern like ("local",)*5 + ("global",) — empty means all-global.
    sliding_window: int = 0
    layer_pattern: tuple[str, ...] = ()
    # Hybrid schedule (Jamba): kinds per position in the repeating period,
    # e.g. ("mamba",)*4 + ("attn",) + ("mamba",)*3.
    hybrid_pattern: tuple[str, ...] = ()
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    mla: MLAConfig | None = None
    cross_attn: CrossAttnConfig | None = None
    encoder: EncoderConfig | None = None
    # source tag from the assignment table
    source: str = ""

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attends_globally(self) -> bool:
        """True if any layer performs unwindowed full attention."""
        if self.family == "ssm":
            return False
        if self.layer_pattern:
            return "global" in self.layer_pattern
        return self.sliding_window == 0

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic enough for the 500k-token decode shape.

        SSM/hybrid state is O(1); sliding-window archs keep bounded local KV
        (their occasional global layers hold a linear-in-seq KV cache, which
        decode touches linearly per token).  Pure full-attention archs are
        skipped per the assignment.
        """
        if self.family in ("ssm", "hybrid"):
            return True
        if self.layer_pattern and "local" in self.layer_pattern:
            return True
        return self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (enc-dec included)

    def window_for_layer(self, i: int) -> int:
        """0 = full attention; >0 = sliding window size."""
        if not self.layer_pattern:
            return self.sliding_window
        kind = self.layer_pattern[i % len(self.layer_pattern)]
        return self.sliding_window if kind == "local" else 0

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind for hybrid archs ('attn' | 'mamba')."""
        if not self.hybrid_pattern:
            return ["attn"] * self.num_layers
        period = len(self.hybrid_pattern)
        if self.num_layers % period:
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"hybrid pattern period {period}"
            )
        return [self.hybrid_pattern[i % period] for i in range(self.num_layers)]

    def moe_layer_mask(self) -> list[bool]:
        if self.moe is None:
            return [False] * self.num_layers
        m = []
        for i in range(self.num_layers):
            on = (
                i >= self.moe.first_dense_layers
                and (i - self.moe.first_dense_layers) % self.moe.every_k_layers == 0
            )
            m.append(on)
        return m

    def fingerprint(self) -> dict:
        d = dataclasses.asdict(self)
        d["_hash"] = hashlib.sha256(
            json.dumps(d, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]
        return d


# ---------------------------------------------------------------------------
# Parallelism / training configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    """How one run lays state and compute over the mesh.

    The mesh axes are whatever the launcher built (e.g. ``("data","model")``
    or ``("pod","data","model")`` or ``("pipe","data","model")``); this
    config says which *roles* map to which axes.  ZeRO staging follows the
    paper's vocabulary:

    * zero1 — optimizer moments sharded over the data axes, weights replicated
    * zero3/fsdp — weights *and* moments sharded over the data axes
    """

    data_axes: tuple[str, ...] = ("data",)   # batch sharding (+ pod usually)
    model_axis: str = "model"                 # TP / EP / SP axis
    pipe_axis: str | None = None              # stacked-layer (stage) sharding
    fsdp: bool = True                         # shard weights over data axes
    zero: int = 3                             # 1 or 3 (2 == 1 for our purposes)
    tensor_parallel: bool = True              # shard heads/ffn over model_axis
    expert_parallel: bool = True              # shard experts over model_axis
    sequence_parallel: bool = True            # shard activations' seq dim
    local_updates: bool = False               # DiLoCo-style params_to_average
    param_dtype: str = "float32"              # master dtype
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"             # bf16 for the 236B/398B archs
    remat: str = "full"                       # "none" | "full" | "dots"
    grad_accum: int = 1
    # Perf levers (see EXPERIMENTS.md §Perf): cast the fp32 master to the
    # compute dtype ONCE per microstep so FSDP weight all-gathers move bf16
    # instead of fp32 (collective bytes ×0.5).
    cast_params_once: bool = False
    # Decode caches: when KV heads don't divide the model axis, shard the
    # cache-length dim instead (flash-decoding style) rather than
    # replicating the whole cache per chip.
    shard_cache_seq: bool = False

    def fingerprint(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 10
    total_steps: int = 200
    weight_decay: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    grad_clip: float = 1.0
    seed: int = 0


# ---------------------------------------------------------------------------
# Input shapes (assignment table)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, str] = {
    "llama-3.2-vision-11b": "llama_vision_11b",
    "mamba2-130m": "mamba2_130m",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mixtral-8x22b": "mixtral_8x22b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "whisper-tiny": "whisper_tiny",
    "gemma3-27b": "gemma3_27b",
    "gemma3-12b": "gemma3_12b",
    "smollm-360m": "smollm_360m",
    "minitron-8b": "minitron_8b",
    "gpt3-350m": "gpt3_350m",  # the paper's own evaluation model
}


def list_configs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    import importlib

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_configs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests.

    Preserves every structural feature (GQA ratios, MoE, MLA, hybrid
    pattern, cross-attn cadence, local:global schedule) while shrinking
    widths/depths so a forward+backward step runs in seconds on CPU.
    """
    period = max(
        len(cfg.layer_pattern) or 1,
        len(cfg.hybrid_pattern) or 1,
        (cfg.cross_attn.every_k_layers if cfg.cross_attn else 1),
        (cfg.moe.every_k_layers if cfg.moe else 1),
    )
    layers = 2 * period
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = max(kv * max(1, cfg.num_heads // max(1, cfg.num_kv_heads)), kv)
    moe = (
        dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            num_shared=min(cfg.moe.num_shared, 1),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
        if cfg.moe
        else None
    )
    ssm = (
        dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
        if cfg.ssm
        else None
    )
    cross = (
        dataclasses.replace(cfg.cross_attn, source_len=8, source_dim=64)
        if cfg.cross_attn
        else None
    )
    enc = (
        dataclasses.replace(cfg.encoder, num_layers=2, source_len=8)
        if cfg.encoder
        else None
    )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        moe=moe,
        ssm=ssm,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16) if cfg.mla else None,
        cross_attn=cross,
        encoder=enc,
    )
