"""The dense decoder (port of the dense path of ``repro.models.lm``).

Parameters are the reference's: the same :class:`ParamDef` tables, so the
same names and layer-stacked shapes (``layers.blk.wqkv`` is
``[L, d, (hq+2·hkv)·hd]``, ``embed`` is ``[vocab_padded, d]``), which is what
lets one checkpoint serve both packages.  The reference ``lax.scan``s over
the stacked ``[L, ...]`` params; the port loops over ``l`` and indexes them.

Attention on a CUDA tensor goes through the hand-written flash-attention
kernel for every prefill, whatever the sequence length; on a CPU tensor it
is :func:`~repro_torch.models.attention.full_attention`.

Only the dense family is ported.  MoE, MLA, SSM, cross-attention and
encoder configs raise ``NotImplementedError`` (ROADMAP queue 1, item 6:
other model families).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention

from .attention import full_attention
from .common import ParamDef, ParamRegistry, apply_rope, rms_norm, rotary_embedding, swiglu

__all__ = ["LayerDef", "StageDef", "LM", "build_lm", "plan_stages", "build_param_defs"]


@dataclasses.dataclass(frozen=True)
class LayerDef:
    name: str               # body-position name (param subtree key)
    kind: str               # "attn"
    window: int = 0         # 0=full; -1=per-layer metadata in StageDef.windows
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class StageDef:
    name: str
    count: int
    body: tuple[LayerDef, ...]
    windows: tuple[int, ...] = ()  # len == count when any body window == -1

    def window(self, ld: LayerDef, layer: int) -> int:
        return self.windows[layer] if ld.window == -1 else ld.window


def _require_dense(cfg: ModelConfig) -> None:
    other = [
        f for f in ("moe", "mla", "ssm", "cross_attn", "encoder") if getattr(cfg, f)
    ]
    if cfg.family != "dense" or other:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} {other or ''} is not ported yet; "
            "only the dense decoder is (ROADMAP queue 1, item 6: other model families)"
        )


def plan_stages(cfg: ModelConfig) -> list[StageDef]:
    """The dense schedule: one homogeneous stack; per-layer sliding windows
    ride along as metadata when they vary (Gemma-3's local:global)."""
    _require_dense(cfg)
    windows = tuple(cfg.window_for_layer(i) for i in range(cfg.num_layers))
    uniform = len(set(windows)) == 1
    return [
        StageDef(
            "layers",
            cfg.num_layers,
            (LayerDef("blk", "attn", window=windows[0] if uniform else -1),),
            windows=() if uniform else windows,
        )
    ]


# ---------------------------------------------------------------------------
# Parameter tables (the reference's names, axes, parts and init)
# ---------------------------------------------------------------------------


def _stacked_def(prefix: str, stack: tuple[int, ...]):
    defs: list[ParamDef] = []

    def P(name, shape, axes, **kw):
        defs.append(
            ParamDef(
                f"{prefix}.{name}",
                stack + tuple(shape),
                ("layers",) * len(stack) + tuple(axes),
                stacked=len(stack) > 0,
                **kw,
            )
        )

    return defs, P


def _attn_defs(cfg: ModelConfig, prefix: str, stack: tuple[int, ...]) -> list[ParamDef]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    defs, P = _stacked_def(prefix, stack)
    P("attn_norm", (d,), ("embed",), init="ones")
    P(
        "wqkv",
        (d, (hq + 2 * hkv) * hd),
        ("embed", "qkv_fused"),
        parts=(("q", hq * hd), ("k", hkv * hd), ("v", hkv * hd)),
        parts_dim=len(stack) + 1,
        kind="fused_qkv",
        fan_in_dim=len(stack),
    )
    P("wo", (hq * hd, d), ("heads", "embed"), fan_in_dim=len(stack))
    return defs


def _mlp_defs(cfg: ModelConfig, prefix: str, stack: tuple[int, ...]) -> list[ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    defs, P = _stacked_def(prefix, stack)
    P("mlp_norm", (d,), ("embed",), init="ones")
    if cfg.name.startswith("gpt3"):
        P("w1", (d, ff), ("embed", "mlp"), fan_in_dim=len(stack))
        P("w2", (ff, d), ("mlp", "embed"), fan_in_dim=len(stack))
    else:
        P("w_gate", (d, ff), ("embed", "mlp"), fan_in_dim=len(stack))
        P("w_up", (d, ff), ("embed", "mlp"), fan_in_dim=len(stack))
        P("w_down", (ff, d), ("mlp", "embed"), fan_in_dim=len(stack))
    return defs


def build_param_defs(cfg: ModelConfig, vocab_padded: int) -> ParamRegistry:
    defs: list[ParamDef] = [
        ParamDef("embed", (vocab_padded, cfg.d_model), ("vocab", "embed"), fan_in_dim=1),
        ParamDef("final_norm", (cfg.d_model,), ("embed",), init="ones"),
    ]
    if not cfg.tie_embeddings:
        defs.append(
            ParamDef("unembed", (cfg.d_model, vocab_padded), ("embed", "vocab"),
                     fan_in_dim=0)
        )
    for stage in plan_stages(cfg):
        stack = (stage.count,)
        for ld in stage.body:
            prefix = f"{stage.name}.{ld.name}"
            defs += _attn_defs(cfg, prefix, stack)
            defs += _mlp_defs(cfg, prefix, stack)
    return ParamRegistry(defs)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LM:
    """Functional model: nested params in, tensors out."""

    cfg: ModelConfig
    vocab_padded: int
    registry: ParamRegistry
    stages: list[StageDef]
    compute_dtype: torch.dtype = torch.bfloat16

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Fresh fp32 weights from ``generator`` (on its device by default)."""
        return self.registry.init(generator, device=device)

    def _attention(self, q, k, v, *, causal: bool, window: int):
        if q.is_cuda:
            return flash_attention(q, k, v, causal=causal, window=window)
        return full_attention(q, k, v, causal=causal, window=window)

    def _self_attn(self, p, x, *, window: int, positions, causal: bool = True):
        """Pre-norm self-attention block on one layer's params; returns the
        residual sum and this layer's roped (k, v) for the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        hd = cfg.resolved_head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        qkv = h @ p["wqkv"].to(h.dtype)
        q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
        q = q.reshape(b, s, hq, hd)
        k = k.reshape(b, s, hkv, hd)
        v = v.reshape(b, s, hkv, hd)
        sin, cos = rotary_embedding(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        o = self._attention(q, k, v, causal=causal, window=window)
        out = o.reshape(b, s, hq * hd) @ p["wo"].to(h.dtype)
        return x + out, (k, v)

    def _mlp(self, p, x):
        h = rms_norm(x, p["mlp_norm"], self.cfg.norm_eps)
        if "w1" in p:  # GPT-3: GELU MLP (jax.nn.gelu's default tanh form)
            out = F.gelu(h @ p["w1"].to(h.dtype), approximate="tanh") @ p["w2"].to(h.dtype)
        else:
            out = swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        return x + out

    def unembed(self, params) -> torch.Tensor:
        """The [d, vocab_padded] output projection in the compute dtype."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return w.to(self.compute_dtype)


def build_lm(
    cfg: ModelConfig,
    *,
    vocab_multiple: int = 1,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> LM:
    """Construct the model for a (dense) config.  ``vocab_multiple`` pads the
    vocab dim of the embedding to the mesh-axis multiple that shards it;
    the padding is runtime-only, UCP atoms store the logical vocab."""
    vp = -(-cfg.vocab_size // vocab_multiple) * vocab_multiple
    return LM(
        cfg=cfg,
        vocab_padded=vp,
        registry=build_param_defs(cfg, vp),
        stages=plan_stages(cfg),
        compute_dtype=compute_dtype,
    )
