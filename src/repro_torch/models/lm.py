"""The language model (port of ``repro.models.lm``: every family of its configs).

Parameters are the reference's: the same :class:`ParamDef` tables, so the
same names and layer-stacked shapes (``layers.blk.wqkv`` is
``[L, d, (hq+2·hkv)·hd]``, Mamba's fused ``layers.blk.in_proj`` is
``[L, d, 2·di + 2·G·N + H]`` with parts z/x/B/C/dt, ``embed`` is
``[vocab_padded, d]``), which is what lets one checkpoint serve both
packages.  The reference ``lax.scan``s over the stacked ``[L, ...]`` params;
the port loops over ``l`` and indexes them.

Attention on a CUDA tensor with no gradient recorded (serving's prefill)
goes through the hand-written flash-attention kernel, whatever the sequence
length.  Otherwise — training, or any CPU tensor — it is what the reference
executes: :func:`~repro_torch.models.attention.full_attention` up to 2048
tokens and :func:`~repro_torch.models.attention.chunked_attention` above,
with the reference's block choice (``repro/models/lm.py:396-410``).  The
Mamba-2 scan likewise goes through the hand-written SSD kernel on CUDA
tensors with no gradient recorded, and through the reference's :func:`~repro_torch.models.ssm.ssd_chunked` otherwise.  Neither
kernel has a backward; the JAX package trains through the same plain
functions.

``remat="full"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, the reference's per-layer ``jax.checkpoint``);
``"dots"`` keeps the outputs of the matmuls without batch dims
(``aten.mm``/``aten.addmm``: every projection) and recomputes the rest, as
the reference's ``dots_with_no_batch_dims_saveable`` policy (a selective
checkpoint); ``"none"`` keeps activations.  The encoder's layers are
recomputed whole under both ``"full"`` and ``"dots"``, as the reference's
``encode``, whose ``jax.checkpoint`` takes no policy.

Every family is ported: the dense, the MoE (:mod:`.moe`: mixtral;
DeepSeek-style shared experts and leading dense layers, with DeepSeek-V2's
Multi-head Latent Attention, :meth:`LM._mla_attn`), the SSM (Mamba-2), the
hybrid (jamba: a ``periods`` stage whose body is the config's
``hybrid_pattern`` of Mamba-2 and attention layers, each with its dense or
MoE MLP), the ``vlm`` (llama-vision: a ``periods`` stage of k-1 self
layers and one gated cross-attention layer reading ``source_embeds``) and
the ``encdec`` (whisper: :meth:`LM.encode`, a bidirectional encoder over
``source_embeds``, then decoder layers of self-attention, ungated
cross-attention to the encoder's output and a GELU MLP) families.
Cross-attention's K and V come from the source with no rope and attend
without a mask (:meth:`LM._cross_attn`); on CUDA with no gradient that is
a flash launch at Sq != Skv.
A MoE layer's load-balancing loss is summed over the layers and returned
by :meth:`LM.forward`; :meth:`LM.loss_fn` adds ``router_aux_weight`` of it
to the loss it differentiates and reports the bare cross-entropy as
``loss``, as the reference does.

``LM.shard`` is the reference's activation hook (identity by default),
called at the reference's call sites (``repro/models/lm.py:430,438,508,542,
613,635``).  It cannot partition work in eager PyTorch, so a multi-rank run
of any family installs a rank context instead, ``LM.tp``
(:class:`~repro_torch.dist.tensor_parallel.TensorParallel`): at the same
call sites the layer code computes only its part, by the sharder's
decisions for the logical shapes and the plan's split of the weights
(vocab-parallel embedding and logits, column/row-parallel MLP and
attention, MLA and cross-attention by heads, a MoE layer's experts or their
slices, Mamba-2 by SSM heads, each stream's rows under sequence
parallelism: whisper's encoder decides its own).  Each stream's decision is
bound into its layers (``sp``), so a layer recomputed in the backward pass
computes as it did in the forward.  Under it
:meth:`LM.forward` returns the rank's vocab shard of the logits and
:meth:`LM.loss_fn` the vocab-parallel cross-entropy, equal on every model
rank; with tensor parallelism off the same context computes each stream's
rows from replicated weights, the logits and the cross-entropy of the
rank's rows (its mean over the model group).  Under a pipe axis a rank
runs only its stage's chunk of each stack (``LM.pipe``,
:class:`~repro_torch.dist.pipeline.Pipeline`), from the pieces of
:meth:`LM.forward`: :meth:`LM.embed_tokens`, :meth:`LM._stage_forward`,
the encoder's :meth:`LM.encoder_input`, :meth:`LM.encoder_layers` and
:meth:`LM.encoder_output`, :meth:`LM.logits` and :meth:`LM.cross_entropy`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import kernel_path
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan

from .attention import chunked_attention, full_attention
from .common import ParamDef, ParamRegistry, apply_rope, rms_norm, rotary_embedding, swiglu
from .moe import moe_block
from .ssm import causal_conv1d, ssd_chunked

__all__ = ["LayerDef", "StageDef", "LM", "build_lm", "plan_stages", "build_param_defs"]


@dataclasses.dataclass(frozen=True)
class LayerDef:
    name: str               # body-position name (param subtree key)
    kind: str               # "attn" | "mamba" | "cross"
    window: int = 0         # 0=full; -1=per-layer metadata in StageDef.windows
    moe: bool = False       # the MLP is a mixture of experts
    with_mlp: bool = True
    with_cross: bool = False  # whisper-style: self-attention, then cross-attention
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class StageDef:
    name: str
    count: int
    body: tuple[LayerDef, ...]
    windows: tuple[int, ...] = ()  # len == count when any body window == -1

    def window(self, ld: LayerDef, layer: int) -> int:
        return self.windows[layer] if ld.window == -1 else ld.window


def _check_family(cfg: ModelConfig) -> None:
    other = [
        f for f in ("moe", "mla", "ssm", "cross_attn", "encoder") if getattr(cfg, f)
    ]
    if not (
        (cfg.family == "dense" and not other)
        or (cfg.family == "moe" and other in (["moe"], ["moe", "mla"]))
        or (cfg.family == "ssm" and other == ["ssm"])
        or (cfg.family == "hybrid" and other == ["moe", "ssm"])
        or (cfg.family == "vlm" and other == ["cross_attn"])
        or (cfg.family == "encdec" and other == ["encoder"])
    ):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {other or 'no extras'} is not a "
            "combination the JAX package's configs use"
        )


def plan_stages(cfg: ModelConfig) -> list[StageDef]:
    """One homogeneous stack: Mamba-2 blocks with no MLP for the SSM family;
    for the hybrid family one ``periods`` stage repeating the config's
    ``hybrid_pattern`` (body ``p{i}_{kind}``, each layer with its MLP, a MoE
    one where the config's cadence says so); for the vlm family one
    ``periods`` stage of ``self0..self{k-2}`` and a non-causal ``cross``
    layer; for the encdec family ``dec_layers`` of attention layers
    ``with_cross`` (the encoder lies outside every stage); for the dense
    and MoE families attention + MLP, per-layer sliding windows riding
    along as metadata when they vary (Gemma-3's local:global), after a
    dense ``head`` stage for DeepSeek-style leading dense layers."""
    _check_family(cfg)
    if cfg.family == "ssm":
        return [StageDef("layers", cfg.num_layers, (LayerDef("blk", "mamba", with_mlp=False),))]
    if cfg.family == "hybrid":
        moe_mask = cfg.moe_layer_mask()
        body = tuple(LayerDef(f"p{i}_{k}", k, moe=moe_mask[i])
                     for i, k in enumerate(cfg.hybrid_pattern))
        return [StageDef("periods", cfg.num_layers // len(body), body)]
    if cfg.family == "vlm":
        k = cfg.cross_attn.every_k_layers
        assert cfg.num_layers % k == 0
        body = tuple([LayerDef(f"self{i}", "attn") for i in range(k - 1)]
                     + [LayerDef("cross", "cross", causal=False)])
        return [StageDef("periods", cfg.num_layers // k, body)]
    if cfg.family == "encdec":
        return [StageDef("dec_layers", cfg.num_layers, (LayerDef("blk", "attn", with_cross=True),))]
    windows = tuple(cfg.window_for_layer(i) for i in range(cfg.num_layers))
    uniform = len(set(windows)) == 1
    moe_mask = cfg.moe_layer_mask()
    stages: list[StageDef] = []
    start = 0
    if cfg.moe and cfg.moe.first_dense_layers:
        start = cfg.moe.first_dense_layers
        stages.append(StageDef("head", start, (LayerDef("blk", "attn", window=windows[0]),)))
    assert all(moe_mask[start:]) or not any(moe_mask[start:]), (
        "non-uniform MoE cadence requires the hybrid/period planner"
    )
    stages.append(
        StageDef(
            "layers",
            cfg.num_layers - start,
            (LayerDef("blk", "attn", window=windows[start] if uniform else -1,
                      moe=bool(cfg.moe and moe_mask[start])),),
            windows=() if uniform else windows[start:],
        )
    )
    return stages


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
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        P("wq_a", (d, m.q_lora_rank), ("embed", "lora"), fan_in_dim=len(stack))
        P("q_norm", (m.q_lora_rank,), ("lora",), init="ones")
        P("wq_b", (m.q_lora_rank, hq * qk), ("lora", "heads"), fan_in_dim=len(stack))
        P("wkv_a", (d, m.kv_lora_rank + m.qk_rope_head_dim), ("embed", "lora"),
          fan_in_dim=len(stack))
        P("kv_norm", (m.kv_lora_rank,), ("lora",), init="ones")
        P("wkv_b", (m.kv_lora_rank, hq * (m.qk_nope_head_dim + m.v_head_dim)),
          ("lora", "heads"), fan_in_dim=len(stack))
        P("wo", (hq * m.v_head_dim, d), ("heads", "embed"), fan_in_dim=len(stack))
        return defs
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


def _cross_defs(cfg: ModelConfig, prefix: str, stack: tuple[int, ...], *,
                gated: bool) -> list[ParamDef]:
    """Cross-attention: q from the stream, k and v fused in ``cross_wkv``
    (parts k, v) over the source's width; a gated layer scales its output
    by tanh(``cross_gate``), initialised to 0."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    src = cfg.cross_attn.source_dim if cfg.cross_attn else d
    defs, P = _stacked_def(prefix, stack)
    P("cross_norm", (d,), ("embed",), init="ones")
    P("cross_wq", (d, hq * hd), ("embed", "heads"), fan_in_dim=len(stack))
    P(
        "cross_wkv",
        (src, 2 * hkv * hd),
        ("embed", "qkv_fused"),
        parts=(("k", hkv * hd), ("v", hkv * hd)),
        parts_dim=len(stack) + 1,
        kind="fused_qkv",
        fan_in_dim=len(stack),
    )
    P("cross_wo", (hq * hd, d), ("heads", "embed"), fan_in_dim=len(stack))
    if gated:
        P("cross_gate", (1,), ("scalar",), init="zeros")
    return defs


def _mlp_defs(
    cfg: ModelConfig, prefix: str, stack: tuple[int, ...], *, moe: bool
) -> list[ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    defs, P = _stacked_def(prefix, stack)
    P("mlp_norm", (d,), ("embed",), init="ones")
    if moe:
        e, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
        P("router", (d, e), ("embed", "expert_router"), fan_in_dim=len(stack))
        P("we_gate", (e, d, f), ("expert", "embed", "expert_mlp"),
          kind="moe_expert", fan_in_dim=len(stack) + 1)
        P("we_up", (e, d, f), ("expert", "embed", "expert_mlp"),
          kind="moe_expert", fan_in_dim=len(stack) + 1)
        P("we_down", (e, f, d), ("expert", "expert_mlp", "embed"),
          kind="moe_expert", fan_in_dim=len(stack) + 1)
        if cfg.moe.num_shared:
            sf = cfg.moe.num_shared * f
            P("ws_gate", (d, sf), ("embed", "mlp"), fan_in_dim=len(stack))
            P("ws_up", (d, sf), ("embed", "mlp"), fan_in_dim=len(stack))
            P("ws_down", (sf, d), ("mlp", "embed"), fan_in_dim=len(stack))
    elif cfg.family == "encdec" or cfg.name.startswith("gpt3"):
        P("w1", (d, ff), ("embed", "mlp"), fan_in_dim=len(stack))
        P("w2", (ff, d), ("mlp", "embed"), fan_in_dim=len(stack))
    else:
        P("w_gate", (d, ff), ("embed", "mlp"), fan_in_dim=len(stack))
        P("w_up", (d, ff), ("embed", "mlp"), fan_in_dim=len(stack))
        P("w_down", (ff, d), ("mlp", "embed"), fan_in_dim=len(stack))
    return defs


def _mamba_defs(cfg: ModelConfig, prefix: str, stack: tuple[int, ...]) -> list[ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    g, n = s.n_groups, s.d_state
    defs, P = _stacked_def(prefix, stack)
    P("norm", (d,), ("embed",), init="ones")
    P(
        "in_proj",
        (d, 2 * di + 2 * g * n + nh),
        ("embed", "ssm_fused"),
        parts=(("z", di), ("x", di), ("B", g * n), ("C", g * n), ("dt", nh)),
        parts_dim=len(stack) + 1,
        kind="fused_qkv",
        fan_in_dim=len(stack),
    )
    P("conv_w", (di + 2 * g * n, s.d_conv), ("ssm_conv", "conv"))
    P("conv_b", (di + 2 * g * n,), ("ssm_conv",), init="zeros")
    # the reference reads a_log and dt_bias in float32 (repro/models/lm.py:531-532)
    P("a_log", (nh,), ("ssm_heads",), init="ssm_alog", keep_fp32=True)
    P("d_skip", (nh,), ("ssm_heads",), init="ones")
    P("dt_bias", (nh,), ("ssm_heads",), init="ssm_dt", keep_fp32=True)
    P("ssm_norm", (di,), ("ssm_inner",), init="ones")
    P("out_proj", (di, d), ("ssm_inner", "embed"), fan_in_dim=len(stack))
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
    if cfg.encoder is not None:  # stacked over the encoder's layers, in no stage
        stack = (cfg.encoder.num_layers,)
        defs += _attn_defs(cfg, "encoder.blk", stack)
        defs += _mlp_defs(cfg, "encoder.blk", stack, moe=False)
        defs.append(ParamDef("encoder.norm", (cfg.d_model,), ("embed",), init="ones"))
    for stage in plan_stages(cfg):
        stack = (stage.count,)
        for ld in stage.body:
            prefix = f"{stage.name}.{ld.name}"
            if ld.kind == "mamba":
                defs += _mamba_defs(cfg, prefix, stack)
            elif ld.kind == "cross":
                defs += _cross_defs(cfg, prefix, stack, gated=True)
            else:
                defs += _attn_defs(cfg, prefix, stack)
                if ld.with_cross:
                    defs += _cross_defs(cfg, prefix, stack, gated=False)
            if ld.with_mlp:
                defs += _mlp_defs(cfg, prefix, stack, moe=ld.moe)
    return ParamRegistry(defs)


# remat="dots": the matmuls with no batch dims (every projection; attention's
# batched products are recomputed), the reference's dots_with_no_batch_dims_saveable
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, *args, remat: str):
    """``fn(*args)``, its activations recomputed in the backward pass as
    ``remat`` says."""
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    return fn(*args)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _no_shard(x, axes):
    return x


def _gelu_mlp(p, h):
    """GPT-3's and whisper's MLP (jax.nn.gelu's default tanh form)."""
    return F.gelu(h @ p["w1"].to(h.dtype), approximate="tanh") @ p["w2"].to(h.dtype)


@dataclasses.dataclass
class LM:
    """Functional model: nested params in, tensors out."""

    cfg: ModelConfig
    vocab_padded: int
    registry: ParamRegistry
    stages: list[StageDef]
    compute_dtype: torch.dtype = torch.bfloat16
    remat: str = "full"  # "full" | "dots" | "none"
    # token groups of a MoE layer over the batch (None: one a sequence)
    moe_groups: int | None = None
    # the reference's activation-sharding hook (identity unless installed)
    shard: Callable[[torch.Tensor, tuple[str, ...]], torch.Tensor] = _no_shard
    # the rank context of partitioned compute (dist.tensor_parallel), or None
    tp: Any = None
    # the rank's pipeline stage (dist.pipeline), or None
    pipe: Any = None

    def init(self, generator: torch.Generator, *, device=None) -> dict:
        """Fresh fp32 weights from ``generator`` (on its device by default)."""
        return self.registry.init(generator, device=device)

    def _attention(self, q, k, v, *, causal: bool, window: int, q_offset: int = 0):
        """Row i of q sits at position ``q_offset + i`` in the causal and
        window masks (the reference's ``q_offset``)."""
        if kernel_path(q, k, v):
            return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
        sq, skv = q.shape[1], k.shape[1]
        if max(sq, skv) <= 2048:
            return full_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
        kv_block = max(b for b in (1024, 512, 500, 400, 256, 128, 100, 64, 32, 16, 8, 4, 2, 1)
                       if skv % b == 0)
        q_block = max(b for b in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1) if sq % b == 0)
        return chunked_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                 q_block=q_block, kv_block=kv_block)

    def _self_attn(self, p, x, *, window: int, positions, causal: bool = True, sp: bool = False):
        """Pre-norm self-attention block on one layer's params; returns the
        residual sum and what the cache keeps of this layer: its roped
        (k, v), or MLA's (c_kv, k_rope).  ``sp``: under a rank context, the
        stream is seq-sharded."""
        cfg, tp = self.cfg, self.tp
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        if cfg.mla is not None:
            out, kv = self._mla_attn(p, h, positions=positions, window=window, sp=sp)
            if tp is not None and tp.heads:
                return x + tp.leave(out, sp), kv
            return x + self.shard(out, ("batch", "seq", "embed")), kv
        if tp is not None:
            return self._tp_self_attn(p, x, h, window=window, positions=positions, causal=causal,
                                      sp=sp)
        out, kv = self._gqa(p, h, cfg.num_heads, cfg.num_kv_heads, window=window,
                            positions=positions, causal=causal)
        return x + self.shard(out, ("batch", "seq", "embed")), kv

    def _gqa(self, p, h, hq: int, hkv: int, *, window: int, positions, causal: bool):
        """Projections, rope and attention of ``hq``:``hkv`` heads from the
        normed input; returns the output projection and (k, v)."""
        b, s, _ = h.shape
        hd = self.cfg.resolved_head_dim
        qkv = h @ p["wqkv"].to(h.dtype)
        q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
        q = q.reshape(b, s, hq, hd)
        k = k.reshape(b, s, hkv, hd)
        v = v.reshape(b, s, hkv, hd)
        sin, cos = rotary_embedding(positions, hd, self.cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        q = self.shard(q, ("batch", "seq", "heads", "head_dim"))
        o = self._attention(q, k, v, causal=causal, window=window)
        return o.reshape(b, s, hq * hd) @ p["wo"].to(h.dtype), (k, v)

    def _tp_self_attn(self, p, x, h, *, window: int, positions, causal: bool, sp: bool):
        """Partitioned self-attention (:mod:`repro_torch.dist.tensor_parallel`).
        The stream is seq-sharded where its forward decided so (``sp``).
        Heads that divide: the rank's own heads from its
        ``wqkv`` shard, the row-parallel ``wo``.  Else, from the gathered
        weights: under sequence parallelism K and V for every row and q for
        the rank's rows, attending to keys up to its last row at its
        ``q_offset``; without it the whole block, replicated."""
        tp, cfg = self.tp, self.cfg
        hq, hkv = tp.local_heads(cfg)
        if tp.heads:
            out, kv = self._gqa(p, tp.enter(h, sp), hq, hkv, window=window,
                                positions=positions, causal=causal)
            return x + tp.leave(out, sp), kv
        if not sp:
            out, kv = self._gqa(p, h, hq, hkv, window=window, positions=positions,
                                causal=causal)
            return x + out, kv
        b, s, _ = h.shape
        hd = cfg.resolved_head_dim
        wq, wk, wv = torch.split(p["wqkv"].to(h.dtype), [hq * hd, hkv * hd, hkv * hd], dim=-1)
        hf = tp.gather_seq(h)
        n = hf.shape[1]
        lo, hi = tp.rows(n)
        k = (hf @ wk).reshape(b, n, hkv, hd)
        v = (hf @ wv).reshape(b, n, hkv, hd)
        q = (h @ wq).reshape(b, s, hq, hd)
        sin, cos = rotary_embedding(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin[lo:hi], cos[lo:hi])
        k = apply_rope(k, sin, cos)
        end = hi if causal else n
        o = self._attention(q, k[:, :end], v[:, :end], causal=causal, window=window,
                            q_offset=lo)
        return x + o.reshape(b, s, hq * hd) @ p["wo"].to(h.dtype), (k, v)

    def _mla_attn(self, p, h, *, positions, window: int, sp: bool = False):
        """DeepSeek-V2's Multi-head Latent Attention on the normed input
        (``repro/models/lm.py:440-469``): q through its low-rank pair
        (q_a, rms_norm, q_b); one latent ``c_kv`` (rms_norm) and one shared
        roped key head ``k_rope`` from kv_a; kv_b lifts ``c_kv`` to each
        head's [k_nope | v].  Attention runs with q and k of nope + rope
        (192) and v of ``v_head_dim`` (128), always causal, the scale
        1/sqrt(nope + rope); v is the strided view of kv_b's output.
        Returns the block's output and (c_kv, k_rope) for the latent cache.

        Under a rank context where the heads divide, the rank's heads (its
        ``wq_b``/``wkv_b`` columns, ``wo`` rows: a partial output) from the
        entered input, the latent whole; where they do not and the stream is
        seq-sharded (``sp``), the latent and K/V for every row and q for the
        rank's rows at its ``q_offset`` from the gathered weights (the
        output is its rows); else the whole block."""
        cfg, m, tp = self.cfg, self.cfg.mla, self.tp
        hq = cfg.num_heads
        nope, rope, vhd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
        hk = hq_in = h  # the rows K/V are computed for, and those q is
        lo = 0
        if tp is not None and tp.heads:
            hk = hq_in = tp.enter(h, sp)
            hq //= tp.size
        elif tp is not None and sp:
            hk = tp.gather_seq(h)
            lo = tp.rows(hk.shape[1])[0]
        b, s, _ = hq_in.shape
        n = hk.shape[1]
        qa = rms_norm(hq_in @ p["wq_a"].to(h.dtype), p["q_norm"], cfg.norm_eps)
        q = (qa @ p["wq_b"].to(h.dtype)).reshape(b, s, hq, nope + rope)
        kva = hk @ p["wkv_a"].to(h.dtype)
        c_kv, k_rope = kva[..., : m.kv_lora_rank], kva[..., m.kv_lora_rank:]
        c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
        kvb = (c_kv @ p["wkv_b"].to(h.dtype)).reshape(b, n, hq, nope + vhd)
        k_nope, v = kvb[..., :nope], kvb[..., nope:]
        sin, cos = rotary_embedding(positions, rope, cfg.rope_theta)
        q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], sin[lo:lo + s], cos[lo:lo + s])],
                      dim=-1)
        k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)  # 1 shared head
        k = torch.cat([k_nope, k_rope.expand(b, n, hq, rope)], dim=-1)
        if lo + s < n:  # keys up to the rank's last row
            k, v = k[:, :lo + s], v[:, :lo + s]
        o = self._attention(q, k, v, causal=True, window=window, q_offset=lo)
        out = o.reshape(b, s, hq * vhd) @ p["wo"].to(h.dtype)
        return out, (c_kv, k_rope[:, :, 0, :])

    def _cross_attn(self, p, x, source, *, gated: bool, sp: bool = False):
        """Pre-norm cross-attention block (``repro/models/lm.py:471-491``):
        q from the stream, k and v from ``source @ cross_wkv`` split in two,
        no rope, attention with no mask; the output times
        tanh(``cross_gate``) in a gated (llama-vision) layer.  Returns the
        residual sum and (k, v) for the cache.  Under a rank context where
        the heads divide: the rank's q heads from the entered input and its
        KV heads from the whole source, ``cross_wo``'s rows, the reduction
        (``sp``: a reduce-scatter), then the gate; else the block from the
        gathered weights on the stream's rows."""
        cfg, tp = self.cfg, self.tp
        hd = cfg.resolved_head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        h = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        heads = tp is not None and tp.heads
        if heads:
            h = tp.enter(h, sp)
            hq, hkv = tp.local_heads(cfg)
        b, s, _ = h.shape
        q = (h @ p["cross_wq"].to(h.dtype)).reshape(b, s, hq, hd)
        kv = source.to(h.dtype) @ p["cross_wkv"].to(h.dtype)
        k, v = torch.split(kv, [hkv * hd, hkv * hd], dim=-1)
        k = k.reshape(b, -1, hkv, hd)
        v = v.reshape(b, -1, hkv, hd)
        o = self._attention(q, k, v, causal=False, window=0)
        out = o.reshape(b, s, hq * hd) @ p["cross_wo"].to(h.dtype)
        if heads:  # the gate after the reduction: its gradient is then whole
            out = tp.leave(out, sp)
        if gated:
            out = out * torch.tanh(p["cross_gate"].to(out.dtype))
        return x + out, (k, v)

    def _mlp(self, p, x, *, moe: bool = False, sp: bool = False):
        """Pre-norm MLP (dense, GELU or MoE); returns the residual sum and
        the layer's aux loss (a float32 zero unless it is a MoE layer).
        Under a rank context with tensor parallelism the dense MLP (and a
        MoE layer's shared experts) is column-parallel on the rank's ``mlp``
        columns and row-parallel after; a MoE layer whose experts split
        (:attr:`TensorParallel.experts_split`) routes every token of the
        data replica and runs the rank's experts (EP) or its slice of each
        expert's width (expert-TP), its output partial, its aux loss whole
        with the gradient shared over the model ranks; ``sp``: the stream is
        seq-sharded.  With tensor parallelism off the dense MLP and the
        shared experts run on the rank's rows, and replicated experts on the
        gathered rows (a token group is a whole sequence), the rank keeping
        its own."""
        cfg, tp = self.cfg, self.tp
        h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if tp is not None and not tp.tensor:
            return self._rows_mlp(p, x, h, moe=moe, sp=sp)
        if tp is not None:
            h = tp.enter(h, sp)
        if moe:
            # one token group a sequence unless moe_groups says otherwise, as the reference
            out, aux = moe_block(h, p["router"], p["we_gate"], p["we_up"], p["we_down"], cfg.moe,
                                 groups=self.moe_groups,
                                 owned=None if tp is None else tp.experts(cfg.moe.num_experts))
            if cfg.moe.num_shared:
                out = out + swiglu(h, p["ws_gate"], p["ws_up"], p["ws_down"])
            if tp is not None:
                aux = tp.shared(aux)
        elif "w1" in p:  # GPT-3: GELU MLP (jax.nn.gelu's default tanh form)
            out = _gelu_mlp(p, h)
        else:
            out = swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        if tp is not None:
            return x + tp.leave(out, sp), aux
        return x + self.shard(out, ("batch", "seq", "embed")), aux

    def _rows_mlp(self, p, x, h, *, moe: bool, sp: bool):
        """The MLP under a rank context with tensor parallelism off (every
        weight replicated over the model axis but a MoE layer's experts
        under EP): per-token products on the rank's rows ``h``; experts
        split over the model axis from the entered rows, their partial
        output reduced (scattered to rows under ``sp``), the shared experts
        on the rank's rows; replicated experts route the gathered rows
        (under ``sp``) and the rank keeps its own.  The aux loss is whole on
        every rank: its gradient is shared where the router's is summed
        over the model group."""
        cfg, tp = self.cfg, self.tp
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if not moe:
            out = _gelu_mlp(p, h) if "w1" in p else swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
            return x + out, aux
        if tp.experts_split:
            out, aux = moe_block(tp.enter(h, sp), p["router"], p["we_gate"], p["we_up"],
                                 p["we_down"], cfg.moe, groups=self.moe_groups,
                                 owned=tp.experts(cfg.moe.num_experts))
            out = tp.leave(out, sp)
        else:
            out, aux = moe_block(tp.gather_seq(h) if sp else h, p["router"], p["we_gate"],
                                 p["we_up"], p["we_down"], cfg.moe, groups=self.moe_groups)
            if sp:
                lo, hi = tp.rows(out.shape[1])
                out = out[:, lo:hi]
        if cfg.moe.num_shared:
            out = out + swiglu(h, p["ws_gate"], p["ws_up"], p["ws_down"])
        return x + out, tp.shared(aux) if tp.experts_split or sp else aux

    def _mamba(self, p, x, *, return_state: bool = False, sp: bool = False):
        """Pre-norm Mamba-2 block on one layer's params; returns the residual
        sum and, with ``return_state``, (h_final [B,H,P,N] float32, the last
        K-1 pre-conv ``xbc`` rows) for the decode cache.  Under a rank
        context: by the rank's SSM heads (:meth:`_tp_mixer`, its state the
        rank's cache shard) where they divide, else the whole block from the
        gathered weights (over the gathered rows under sequence
        parallelism, ``sp``, the rank's rows kept)."""
        tp = self.tp
        h = rms_norm(x, p["norm"], self.cfg.norm_eps)
        if tp is not None and tp.ssm_heads:
            out, state = self._tp_mixer(p, tp.enter(h, sp), return_state)
            return x + tp.leave(out, sp), state
        if tp is not None and sp:
            out, state = self._mixer(p, tp.gather_seq(h), return_state)
            lo, hi = tp.rows(out.shape[1])
            return x + out[:, lo:hi], state
        out, state = self._mixer(p, h, return_state)
        return x + self.shard(out, ("batch", "seq", "embed")), state

    def _scan(self, xin, dt, a, bmat, cmat):
        """The SSD scan at the config's chunk (halved until it divides the
        length): the kernel on CUDA (or meta) tensors with no gradient
        recorded, else ``ssd_chunked``."""
        sl = xin.shape[1]
        chunk = min(self.cfg.ssm.chunk, sl)
        while sl % chunk:
            chunk //= 2
        if kernel_path(xin, dt, a, bmat, cmat):
            return ssd_scan(xin, dt, a, bmat, cmat, chunk=chunk)
        return ssd_chunked(xin, dt, a, bmat, cmat, chunk=chunk)

    def _mixer(self, p, h, return_state: bool):
        """The Mamba-2 mixer on the normed input h [B,S,d]: (the output
        projection, the decode state or None)."""
        cfg, s = self.cfg, self.cfg.ssm
        b, sl, d = h.shape
        di = s.d_inner(d)
        nh = s.n_heads(d)
        g, n = s.n_groups, s.d_state
        zxbcdt = h @ p["in_proj"].to(h.dtype)
        z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * g * n, nh], dim=-1)
        conv_tail = xbc[:, -(s.d_conv - 1):, :] if return_state else None
        cw = p["conv_w"].to(h.dtype)
        cb = p["conv_b"].to(h.dtype)
        xbc = causal_conv1d(xbc, cw, cb)
        xin, bmat, cmat = torch.split(xbc, [di, g * n, g * n], dim=-1)
        xin = xin.reshape(b, sl, nh, s.head_dim)
        bmat = bmat.reshape(b, sl, g, n)
        cmat = cmat.reshape(b, sl, g, n)
        dt = F.softplus(dt.float() + p["dt_bias"])
        a = -torch.exp(p["a_log"].float())
        y, h_final = self._scan(xin, dt, a, bmat, cmat)
        y = y + xin * p["d_skip"].to(y.dtype)[None, None, :, None]
        y = y.reshape(b, sl, di) * F.silu(z)
        y = rms_norm(y, p["ssm_norm"], cfg.norm_eps)
        return y @ p["out_proj"].to(y.dtype), (h_final, conv_tail) if return_state else None

    def _tp_mixer(self, p, h, return_state: bool):
        """The Mamba-2 mixer on this rank's SSM heads ``[c·nh/m, (c+1)·nh/m)``
        (:mod:`repro_torch.dist.tensor_parallel`) from the entered input h
        [B,S,d]: ``in_proj``'s shard gives ``z_c | x_c | B_c | C_c | dt_c``;
        the depthwise conv runs on the x_c, B_c, C_c channels with the
        gathered ``conv_w``; B and C are all-gathered; the scan, the skip,
        the gate and ``ssm_norm`` (its sum of squares all-reduced) run on
        the rank's heads; ``out_proj``'s rows give a partial output.  The
        state: the rank's heads of h_final, and of the last K-1 pre-conv
        rows the cache's even slice of the ``[x|B|C]`` channels (all-gathered,
        then cut)."""
        tp, cfg, s = self.tp, self.cfg, self.cfg.ssm
        b, sl, d = h.shape
        m, c = tp.size, tp.coord
        di, nh, n = s.d_inner(d), s.n_heads(d), s.d_state  # one group (tp.ssm_heads)
        dil, nhl, gnl = di // m, nh // m, n // m
        zxbcdt = h @ p["in_proj"].to(h.dtype)
        z, xbc, dt = torch.split(zxbcdt, [dil, dil + 2 * gnl, nhl], dim=-1)
        conv_tail = None
        if return_state:
            w = (di + 2 * n) // m
            tail = tp.regroup(tp.all_gather(xbc[:, -(s.d_conv - 1):], -1), (dil, gnl, gnl))
            conv_tail = torch.cat(tail, -1)[..., c * w:(c + 1) * w]
        ar = functools.partial(torch.arange, device=h.device)
        chans = torch.cat([ar(c * dil, (c + 1) * dil), ar(di + c * gnl, di + (c + 1) * gnl),
                           ar(di + n + c * gnl, di + n + (c + 1) * gnl)])
        xbc = causal_conv1d(xbc, p["conv_w"].to(h.dtype)[chans], p["conv_b"].to(h.dtype)[chans])
        xin, bc = torch.split(xbc, [dil, 2 * gnl], dim=-1)
        bmat, cmat = (t.reshape(b, sl, 1, n) for t in tp.regroup(tp.gather(bc, -1), (gnl, gnl)))
        heads = slice(c * nhl, (c + 1) * nhl)
        xin = xin.reshape(b, sl, nhl, s.head_dim)
        dt = F.softplus(dt.float() + p["dt_bias"][heads])
        a = -torch.exp(p["a_log"][heads].float())
        y, h_final = self._scan(xin, dt, a, bmat, cmat)
        y = y + xin * p["d_skip"][heads].to(y.dtype)[None, None, :, None]
        y = y.reshape(b, sl, dil) * F.silu(z)
        y = tp.rms_norm(y, p["ssm_norm"][c * dil:(c + 1) * dil], cfg.norm_eps, di)
        return y @ p["out_proj"].to(y.dtype), (h_final, conv_tail) if return_state else None

    def _layer(self, ld: LayerDef, window, positions, keys, sp, x, source, *values):
        """One pre-norm layer (attention, Mamba-2 or gated cross-attention;
        an attention layer ``with_cross`` adds ungated cross-attention to
        ``source``; then the MLP if it has one) on its params, given as
        positional tensors so that ``torch.utils.checkpoint`` sees them;
        ``sp``: its stream's sequence-parallel decision under a rank
        context; returns (x, aux)."""
        p = dict(zip(keys, values))
        if ld.kind == "mamba":
            x, _ = self._mamba(p, x, sp=sp)
        elif ld.kind == "cross":
            x, _ = self._cross_attn(p, x, source, gated=True, sp=sp)
        else:
            x, _ = self._self_attn(p, x, window=window, positions=positions, causal=ld.causal,
                                   sp=sp)
            if ld.with_cross:
                x, _ = self._cross_attn(p, x, source, gated=False, sp=sp)
        if ld.with_mlp:
            return self._mlp(p, x, moe=ld.moe, sp=sp)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def _stage_forward(self, stage: StageDef, params, x, *, positions, source=None,
                       sp: bool = False, first: int = 0):
        """The stage's layers on ``x``: as many as ``params`` stacks (the
        whole stage, or a pipeline rank's chunk of it), layer ``i`` of them
        being the stage's layer ``first + i``; returns (x, summed aux)."""
        # unbind once: the backward of a per-layer view is then one stack,
        # not a full-size zero tensor per layer
        per = {ld.name: {k: v.unbind(0) for k, v in params[ld.name].items()}
               for ld in stage.body}
        count = len(next(iter(per[stage.body[0].name].values())))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(count):
            for ld in stage.body:
                keys = tuple(per[ld.name])
                values = [per[ld.name][k][i] for k in keys]
                fn = functools.partial(
                    self._layer, ld, stage.window(ld, first + i), positions, keys, sp
                )
                x, a = _remat(fn, x, source, *values, remat=self.remat)
                aux = aux + a
        return x, aux

    def encode(self, params, source_embeds: torch.Tensor, *, sp: bool = False) -> torch.Tensor:
        """Whisper's encoder (``repro/models/lm.py:590-607``): the source in
        the compute dtype through ``encoder.blk``'s layers (non-causal
        self-attention at positions ``arange(S_src)``, then the MLP), each
        recomputed in the backward pass unless ``remat="none"``, then
        ``encoder.norm``.  Under a rank context the encoder's stream takes
        its own sequence-parallel decision (the rank's rows of the source
        where it splits) and its layers compute partitioned; the output is
        whole on every rank (:meth:`TensorParallel.whole`), its gradient
        summed over the model ranks where the cross layers use it in part
        (by heads, or by the decoder's rows: ``sp``, the decoder's
        decision)."""
        x, enc_sp = self.encoder_input(source_embeds)
        x = self.encoder_layers(params["encoder"]["blk"], x, enc_sp)
        return self.encoder_output(params, x, enc_sp, sp)

    def encoder_input(self, source_embeds: torch.Tensor) -> tuple[torch.Tensor, bool]:
        """The encoder's stream in the compute dtype (the rank's rows where
        the rank context's decision, returned beside it, splits it)."""
        tp = self.tp
        x = source_embeds.to(self.compute_dtype)
        enc_sp = tp is not None and tp.decide_sp(x.shape[0], x.shape[1], self.cfg.d_model,
                                                 encoder=True)
        if enc_sp:
            lo, hi = tp.rows(x.shape[1])
            x = x[:, lo:hi]
        return x, enc_sp

    def encoder_layers(self, blk, x: torch.Tensor, enc_sp: bool) -> torch.Tensor:
        """The layers ``blk`` stacks (all of ``encoder.blk``, or a pipeline
        rank's chunk) on the encoder's stream."""
        n = x.shape[1] * (self.tp.size if enc_sp else 1)  # the source's positions
        keys = tuple(blk)
        per = {k: blk[k].unbind(0) for k in keys}
        ld = LayerDef("blk", "attn", causal=False)
        fn = functools.partial(self._layer, ld, 0, torch.arange(n, device=x.device), keys, enc_sp)
        for layer in range(len(per[keys[0]])):
            values = [per[k][layer] for k in keys]
            x, _ = _remat(fn, x, None, *values, remat="none" if self.remat == "none" else "full")
        return x

    def encoder_output(self, params, x: torch.Tensor, enc_sp: bool, sp: bool) -> torch.Tensor:
        """``encoder.norm``, then the output whole on every model rank (its
        gradient summed where the cross layers, by heads or by the
        decoder's rows ``sp``, use it in part)."""
        tp = self.tp
        x = rms_norm(x, params["encoder"]["norm"], self.cfg.norm_eps)
        return x if tp is None else tp.whole(x, enc_sp, partial=tp.heads or sp)

    def source(self, params, source_embeds, *, sp: bool = False):
        """What the cross-attention layers read: the encoder's output for
        encdec, the source embeds themselves for vlm, None otherwise.
        ``sp``: the decoder's sequence-parallel decision under a rank
        context."""
        if self.cfg.encoder is not None:
            return self.encode(params, source_embeds, sp=sp)
        return source_embeds if self.cfg.cross_attn is not None else None

    def forward(self, params, tokens: torch.Tensor, *, source_embeds=None, positions=None):
        """tokens [B,S] (and, for vlm/encdec, ``source_embeds`` [B,S_src,·])
        → (fp32 logits [B,S,vocab_padded], aux loss scalar).

        The logits are the bf16 activations times the bf16-rounded unembed,
        accumulated and returned in fp32 (the reference's einsum with
        ``preferred_element_type=float32``): both operands are upcast
        exactly and multiplied in fp32."""
        sp = self.stream_sp(tokens)
        x = self.embed_tokens(params, tokens, sp)
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        source = self.source(params, source_embeds, sp=sp)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for stage in self.stages:
            x, a = self._stage_forward(stage, params[stage.name], x, positions=positions,
                                       source=source, sp=sp)
            aux = aux + a
        return self.logits(params, x, sp), aux

    def stream_sp(self, tokens: torch.Tensor) -> bool:
        """Under a rank context, whether the decoder's stream is seq-sharded
        (:meth:`TensorParallel.decide_sp`); False without one."""
        return self.tp is not None and self.tp.decide_sp(tokens.shape[0], tokens.shape[1],
                                                         self.cfg.d_model)

    def embed_tokens(self, params, tokens: torch.Tensor, sp: bool) -> torch.Tensor:
        """The residual stream's input: under a rank context the rank's rows
        (``sp``), vocab-parallel where tensor parallelism splits ``embed``."""
        if self.tp is not None:
            return self.tp.embed(params["embed"].to(self.compute_dtype), tokens, sp)
        x = F.embedding(tokens, params["embed"].to(self.compute_dtype))
        return self.shard(x, ("batch", "seq", "embed"))

    def logits(self, params, x: torch.Tensor, sp: bool) -> torch.Tensor:
        """``final_norm`` and the fp32 logits of the stream ``x``: under a
        rank context with tensor parallelism every position's logits of the
        rank's vocab shard; with it off the rank's rows' whole logits."""
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.tp is not None and self.tp.tensor:
            return self.tp.enter(x, sp).float() @ self.unembed(params).float()
        logits = x.float() @ self.unembed(params).float()
        return logits if self.tp is not None else self.shard(logits, ("batch", "seq", "vocab"))

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The mean next-token cross-entropy over the logical vocabulary of
        :meth:`logits`' output: vocab-parallel under tensor parallelism; with
        it off and the stream seq-sharded, the mean over the model group of
        each rank's rows (every rank the same value, its gradient the
        rank's rows')."""
        tp = self.tp
        if tp is not None and tp.tensor:  # vocab-parallel, the padding masked
            return tp.cross_entropy(logits, labels.long(), self.cfg.vocab_size).mean()
        rows = tp is not None and tp.sp
        if rows:
            lo, hi = tp.rows(labels.shape[1])
            labels = labels[:, lo:hi]
        logits = logits[..., : self.cfg.vocab_size]  # mask alignment padding
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -torch.gather(logp, -1, labels[..., None].long())[..., 0].mean()
        return tp.reduce(loss) / tp.size if rows else loss

    def loss_fn(self, params, batch):
        """Next-token cross-entropy over the logical vocabulary, plus
        ``router_aux_weight`` × the summed aux loss for MoE configs; the
        metrics carry the bare cross-entropy as ``loss`` and the aux."""
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits, aux = self.forward(params, inputs, source_embeds=batch.get("source_embeds"))
        loss = self.cross_entropy(logits, labels)
        total = loss
        if self.cfg.moe is not None:
            total = total + self.cfg.moe.router_aux_weight * aux
        return total, {"loss": loss, "aux": aux}

    def unembed(self, params) -> torch.Tensor:
        """The [d, vocab_padded] output projection in the compute dtype."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return w.to(self.compute_dtype)


def build_lm(
    cfg: ModelConfig,
    *,
    vocab_multiple: int = 1,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat: str = "full",
    moe_groups: int | None = None,
    shard: Callable | None = None,
) -> LM:
    """Construct the model for a config.  ``vocab_multiple`` pads the
    vocab dim of the embedding to the mesh-axis multiple that shards it;
    the padding is runtime-only, UCP atoms store the logical vocab.
    ``moe_groups`` and ``shard`` are the reference's."""
    if remat not in ("full", "dots", "none"):
        raise ValueError(f"remat={remat!r}: takes 'full', 'dots' or 'none'")
    vp = -(-cfg.vocab_size // vocab_multiple) * vocab_multiple
    return LM(
        cfg=cfg,
        vocab_padded=vp,
        registry=build_param_defs(cfg, vp),
        stages=plan_stages(cfg),
        compute_dtype=compute_dtype,
        remat=remat,
        moe_groups=moe_groups,
        shard=shard or _no_shard,
    )
