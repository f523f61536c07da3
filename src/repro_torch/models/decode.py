"""Serving path: cache construction, prefill, single-token decode
(port of the dense GQA path of ``repro.models.decode``).

The cache is the reference's: per stage and body position, ring-buffered
K/V ``[count, B, C, Hkv, hd]`` in the compute dtype with ``slot_pos
[count, B, C]`` holding each slot's absolute token position (-1 = empty),
``C = min(window, cache_len)`` for static sliding-window layers and
``cache_len`` otherwise; ``pos [B]`` is the next position.  Masking is by
position, so ring overwrite needs no special case.

Unlike the reference, which returns a new cache, the port writes the K/V
and ``slot_pos`` buffers in place (it saves a full copy of the cache per
step) and returns the same dict with ``pos`` advanced.
"""

from __future__ import annotations

import torch

from .attention import decode_attention
from .common import apply_rope, rms_norm, rotary_embedding
from .lm import LM, LayerDef

__all__ = ["init_cache", "prefill", "decode_step"]


def _cache_len_for(ld: LayerDef, cache_len: int) -> int:
    if ld.kind == "attn" and ld.window > 0:
        return min(ld.window, cache_len)
    return cache_len


def init_cache(lm: LM, batch: int, cache_len: int, *, device=None) -> dict:
    cfg = lm.cfg
    dt = lm.compute_dtype
    hd = cfg.resolved_head_dim
    hkv = cfg.num_kv_heads
    cache: dict = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    for stage in lm.stages:
        st: dict = {}
        for ld in stage.body:
            c = _cache_len_for(ld, cache_len)
            n = stage.count
            st[ld.name] = {
                "k": torch.zeros((n, batch, c, hkv, hd), dtype=dt, device=device),
                "v": torch.zeros((n, batch, c, hkv, hd), dtype=dt, device=device),
                "slot_pos": torch.full((n, batch, c), -1, dtype=torch.int32, device=device),
            }
        cache[stage.name] = st
    return cache


def _layer(params: dict, l: int) -> dict:
    """One layer's params: index every stacked ``[L, ...]`` tensor at ``l``."""
    return {k: v[l] for k, v in params.items()}


def _write_ring(cache_arr: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """cache_arr [B,C,...]; new [B,...]; write at slot pos[0] % C, in place.

    Requests are served in lockstep, so the slot comes from ``pos[0]``, as
    in the reference; it stays a device tensor (no host sync per layer)."""
    slot = (pos[:1] % cache_arr.shape[1]).long()
    cache_arr.index_copy_(1, slot, new[:, None].to(cache_arr.dtype))


def _fill_ring(cache_arr: torch.Tensor, seq_vals: torch.Tensor, s: int) -> None:
    """Write the last min(C,S) sequence entries into ring slots pos % C."""
    c = cache_arr.shape[1]
    take = min(c, s)
    slots = torch.arange(s - take, s, device=cache_arr.device) % c
    cache_arr[:, slots] = seq_vals[:, s - take:].to(cache_arr.dtype)


def _logits(lm: LM, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and unembed over the logical vocab; the products of the
    compute-dtype operands accumulate in float32, as the reference's
    ``preferred_element_type=float32``."""
    x = rms_norm(x, params["final_norm"], lm.cfg.norm_eps)
    logits = x.float() @ lm.unembed(params).float()
    return logits[..., : lm.cfg.vocab_size]


def decode_step(lm: LM, params, cache: dict, tokens: torch.Tensor):
    """One decode step.  tokens [B,1] → (logits [B,1,V] float32, cache)."""
    cfg = lm.cfg
    pos = cache["pos"]
    x = params["embed"].to(lm.compute_dtype)[tokens]
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    sin, cos = rotary_embedding(pos[:, None], hd, cfg.rope_theta)
    for stage in lm.stages:
        for l in range(stage.count):
            for ld in stage.body:
                p = _layer(params[stage.name][ld.name], l)
                entry = cache[stage.name][ld.name]
                k_c, v_c, slot_pos = entry["k"][l], entry["v"][l], entry["slot_pos"][l]
                h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
                qkv = h @ p["wqkv"].to(h.dtype)
                q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
                q = apply_rope(q.reshape(b, 1, hq, hd), sin, cos)
                k = apply_rope(k.reshape(b, 1, hkv, hd), sin, cos)
                _write_ring(k_c, k[:, 0], pos)
                _write_ring(v_c, v.reshape(b, hkv, hd), pos)
                _write_ring(slot_pos, pos, pos)
                o = decode_attention(
                    q, k_c, v_c, cache_positions=slot_pos, cur_pos=pos,
                    window=stage.window(ld, l),
                )
                x = x + o.reshape(b, 1, hq * hd) @ p["wo"].to(h.dtype)
                x = lm._mlp(p, x)
    cache["pos"] = pos + 1
    return _logits(lm, params, x), cache


def prefill(lm: LM, params, cache: dict, tokens: torch.Tensor):
    """Run the forward pass over a prompt and populate the cache.

    tokens [B,S] → (logits of the last position [B,V] float32, cache).  Each
    layer's roped K/V go into its ring buffer (the trailing ``min(C, S)``
    tokens).  On CUDA every layer's attention is one flash-attention launch.
    """
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    x = params["embed"].to(lm.compute_dtype)[tokens]
    for stage in lm.stages:
        for l in range(stage.count):
            for ld in stage.body:
                p = _layer(params[stage.name][ld.name], l)
                entry = cache[stage.name][ld.name]
                x, (k, v) = lm._self_attn(
                    p, x, window=stage.window(ld, l), positions=positions,
                    causal=ld.causal,
                )
                _fill_ring(entry["k"][l], k, s)
                _fill_ring(entry["v"][l], v, s)
                _fill_ring(
                    entry["slot_pos"][l],
                    positions.to(torch.int32).expand(b, s),
                    s,
                )
                x = lm._mlp(p, x)
    cache["pos"] = cache["pos"] + s
    return _logits(lm, params, x[:, -1]), cache
