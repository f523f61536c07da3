"""Attention for the dense GQA path (port of ``repro.models.attention``).

* :func:`full_attention` — the naive O(S²) softmax: the CPU path of prefill
  and the plain yardstick the Hopper kernel is held against;
* :func:`decode_attention` — one-token decode against a ring-buffered KV
  cache, plain torch (the reference has no Pallas kernel for decode).

On CUDA, prefill goes through the hand-written flash-attention kernel
(``repro_torch.kernels.flash_attention``) instead of :func:`full_attention`.
``chunked_attention`` waits for the training slice (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

import math

import torch

__all__ = ["full_attention", "decode_attention", "repeat_kv"]

_NEG_INF = -2.0e38  # large finite negative: avoids NaN from all-masked rows


def _allowed(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int, *, causal: bool):
    """Mask of shape [..., Sq, Skv]: True where attention is permitted."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    ok = (d >= 0) if causal else torch.ones_like(d, dtype=torch.bool)
    if window > 0:
        ok = ok & (d < window)
    return ok


def repeat_kv(kv: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, Hkv, D] → [B, S, Hkv*groups, D] (GQA head sharing)."""
    if groups == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, groups, d).reshape(b, s, h * groups, d)


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Naive reference. q: [B,Sq,H,D]; k,v: [B,Skv,Hkv,Dv]."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    k = repeat_kv(k, h // hkv)
    v = repeat_kv(v, h // hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = torch.arange(skv, device=q.device)
    mask = _allowed(q_pos, kv_pos, window, causal=causal)
    scores = torch.where(mask[None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    cache_positions: torch.Tensor,
    cur_pos: torch.Tensor,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """One-token decode against a (possibly ring-buffered) KV cache.

    q: [B,1,H,D]; caches: [B,C,Hkv,D]; ``cache_positions``: [B,C] absolute
    position held in each slot (-1 = empty); ``cur_pos``: [B].  Masking is
    by position, not slot, so ring buffers need no special case.  GQA is
    handled group-wise: the query is reshaped, never the cache.
    """
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = (q.reshape(b, hkv, g, d).float() * scale).to(q.dtype)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache).float()
    dpos = cur_pos[:, None] - cache_positions  # [B,C]
    ok = (cache_positions >= 0) & (dpos >= 0)
    if window > 0:
        ok = ok & (dpos < window)
    s = torch.where(ok[:, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_cache)
    return o.reshape(b, 1, h, d)
