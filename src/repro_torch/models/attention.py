"""Attention for the dense GQA path (port of ``repro.models.attention``).

* :func:`full_attention` — the naive O(S²) softmax: the CPU path of prefill,
  the differentiable path of training up to 2048 tokens, and the plain
  yardstick the Hopper kernel is held against;
* :func:`chunked_attention` — the online-softmax form the reference trains
  through above 2048 tokens (differentiable, plain torch);
* :func:`decode_attention` — one-token decode against a ring-buffered KV
  cache, plain torch (the reference has no Pallas kernel for decode).

On CUDA, prefill with no gradient recorded goes through the hand-written
flash-attention kernel (``repro_torch.kernels.flash_attention``) instead.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "full_attention", "chunked_attention", "decode_attention", "decode_attention_partial",
    "decode_scores", "repeat_kv",
]

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


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    scale: float | None = None,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention with O(q_block·kv_block) live score memory;
    equal to :func:`full_attention` up to rounding.  The scale is folded
    into q once, as the reference does."""
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_block = min(q_block, sq)
    kv_block = min(kv_block, skv)
    if sq % q_block or skv % kv_block:
        raise ValueError(f"seq lens ({sq},{skv}) not divisible by blocks")
    nq, nk = sq // q_block, skv // kv_block
    k = repeat_kv(k, h // hkv)
    v = repeat_kv(v, h // hkv)
    q = (q.float() * scale).to(q.dtype)
    qs = q.reshape(b, nq, q_block, h, d).permute(1, 0, 3, 2, 4)  # [nq,B,H,qb,d]
    ks = k.reshape(b, nk, kv_block, h, d).permute(1, 0, 3, 2, 4)
    vs = v.reshape(b, nk, kv_block, h, dv).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=q.device)
        m = torch.full((b, h, q_block), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, q_block, dv), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            kv_pos = kj * kv_block + torch.arange(kv_block, device=q.device)
            s = torch.einsum("bhqd,bhkd->bhqk", qs[qi], ks[kj]).float()
            mask = _allowed(q_pos, kv_pos, window, causal=causal)
            s = torch.where(mask[None, None], s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vs.dtype), vs[kj]
            ).float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-37)[..., None]).to(q.dtype))
    # [nq, B, H, qb, dv] → [B, Sq, H, dv]
    return torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, sq, h, dv)


def decode_scores(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    *,
    cache_positions: torch.Tensor,
    cur_pos: torch.Tensor,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """The masked float32 scores ``[B, Hkv, G, C]`` of
    :func:`decode_attention` (masked slots ``_NEG_INF``)."""
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
    return torch.where(ok[:, None, None, :], s, _NEG_INF)


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
    b, _, h, _ = q.shape
    s = decode_scores(q, k_cache, cache_positions=cache_positions, cur_pos=cur_pos,
                      window=window, scale=scale)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_cache)
    return o.reshape(b, 1, h, v_cache.shape[-1])


def decode_attention_partial(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    cache_positions: torch.Tensor,
    cur_pos: torch.Tensor,
    window: int = 0,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decode_attention` over a part of the cache's slots (a rank's
    share of a cache sharded over its length), unnormalized: ``(o, m, l)``
    in float32, ``o [B,1,H,Dv]`` the weighted sum of V before the division,
    ``m [B,1,H]`` the max of the masked scores and ``l [B,1,H]`` the sum of
    their exponentials.  The parts combine by flash-decoding's rule
    (:meth:`~repro_torch.dist.tensor_parallel.TensorParallel.combine`); a
    part whose every slot is masked has ``l = 0`` and adds nothing."""
    b, _, h, _ = q.shape
    s = decode_scores(q, k_cache, cache_positions=cache_positions, cur_pos=cur_pos,
                      window=window, scale=scale)
    m = s.amax(dim=-1)
    p = torch.where(s > _NEG_INF, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bkgc,bckd->bkgd", p.to(v_cache.dtype), v_cache).float()
    return (o.reshape(b, 1, h, v_cache.shape[-1]), m.reshape(b, 1, h),
            p.sum(dim=-1).reshape(b, 1, h))
