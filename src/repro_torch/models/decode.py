"""Serving path: cache construction, prefill, single-token decode
(port of ``repro.models.decode``).  A MoE layer routes each sequence as
one group, as the reference's serving does, so a decode step routes one
token a group with capacity 1 and drops nothing; its aux loss is dropped.

The cache is the reference's, per stage and body position; ``pos [B]`` is
the next position:

* GQA attention — ring-buffered K/V ``[count, B, C, Hkv, hd]`` in the
  compute dtype with ``slot_pos [count, B, C]`` holding each slot's absolute
  token position (-1 = empty), ``C = min(window, cache_len)`` for static
  sliding-window layers and ``cache_len`` otherwise.  Masking is by
  position, so ring overwrite needs no special case.
* MLA (DeepSeek-V2) — the compressed latent ``c_kv [count, B, C, kv_lora]``
  and the one shared roped key head ``k_rope [count, B, C, rope]``, with
  ``slot_pos``; decode attends in the latent space (the absorbed form: no
  per-head K or V is ever built), in plain PyTorch as the reference, which
  has no kernel for it.
* Mamba-2 — constant size: the SSM state ``h [count, B, H, P, N]`` in
  float32 and the conv window ``conv [count, B, K-1, conv_dim]`` (the last
  K-1 pre-conv ``xbc`` rows) in the compute dtype.
* Cross-attention — the source's K/V ``ck``/``cv [count, B, S_src, Hkv, hd]``
  in the compute dtype, written once by prefill (``cross_attn.source_len``
  for a vlm ``cross`` layer; ``encoder.source_len`` beside the ring of an
  encdec layer ``with_cross``).  Decode attends to them with the plain
  ``full_attention`` at Sq = 1, as the reference.

Unlike the reference, which returns a new cache, the port writes the
buffers in place (it saves a full copy of the cache per step) and returns
the same dict with ``pos`` advanced.

Under a rank context (``lm.tp``: any family of a multi-rank run) the cache
holds the rank's shard of each entry by
:func:`~repro_torch.dist.sharding.cache_pspecs` (its rows of the batch, its
KV heads where they divide the model axis, else the whole cache; a cross
layer's ``ck``/``cv`` likewise its KV heads; MLA's latent ``c_kv``,
``k_rope`` and ``slot_pos`` whole on every rank; a Mamba layer's ``h`` its
SSM heads and ``conv`` an even slice of its channels, whole where the SSM
heads do not divide and the block computes from the gathered weights),
prefill computes partitioned as the training forward does (whisper's
encoder too, once), a decode step (one position, which does not split)
all-reduces after the row-parallel products (an MLA layer's from its heads'
slice of the absorbed ``wkv_b``; a cross layer's before its gate), and both
return the rank's vocab shard of the logits (:func:`greedy` picks across the
shards).

With ``shard_cache_seq`` (the context's ``ParallelismConfig``) the entries
``cache_pspecs`` shards over their length instead (``k``/``v``/``ck``/``cv``
whose KV heads do not divide the model axis, MLA's latent cache, every
``slot_pos``; where the model size divides the length) hold a contiguous
``C / m`` of the slots on each rank, and the cache holds the rings' whole
length (``cache_len``).  A token's K/V goes only to the rank
that owns slot ``pos % C`` (prefill fills only the rank's slots), each rank
attends over its own slots, and the partial results combine over the
model group (flash-decoding: :meth:`TensorParallel.combine`): every rank
then holds the whole attention.  MLA by heads first gathers the absorbed
queries of every head; a ``slot_pos`` sharded beside whole ``k``/``v``
(KV heads that divide) is gathered for the mask.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
from repro_torch.dist.sharding import cache_pspecs, local_shape

from .attention import decode_attention, decode_attention_partial, full_attention
from .common import apply_rope, rms_norm, rotary_embedding
from .lm import LM, LayerDef
from .ssm import conv_decode_step, ssm_decode_step

__all__ = ["init_cache", "prefill", "decode_step", "greedy"]


def _cache_len_for(ld: LayerDef, cache_len: int) -> int:
    if ld.kind == "attn" and ld.window > 0:
        return min(ld.window, cache_len)
    return cache_len


def init_cache(lm: LM, batch: int, cache_len: int, *, device=None) -> dict:
    """The empty cache for ``batch`` requests of up to ``cache_len``
    positions.  Under a rank context ``batch`` is the global batch and each
    entry is the rank's shard by ``cache_pspecs``, over its length too under
    ``shard_cache_seq`` (the module notes); a context with tensor
    parallelism off is refused (the reference's serve launcher never sets
    it)."""
    if lm.tp is not None:
        if not lm.tp.tensor:
            raise NotImplementedError("serving by rows with tensor parallelism off: the "
                                      "reference's serve launcher keeps it on")
        return _rank_cache(lm, batch, cache_len, device)
    cfg = lm.cfg
    dt = lm.compute_dtype
    hd = cfg.resolved_head_dim
    hkv = cfg.num_kv_heads
    cache: dict = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    for stage in lm.stages:
        st: dict = {}
        for ld in stage.body:
            n = stage.count
            if ld.kind == "mamba":
                s = cfg.ssm
                di = s.d_inner(cfg.d_model)
                st[ld.name] = {
                    "h": torch.zeros(
                        (n, batch, s.n_heads(cfg.d_model), s.head_dim, s.d_state),
                        dtype=torch.float32, device=device,
                    ),
                    "conv": torch.zeros(
                        (n, batch, s.d_conv - 1, di + 2 * s.n_groups * s.d_state),
                        dtype=dt, device=device,
                    ),
                }
            elif ld.kind == "cross":
                st[ld.name] = _cross_entry(n, batch, cfg.cross_attn.source_len, hkv, hd, dt,
                                           device)
            else:
                c = _cache_len_for(ld, cache_len)
                if cfg.mla is not None:
                    m = cfg.mla
                    entry = {
                        "c_kv": torch.zeros((n, batch, c, m.kv_lora_rank), dtype=dt,
                                            device=device),
                        "k_rope": torch.zeros((n, batch, c, m.qk_rope_head_dim), dtype=dt,
                                              device=device),
                    }
                else:
                    entry = {
                        "k": torch.zeros((n, batch, c, hkv, hd), dtype=dt, device=device),
                        "v": torch.zeros((n, batch, c, hkv, hd), dtype=dt, device=device),
                    }
                entry["slot_pos"] = torch.full((n, batch, c), -1, dtype=torch.int32,
                                               device=device)
                if ld.with_cross:
                    entry.update(_cross_entry(n, batch, cfg.encoder.source_len, hkv, hd, dt,
                                              device))
                st[ld.name] = entry
        cache[stage.name] = st
    return cache


_RINGS = ("k", "v", "c_kv", "k_rope", "slot_pos")  # the self-attention layers' ring entries


def _rank_cache(lm: LM, batch: int, cache_len: int, device) -> dict:
    """The rank's shard of every entry; where a ring is sharded over its
    length, also ``cache_len`` (a 0-d CPU tensor): the whole rings' length,
    which tells a rank's part of a ring from a whole one (:func:`_slots`)."""
    tp = lm.tp
    shapes = init_cache(dataclasses.replace(lm, tp=None), batch, cache_len, device="meta")
    specs = flatten_with_paths(cache_pspecs(shapes, tp.parallel, tp.mesh))
    out = {}
    by_length = False
    for path, t in flatten_with_paths(shapes).items():
        spec = specs[path]
        name = path.split(".")[-1]
        if name in ("h", "conv") and not tp.ssm_heads:  # the whole block on every rank
            spec = type(spec)(*(None if e == tp.axis else e for e in spec))
        by_length |= name in _RINGS and spec[2] is not None
        out[path] = torch.full(local_shape(tuple(t.shape), spec, tp.mesh),
                               -1 if path.endswith("slot_pos") else 0, dtype=t.dtype,
                               device=device)
    if by_length:
        out["cache_len"] = torch.tensor(cache_len)
    return unflatten_from_paths(out)


def _cross_entry(n: int, batch: int, src: int, hkv: int, hd: int, dt, device) -> dict:
    return {name: torch.zeros((n, batch, src, hkv, hd), dtype=dt, device=device)
            for name in ("ck", "cv")}


def _layer(stacked: dict, l: int) -> dict:
    """One layer's params or cache entry: index every stacked ``[L, ...]``
    tensor at ``l`` (views, so cache writes land in the stack)."""
    return {k: v[l] for k, v in stacked.items()}


def _ring_len(cache: dict) -> int | None:
    """The whole rings' length of a cache some of whose rings are sharded
    over their length (:func:`_rank_cache`), else None."""
    t = cache.get("cache_len")
    return None if t is None else int(t)


def _slots(lm: LM, ld: LayerDef, arr: torch.Tensor, cache_len: int | None) -> tuple[int, int]:
    """``(lo, C)`` of one layer's ring entry ``arr [B, n, ...]``: it holds
    slots ``[lo, lo + n)`` of a ring of ``C``, the whole ring (``lo`` 0,
    ``C`` = n) unless it is sharded over its length (the module notes;
    ``cache_len`` from :func:`_ring_len`)."""
    n = arr.shape[1]
    ring = n if cache_len is None else _cache_len_for(ld, cache_len)
    return (0, n) if n == ring else (lm.tp.coord * n, ring)


def _write_ring(cache_arr: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                lo: int = 0, ring: int | None = None) -> None:
    """cache_arr [B,n,...] holding slots [lo, lo + n) of a ring of ``ring``
    (default n); new [B,...]; write at slot pos[0] % ring where this part
    holds it, in place.

    Requests are served in lockstep, so the slot comes from ``pos[0]``, as
    in the reference; it stays a device tensor (no host sync per layer)."""
    n = cache_arr.shape[1]
    new = new[:, None].to(cache_arr.dtype)
    slot = (pos[:1] % (ring or n)).long() - lo
    if ring is not None and ring != n:  # another rank may own the slot
        idx = slot.clamp(0, n - 1)
        hit = ((slot >= 0) & (slot < n)).reshape((1,) * cache_arr.dim())
        new, slot = torch.where(hit, new, cache_arr.index_select(1, idx)), idx
    cache_arr.index_copy_(1, slot, new)


def _fill_ring(cache_arr: torch.Tensor, seq_vals: torch.Tensor, s: int, lo: int = 0,
               ring: int | None = None) -> None:
    """Write the last min(C,S) sequence entries into ring slots pos % C,
    those of them in ``cache_arr``'s slots [lo, lo + n) of a ring of
    ``ring`` (default n): slot j takes the last position below S that is
    j mod C, and slots from S on hold none yet."""
    n = cache_arr.shape[1]
    ring = ring or n
    hi = min(lo + n, s)
    if hi <= lo:
        return
    j = torch.arange(lo, hi, device=cache_arr.device)
    pos = j + ring * torch.div(s - 1 - j, ring, rounding_mode="floor")
    cache_arr[:, : hi - lo] = seq_vals[:, pos].to(cache_arr.dtype)


def _write_source(lm: LM, entry: dict, l: int, kv) -> None:
    """Layer ``l``'s cross-attention K/V over the source into its cache (the
    rank's source positions where the cache is sharded over them)."""
    for name, t in zip(("ck", "cv"), kv):
        n = entry[name].shape[2]
        if n != t.shape[1]:
            t = t[:, lm.tp.coord * n:(lm.tp.coord + 1) * n]
        entry[name][l].copy_(t)


def _logits(lm: LM, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and unembed over the logical vocab; the products of the
    compute-dtype operands accumulate in float32, as the reference's
    ``preferred_element_type=float32``.  Under a rank context: the rank's
    vocab shard, its padding columns included."""
    x = rms_norm(x, params["final_norm"], lm.cfg.norm_eps)
    logits = x.float() @ lm.unembed(params).float()
    return logits if lm.tp is not None else logits[..., : lm.cfg.vocab_size]


def greedy(lm: LM, logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row of ``logits`` [..., V]: ``argmax``, or
    under a rank context the argmax across the vocab shards (ties to the
    lower index), the same on every rank."""
    if lm.tp is not None:
        return lm.tp.greedy(logits, lm.cfg.vocab_size)
    return logits.argmax(-1)


def _embed(lm: LM, params, tokens: torch.Tensor, sp: bool) -> torch.Tensor:
    table = params["embed"].to(lm.compute_dtype)
    if lm.tp is not None:
        return lm.tp.embed(table, tokens, sp)
    return table[tokens]


def _attn_decode(lm: LM, ld: LayerDef, p, entry, x, pos, sin, cos, window: int,
                 cache_len: int | None) -> torch.Tensor:
    """One attention layer of a decode step (MLA's go to :func:`_mla_decode`);
    writes this token's K/V in place.  K/V sharded over the cache length
    (KV heads that do not divide, computed whole on every rank): attention
    over the rank's slots, combined over the model group."""
    cfg = lm.cfg
    if cfg.mla is not None:
        return _mla_decode(lm, ld, p, entry, x, pos, sin, cos, cache_len)
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    heads = lm.tp is not None and lm.tp.heads  # the rank's own heads, its cache's
    hq, hkv = lm.tp.local_heads(cfg) if lm.tp is not None else (cfg.num_heads, cfg.num_kv_heads)
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    if heads:
        h = lm.tp.copy(h)
    qkv = h @ p["wqkv"].to(h.dtype)
    q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = apply_rope(q.reshape(b, 1, hq, hd), sin, cos)
    k = apply_rope(k.reshape(b, 1, hkv, hd), sin, cos)
    kv_slots = _slots(lm, ld, entry["k"], cache_len)
    sp_slots = _slots(lm, ld, entry["slot_pos"], cache_len)
    _write_ring(entry["k"], k[:, 0], pos, *kv_slots)
    _write_ring(entry["v"], v.reshape(b, hkv, hd), pos, *kv_slots)
    _write_ring(entry["slot_pos"], pos, pos, *sp_slots)
    if kv_slots[1] != entry["k"].shape[1]:  # slot_pos alike
        o = lm.tp.combine(*decode_attention_partial(
            q, entry["k"], entry["v"], cache_positions=entry["slot_pos"], cur_pos=pos,
            window=window)).to(q.dtype)
    else:
        positions = entry["slot_pos"]
        if sp_slots[1] != positions.shape[1]:  # whole K/V, slot_pos by length
            positions = lm.tp.all_gather(positions, 1)
        o = decode_attention(q, entry["k"], entry["v"], cache_positions=positions, cur_pos=pos,
                             window=window)
    out = o.reshape(b, 1, hq * hd) @ p["wo"].to(h.dtype)
    return x + (lm.tp.reduce(out) if heads else out)


def _mla_decode(lm: LM, ld: LayerDef, p, entry, x, pos, sin, cos,
                cache_len: int | None) -> torch.Tensor:
    """One MLA layer of a decode step in the absorbed form
    (``repro/models/decode.py:140-177``): this token's latent and roped key
    head go into the cache in place; q's nope part is absorbed into kv_b's
    key half (q_abs = q_nope · w_k), the latent and rope scores are added in
    the compute dtype, cast to fp32 and scaled by 1/sqrt(nope + rope),
    masked by ``slot_pos``, softmaxed in fp32 and cast back; the context in
    latent space goes through kv_b's value half, then wo.  A latent cache
    sharded over its length: every head's absorbed query (gathered under
    heads) against the rank's slots, the partial contexts combined over the
    model group, the rank's heads kept."""
    cfg, m = lm.cfg, lm.cfg.mla
    b = x.shape[0]
    heads = lm.tp is not None and lm.tp.heads  # the rank's heads; the latent cache whole
    hq = cfg.num_heads // (lm.tp.size if heads else 1)
    nope, rope, vhd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    if heads:
        h = lm.tp.copy(h)
    qa = rms_norm(h @ p["wq_a"].to(h.dtype), p["q_norm"], cfg.norm_eps)
    q = (qa @ p["wq_b"].to(h.dtype)).reshape(b, 1, hq, nope + rope)
    kva = h @ p["wkv_a"].to(h.dtype)
    c_kv = rms_norm(kva[..., : m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    q_rope = apply_rope(q[..., nope:], sin, cos)
    k_rope = apply_rope(kva[..., m.kv_lora_rank:][:, :, None, :], sin, cos)[:, :, 0, :]
    slots = _slots(lm, ld, entry["c_kv"], cache_len)  # k_rope and slot_pos alike
    sharded = slots[1] != entry["c_kv"].shape[1]
    _write_ring(entry["c_kv"], c_kv[:, 0], pos, *slots)
    _write_ring(entry["k_rope"], k_rope[:, 0], pos, *slots)
    _write_ring(entry["slot_pos"], pos, pos, *slots)
    wkv_b = p["wkv_b"].to(h.dtype).reshape(m.kv_lora_rank, hq, nope + vhd)
    w_k, w_v = wkv_b[..., :nope], wkv_b[..., nope:]
    q_abs = torch.einsum("bshn,rhn->bshr", q[..., :nope], w_k)  # absorbed q
    if sharded and heads:  # every head against this rank's slots
        q_abs, q_rope = lm.tp.all_gather(q_abs, 2), lm.tp.all_gather(q_rope, 2)
    s_lat = torch.einsum("bshr,bcr->bshc", q_abs, entry["c_kv"])
    s_rope = torch.einsum("bshr,bcr->bshc", q_rope, entry["k_rope"])
    scores = (s_lat + s_rope).float() * (1.0 / math.sqrt(nope + rope))
    slot_pos = entry["slot_pos"]
    ok = (slot_pos >= 0) & (pos[:, None] - slot_pos >= 0)
    scores = torch.where(ok[:, None, None, :], scores, -2.0e38)
    if sharded:
        top = scores.amax(dim=-1)
        e = torch.where(ok[:, None, None, :], torch.exp(scores - top[..., None]), 0.0)
        part = torch.einsum("bshc,bcr->bshr", e.to(h.dtype), entry["c_kv"]).float()
        ctx = lm.tp.combine(part, top, e.sum(dim=-1)).to(h.dtype)
        if heads:
            ctx = ctx[:, :, lm.tp.coord * hq:(lm.tp.coord + 1) * hq]
    else:
        probs = torch.softmax(scores, dim=-1).to(h.dtype)
        ctx = torch.einsum("bshc,bcr->bshr", probs, entry["c_kv"])
    o = torch.einsum("bshr,rhn->bshn", ctx, w_v)  # [b, 1, hq, vhd]
    out = o.reshape(b, 1, hq * vhd) @ p["wo"].to(h.dtype)
    return x + (lm.tp.reduce(out) if heads else out)


def _cross_decode(lm: LM, p, entry, x, *, gated: bool) -> torch.Tensor:
    """One cross-attention layer of a decode step
    (``repro/models/decode.py:181-196``): q from this token against the
    source's cached ``ck``/``cv``, the plain ``full_attention`` with no
    mask; gated by tanh(``cross_gate``) in a vlm ``cross`` layer.  Under a
    rank context where the heads divide: the rank's q heads against its KV
    heads' ``ck``/``cv``, reduced before the gate; where ``ck``/``cv`` are
    sharded over the source positions: every head against the rank's
    positions, combined over the model group."""
    cfg = lm.cfg
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    heads = lm.tp is not None and lm.tp.heads
    hq = lm.tp.local_heads(cfg)[0] if lm.tp is not None else cfg.num_heads
    h = rms_norm(x, p["cross_norm"], cfg.norm_eps)
    if heads:
        h = lm.tp.copy(h)
    q = (h @ p["cross_wq"].to(h.dtype)).reshape(b, 1, hq, hd)
    src = (cfg.cross_attn if gated else cfg.encoder).source_len
    n = entry["ck"].shape[1]
    if n != src:  # this rank's source positions
        none = torch.zeros((b, n), dtype=torch.int32, device=x.device)
        o = lm.tp.combine(*decode_attention_partial(
            q, entry["ck"], entry["cv"], cache_positions=none, cur_pos=none[:, 0])).to(q.dtype)
    else:
        o = full_attention(q, entry["ck"], entry["cv"], causal=False, window=0)
    out = o.reshape(b, 1, hq * hd) @ p["cross_wo"].to(h.dtype)
    if heads:
        out = lm.tp.reduce(out)
    if gated:
        out = out * torch.tanh(p["cross_gate"].to(out.dtype))
    return x + out


def _mamba_decode(lm: LM, p, entry, x) -> torch.Tensor:
    """One Mamba-2 layer of a decode step; updates ``h`` and ``conv`` in place."""
    if lm.tp is not None and lm.tp.ssm_heads:
        return _tp_mamba_decode(lm, p, entry, x)
    cfg, s = lm.cfg, lm.cfg.ssm
    b = x.shape[0]
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    g, n = s.n_groups, s.d_state
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = (h @ p["in_proj"].to(h.dtype))[:, 0]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * g * n, nh], dim=-1)
    conv_new, xbc = conv_decode_step(
        entry["conv"], xbc, p["conv_w"].to(h.dtype), p["conv_b"].to(h.dtype)
    )
    xin, bmat, cmat = torch.split(xbc, [di, g * n, g * n], dim=-1)
    xin = xin.reshape(b, nh, s.head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())
    h_new, y = ssm_decode_step(entry["h"], xin, dt, a, bmat.reshape(b, g, n),
                               cmat.reshape(b, g, n))
    entry["h"].copy_(h_new)
    entry["conv"].copy_(conv_new)
    y = y + xin * p["d_skip"].to(y.dtype)[None, :, None]
    y = y.reshape(b, di) * F.silu(z)
    y = rms_norm(y, p["ssm_norm"], cfg.norm_eps)
    return x + (y @ p["out_proj"].to(y.dtype))[:, None]


def _tp_mamba_decode(lm: LM, p, entry, x) -> torch.Tensor:
    """One Mamba-2 layer of a decode step on the rank's SSM heads (as
    :meth:`LM._tp_mixer`): the token's pre-conv ``x|B|C`` and the conv
    window are all-gathered whole (the rank's ``conv`` entry is an even slice
    of the channels, not its heads'), convolved with the gathered ``conv_w``,
    and the rank's slice of the new window written back; the rank's heads
    of ``h`` step; ``out_proj``'s rows give a partial output, all-reduced."""
    tp, cfg, s = lm.tp, lm.cfg, lm.cfg.ssm
    b = x.shape[0]
    m, c = tp.size, tp.coord
    di, nh, n = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.d_state  # one group
    dil, nhl, gnl, w = di // m, nh // m, n // m, (di + 2 * n) // m
    h = tp.copy(rms_norm(x, p["norm"], cfg.norm_eps))
    zxbcdt = (h @ p["in_proj"].to(h.dtype))[:, 0]
    z, xbc, dt = torch.split(zxbcdt, [dil, dil + 2 * gnl, nhl], dim=-1)
    tok = torch.cat(tp.regroup(tp.all_gather(xbc, -1), (dil, gnl, gnl)), -1)
    conv_new, post = conv_decode_step(tp.all_gather(entry["conv"], -1), tok,
                                      p["conv_w"].to(h.dtype), p["conv_b"].to(h.dtype))
    entry["conv"].copy_(conv_new[..., c * w:(c + 1) * w])
    xin = post[:, c * dil:(c + 1) * dil].reshape(b, nhl, s.head_dim)
    bmat, cmat = post[:, di:di + n].reshape(b, 1, n), post[:, di + n:].reshape(b, 1, n)
    heads = slice(c * nhl, (c + 1) * nhl)
    dt = F.softplus(dt.float() + p["dt_bias"][heads])
    a = -torch.exp(p["a_log"][heads].float())
    h_new, y = ssm_decode_step(entry["h"], xin, dt, a, bmat, cmat)
    entry["h"].copy_(h_new)
    y = y + xin * p["d_skip"][heads].to(y.dtype)[None, :, None]
    y = y.reshape(b, dil) * F.silu(z)
    y = tp.rms_norm(y, p["ssm_norm"][c * dil:(c + 1) * dil], cfg.norm_eps, di)
    return x + tp.reduce(y @ p["out_proj"].to(y.dtype))[:, None]


def decode_step(lm: LM, params, cache: dict, tokens: torch.Tensor):
    """One decode step.  tokens [B,1] → (logits [B,1,V] float32, cache)."""
    cfg = lm.cfg
    pos = cache["pos"]
    x = lm.shard(_embed(lm, params, tokens, False), ("batch", "seq", "embed"))
    # the width each attention layer ropes: MLA ropes only the rope part of
    # a head (64 of deepseek-v2's 192), every other layer the whole head
    width = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.resolved_head_dim
    sin, cos = rotary_embedding(pos[:, None], width, cfg.rope_theta)
    rings = _ring_len(cache)
    for stage in lm.stages:
        for l in range(stage.count):
            for ld in stage.body:
                p = _layer(params[stage.name][ld.name], l)
                entry = _layer(cache[stage.name][ld.name], l)
                if ld.kind == "mamba":
                    x = _mamba_decode(lm, p, entry, x)
                elif ld.kind == "cross":
                    x = _cross_decode(lm, p, entry, x, gated=True)
                else:
                    x = _attn_decode(lm, ld, p, entry, x, pos, sin, cos, stage.window(ld, l),
                                     rings)
                    if ld.with_cross:
                        x = _cross_decode(lm, p, entry, x, gated=False)
                if ld.with_mlp:
                    x, _ = lm._mlp(p, x, moe=ld.moe)
    cache["pos"] = pos + 1
    return _logits(lm, params, x), cache


def prefill(lm: LM, params, cache: dict, tokens: torch.Tensor, *, source_embeds=None):
    """Run the forward pass over a prompt and populate the cache.

    tokens [B,S] → (logits of the last position [B,V] float32, cache).  Each
    attention layer's roped K/V (MLA: its latent and roped key head) go into
    its ring buffer (the trailing ``min(C, S)`` tokens); each Mamba-2 layer
    leaves its final SSM state and its last K-1 pre-conv rows; each
    cross-attention layer its K/V over the source (``source_embeds``; for
    encdec the encoder's output, encoded once here).  On CUDA every
    attention layer is one flash-attention launch (a cross-attention one at
    Sq != Skv, with no mask; each encoder layer one more), every Mamba-2
    layer one SSD-scan launch.
    """
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    sp = lm.tp is not None and lm.tp.decide_sp(b, s, lm.cfg.d_model)
    x = _embed(lm, params, tokens, sp)
    source = lm.source(params, source_embeds, sp=sp)
    rings = _ring_len(cache)
    for stage in lm.stages:
        for l in range(stage.count):
            for ld in stage.body:
                p = _layer(params[stage.name][ld.name], l)
                entry = cache[stage.name][ld.name]
                if ld.kind == "mamba":
                    x, (h_final, conv_tail) = lm._mamba(p, x, return_state=True, sp=sp)
                    entry["h"][l].copy_(h_final)
                    conv = entry["conv"][l]  # a prompt shorter than K-1 fills the tail
                    conv[:, conv.shape[1] - conv_tail.shape[1]:] = conv_tail
                elif ld.kind == "cross":
                    x, kv = lm._cross_attn(p, x, source, gated=True, sp=sp)
                    _write_source(lm, entry, l, kv)
                else:
                    x, kv = lm._self_attn(
                        p, x, window=stage.window(ld, l), positions=positions,
                        causal=ld.causal, sp=sp,
                    )
                    for name, t in zip(("c_kv", "k_rope") if lm.cfg.mla else ("k", "v"), kv):
                        _fill_ring(entry[name][l], t, s,
                                   *_slots(lm, ld, entry[name][l], rings))
                    sp_arr = entry["slot_pos"][l]
                    _fill_ring(sp_arr, positions.to(torch.int32).expand(b, s), s,
                               *_slots(lm, ld, sp_arr, rings))
                    if ld.with_cross:
                        x, kv = lm._cross_attn(p, x, source, gated=False, sp=sp)
                        _write_source(lm, entry, l, kv)
                if ld.with_mlp:
                    x, _ = lm._mlp(p, x, moe=ld.moe, sp=sp)
    cache["pos"] = cache["pos"] + s
    if sp:  # the last position is the last model rank's: gather the rows
        x = lm.tp.gather_seq(x)
    return _logits(lm, params, x[:, -1]), cache
