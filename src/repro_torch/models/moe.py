"""Mixture-of-Experts with capacity-based, gather/scatter dispatch
(port of ``repro.models.moe``).

Tokens are grouped ``[G, T, d]`` (``G = B`` unless ``groups`` says
otherwise), routed top-k over ``E`` experts, and given slots by a
per-group cumsum over the one-hot routing mask, token-major then k-slot:
a token keeps its slot by its position, never by its gate.  Slots at or
beyond the capacity ``C`` are dropped into a sink slot ``E·C`` that is
sliced off.  Tokens move by gather, and only int32 token indices are
scattered (into the slot table), as in the reference.

The steps are plain functions on tensors, differentiable through autograd:
:func:`route` (router logits in the compute dtype, softmax in float32, a
*stable* top-k — on equal probabilities the lower expert index comes first,
as ``jax.lax.top_k`` orders them; ``torch.topk`` promises no order),
:func:`assign_slots`, :func:`dispatch`, :func:`experts` (three batched
matrix products over the expert dim, ``torch.bmm``), :func:`combine` and
:func:`aux_loss` (Switch/GShard load balancing from the one-hot *before*
the capacity drop).  The JAX package runs no Pallas kernel here, so
neither does the port.

Under expert parallelism a rank holds the weights of experts ``[lo, hi)``
only (``moe_block(..., owned=(lo, hi))``): it routes every token as one
process does, then dispatches and combines only its experts' slots, so its
output is its experts' share of the sum (the row-parallel reduce of
:mod:`repro_torch.dist.tensor_parallel` adds the shares).  Under expert-TP
it holds a slice of every expert's width and calls ``moe_block`` as one
process does: the products over that slice give a partial output the same
way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

__all__ = [
    "moe_block",
    "capacity_per_group",
    "route",
    "assign_slots",
    "dispatch",
    "experts",
    "combine",
    "aux_loss",
]


def capacity_per_group(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(c, 1)


def route(xg: torch.Tensor, router_w: torch.Tensor, k: int):
    """xg [g,t,d] → (probs [g,t,e] float32, gate_k [g,t,k] normalised over
    k, idx_k [g,t,k] int64): the k largest probabilities in descending
    order, ties broken towards the lower expert index."""
    logits = xg @ router_w.to(xg.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_all, idx_all = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_all[..., :k], idx_all[..., :k]
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_k, idx_k


def assign_slots(idx_k: torch.Tensor, e: int, c: int):
    """Group-local slots: (slot [g,t,k] int64 — ``expert·c + pos`` when
    kept, the sink ``e·c`` when dropped — keep [g,t,k] bool, the int32
    one-hot [g,t,k,e] before the drop)."""
    g, t, k = idx_k.shape
    oh = F.one_hot(idx_k, e).to(torch.int32)                 # [g,t,k,e]
    ohf = oh.reshape(g, t * k, e)
    pos = torch.cumsum(ohf, dim=1) - 1                       # 0-based slot
    pos = (pos * ohf).sum(-1).reshape(g, t, k)
    keep = pos < c
    slot = torch.where(keep, idx_k * c + pos, torch.full_like(pos, e * c))
    return slot, keep, oh


def dispatch(xg: torch.Tensor, slot: torch.Tensor, e: int, c: int) -> torch.Tensor:
    """The expert buffer [g,e,c,d]: the int32 token index of every slot is
    scattered into the slot table (empty slots and the sink point at a zero
    row past the tokens), then the rows are gathered."""
    g, t, d = xg.shape
    k = slot.shape[-1]
    table = torch.full((g, e * c + 1), t, dtype=torch.int32, device=xg.device)
    tok = torch.arange(t, dtype=torch.int32, device=xg.device)[None, :, None].expand(g, t, k)
    table.scatter_(1, slot.reshape(g, t * k), tok.reshape(g, t * k))
    table = table[:, : e * c].long()                         # the sink is sliced off
    xg_pad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1)
    buf = torch.gather(xg_pad, 1, table[..., None].expand(g, e * c, d))
    return buf.reshape(g, e, c, d)


def experts(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU experts on buf [g,e,c,d] in its dtype: w_gate/w_up [e,d,f],
    w_down [e,f,d] (``gecd,edf->gecf``, as batched products over e)."""
    g, e, c, d = buf.shape
    cd = buf.dtype
    xe = buf.permute(1, 0, 2, 3).reshape(e, g * c, d)
    gate = torch.bmm(xe, w_gate.to(cd))
    up = torch.bmm(xe, w_up.to(cd))
    y = torch.bmm(F.silu(gate) * up, w_down.to(cd))
    return y.reshape(e, g, c, d).permute(1, 0, 2, 3)


def combine(y: torch.Tensor, slot: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each token's k slots gathered back from y [g,e,c,d] and summed with
    ``weights`` [g,t,k] (zero where dropped): out [g,t,d]."""
    g, e, c, d = y.shape
    t, k = slot.shape[1], slot.shape[2]
    yf = torch.cat([y.reshape(g, e * c, d), y.new_zeros(g, 1, d)], dim=1)
    y_tok = torch.gather(yf, 1, slot.reshape(g, t * k, 1).expand(g, t * k, d))
    y_tok = y_tok.reshape(g * t, k, d)
    w = weights.to(y.dtype).reshape(g * t, 1, k)
    return torch.bmm(w, y_tok).reshape(g, t, d)


def aux_loss(oh: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Load-balancing loss from the routing one-hot before the drop and the
    mean router probabilities: ``e · mean_g Σ_e frac_tokens · frac_prob``."""
    _, t, k, e = oh.shape
    frac_tokens = oh.float().sum((1, 2)) / (t * k)           # [g,e]
    frac_prob = probs.mean(1)                                # [g,e]
    return e * torch.mean(torch.sum(frac_tokens * frac_prob, dim=-1))


def moe_block(
    x: torch.Tensor,
    router_w: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    cfg: MoEConfig,
    *,
    groups: int | None = None,
    owned: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed SwiGLU experts.

    x [B,S,d]; router_w [d,E]; w_gate/w_up [E,d,f]; w_down [E,f,d], or with
    ``owned = (lo, hi)`` the weights of experts ``[lo, hi)`` only, whose
    slots alone are dispatched and combined (every other slot reads the
    sink's zero row).
    Returns (out [B,S,d] in x's dtype, the aux loss as a float32 scalar)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g = groups or b
    n = b * s
    if n % g:
        raise ValueError(f"tokens {n} not divisible by groups {g}")
    t = n // g
    c = capacity_per_group(t, cfg)

    xg = x.reshape(g, t, d)
    probs, gate_k, idx_k = route(xg, router_w, k)
    slot, keep, oh = assign_slots(idx_k, e, c)
    held = e
    if owned is not None:
        lo, hi = owned
        held = hi - lo
        mine = (slot >= lo * c) & (slot < hi * c)
        slot = torch.where(mine, slot - lo * c, torch.full_like(slot, held * c))
    y = experts(dispatch(xg, slot, held, c), w_gate, w_up, w_down)
    out = combine(y, slot, gate_k * keep)
    return out.reshape(b, s, d), aux_loss(oh, probs).float()
