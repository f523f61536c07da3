"""Mamba-2 (SSD, state-space duality) blocks: chunked scan and decode step
(port of ``repro.models.ssm``).

Plain functions on tensors in the reference's layout and cast order:
x [B,S,H,P] (P = head dim), dt [B,S,H] float32, A [H] (negative), B/C
[B,S,G,N] (G groups broadcast over heads, N = state).  :func:`ssd_chunked`
is what the reference executes (intra-chunk masked products, a scan over
the chunk boundary states); :func:`ssd_recurrent` is the O(S) oracle.  On
the card, serving's prefill sends the scan to the hand-written kernel
(``repro_torch.kernels.ssd_scan``) instead; these stay the training path,
the CPU path and the kernel's plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_chunked", "ssd_recurrent", "ssm_decode_step", "causal_conv1d", "conv_decode_step"]


def _broadcast_groups(bc: torch.Tensor, heads: int) -> torch.Tensor:
    """[B,S,G,N] → [B,S,H,N] by repeating groups (head h reads group
    h // (H/G))."""
    b, s, g, n = bc.shape
    return bc[:, :, :, None, :].expand(b, s, g, heads // g, n).reshape(b, s, heads, n)


def ssd_recurrent(x, dt, a, bmat, cmat, *, h0=None):
    """Sequential oracle: h_t = exp(dt·A)·h_{t-1} + dt·B_t ⊗ x_t; y = C·h."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    bmat = _broadcast_groups(bmat, h)
    cmat = _broadcast_groups(cmat, h)
    da = dt * a[None, None, :]
    acc = torch.promote_types(x.dtype, torch.float32)  # float64 inputs stay float64
    hs = (torch.zeros((bsz, h, p, n), dtype=acc, device=x.device)
          if h0 is None else h0)
    ys = []
    for t in range(s):
        decay = torch.exp(da[:, t])[..., None, None]
        upd = (dt[:, t, :, None, None] * x[:, t, :, :, None]) * bmat[:, t, :, None, :]
        hs = hs * decay + upd.to(acc)
        ys.append(torch.einsum("bhpn,bhn->bhp", hs, cmat[:, t].to(acc)))
    return torch.stack(ys, 1).to(x.dtype), hs


def ssd_chunked(x, dt, a, bmat, cmat, *, chunk: int, h0=None):
    """Chunked SSD: intra-chunk masked products + inter-chunk state scan.
    Returns (y [B,S,H,P] in x's dtype, h_final [B,H,P,N] float32).

    The forward is the reference's bit for bit.  Its gradient differs where
    the reference's is NaN: the intra-chunk decay is masked before its
    ``exp`` (the reference masks after, so an overflow above the diagonal
    reaches the backward as 0 · inf); everywhere else the two agree."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    bmat = _broadcast_groups(bmat, h)
    cmat = _broadcast_groups(cmat, h)

    xq = x.reshape(bsz, nc, chunk, h, p)
    dtq = dt.reshape(bsz, nc, chunk, h)
    bq = bmat.reshape(bsz, nc, chunk, h, n).float()
    cq = cmat.reshape(bsz, nc, chunk, h, n).float()
    da = (dtq * a[None, None, None, :]).float()            # [B,nc,Q,H]

    cum = torch.cumsum(da, dim=2)                           # inclusive
    total = cum[:, :, -1, :]                                # [B,nc,H]

    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for i >= j, else 0.  The
    # reference takes exp of every entry and masks after; above the diagonal
    # seg is positive, exp overflows to inf there, and the backward of the
    # where multiplies its zero gradient by that inf: NaN.  The port masks
    # seg to -inf first, so exp is evaluated only where it is kept; kept
    # entries compute the same exp and masked ones are exactly 0 either way,
    # so the forward is bit-identical to the reference's form.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,nc,Q,Q,H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    l_mask = torch.exp(torch.where(tri[None, None, :, :, None], seg, -torch.inf))
    cb = torch.einsum("bcqhn,bckhn->bcqkh", cq, bq)
    xdt = xq.float() * dtq[..., None]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", cb * l_mask, xdt)

    # chunk boundary states: chunk c adds sum_j exp(total - cum_j) dt_j x_j B_j^T
    decay_to_end = torch.exp(total[:, :, None, :] - cum)    # [B,nc,Q,H]
    s_chunk = torch.einsum("bcqhp,bcqhn->bchpn", xdt * decay_to_end[..., None], bq)
    hprev = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * torch.exp(total[:, c])[:, :, None, None] + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, 1)                       # [B,nc,H,P,N]

    # inter-chunk: y += C_t · exp(cum_t) · h_prev
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", cq * torch.exp(cum)[..., None], h_prevs)
    y = (y_intra + y_inter).reshape(bsz, s, h, p).to(x.dtype)
    return y, hprev


def ssm_decode_step(h, xt, dtt, a, bt, ct):
    """Single-token state update.  h: [B,H,P,N]; xt: [B,H,P]; bt/ct: [B,G,N]."""
    heads = xt.shape[1]
    bt = _broadcast_groups(bt[:, None], heads)[:, 0]
    ct = _broadcast_groups(ct[:, None], heads)[:, 0]
    decay = torch.exp(dtt * a[None, :])[..., None, None]
    upd = (dtt[..., None, None] * xt[..., :, None]) * bt[:, :, None, :]
    h = h * decay + upd.float()
    y = torch.einsum("bhpn,bhn->bhp", h, ct.float())
    return h, y.to(xt.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: [B,S,D]; w: [D,K]; b: [D].  The K taps are
    summed one after another in x's dtype, as the reference does."""
    k = w.shape[-1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j : j + x.shape[1], :] * w[None, None, :, j]
    return F.silu(out + b[None, None, :])


def conv_decode_step(conv_state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor):
    """conv_state: [B,K-1,D] last inputs; xt: [B,D] → (new_state, out [B,D])."""
    window = torch.cat([conv_state, xt[:, None, :]], dim=1)      # [B,K,D]
    out = torch.einsum("bkd,dk->bd", window, w) + b[None, :]
    return window[:, 1:], F.silu(out)
