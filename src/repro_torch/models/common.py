"""Shared model substrate: parameter registry, norms, rotary, MLP
(port of ``repro.models.common``).

Models declare their parameters as :class:`ParamDef` tables with *logical
axis names* per dimension (``embed``, ``heads``, ``vocab``, ...).  The
sharding rule table (``repro_torch.dist.sharding``) maps logical axes to
mesh axes and derives every parameter's UCP
:class:`~repro_torch.core.patterns.ParamSpec` from the same table, so the
names and shapes here must equal the reference's for checkpoints to
interchange.

The building blocks are plain functions on tensors in the reference's
layout (``[B, S, H, D]``) and with its cast order, so both packages compute
the same numbers from the same weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths

__all__ = [
    "ParamDef",
    "ParamRegistry",
    "rms_norm",
    "rotary_embedding",
    "apply_rope",
    "swiglu",
]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one (possibly layer-stacked) parameter tensor.

    ``shape``      logical shape (stacked scan dim first when ``stacked``)
    ``axes``       logical axis name per dim (layers | embed | vocab | heads |
                   qkv_fused | mlp | ...); the sharding rule table maps these
                   to mesh axes
    ``parts``      named sub-fragment sizes along ``parts_dim`` (fused dims)
    ``init``       normal | zeros | ones | ssm_dt | ssm_alog
    ``fan_in_dim`` dimension whose size scales normal init (1/sqrt(fan_in))
    ``keep_fp32``  the model reads it in float32 whatever the compute dtype
                   (Mamba's ``a_log``/``dt_bias``: a bf16 copy would round
                   A = -exp(a_log) by up to ~0.4% and dt by ~1%)
    """

    path: str
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    init: str = "normal"
    fan_in_dim: int | None = None
    parts: tuple[tuple[str, int], ...] | None = None
    parts_dim: int | None = None
    kind: str = "dense"
    stacked: bool = False
    keep_fp32: bool = False

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"{self.path}: shape/axes rank mismatch")
        if self.parts is not None:
            if self.parts_dim is None:
                raise ValueError(f"{self.path}: parts without parts_dim")
            total = sum(s for _, s in self.parts)
            if total != self.shape[self.parts_dim]:
                raise ValueError(
                    f"{self.path}: parts sum {total} != dim {self.shape[self.parts_dim]}"
                )

    @property
    def stacked_dim(self) -> int | None:
        return 0 if self.stacked else None


class ParamRegistry:
    """Ordered collection of ParamDefs with initialization."""

    def __init__(self, defs: Sequence[ParamDef]):
        self.defs: dict[str, ParamDef] = {}
        for d in defs:
            if d.path in self.defs:
                raise ValueError(f"duplicate param {d.path}")
            self.defs[d.path] = d

    def __iter__(self):
        return iter(self.defs.values())

    def __getitem__(self, path: str) -> ParamDef:
        return self.defs[path]

    def num_params(self) -> int:
        return sum(math.prod(d.shape) for d in self.defs.values())

    def init(
        self, generator: torch.Generator, *, dtype=torch.float32, device=None
    ) -> dict:
        """Nested params, drawn in registry order from ``generator`` on its
        device (``device`` defaults to the generator's).  The numbers differ
        from the reference's ``jax.random`` draws; tests that compare the
        two packages load one set of weights into both instead."""
        device = torch.device(device) if device is not None else generator.device
        return unflatten_from_paths(
            {d.path: _init_leaf(generator, d, dtype, device) for d in self.defs.values()}
        )

    def cast(self, tree: dict, dtype) -> dict:
        """The once-per-load cast of fp32 master weights (nested) to the
        compute dtype; the leaves declared ``keep_fp32`` stay float32.  The
        reference reads every other leaf in the compute dtype (weights
        through ``.astype(h.dtype)``, norm scales through ``rms_norm``'s
        cast; MLA's ``q_norm``/``kv_norm`` and projections included), so
        casting them once gives its numbers."""
        return unflatten_from_paths({
            n: t if self.defs[n].keep_fp32 else t.to(dtype)
            for n, t in flatten_with_paths(tree).items()
        })


def _init_leaf(g: torch.Generator, d: ParamDef, dtype, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "ssm_dt":
        # dt bias such that softplus(dt) spans ~[1e-3, 1e-1] (Mamba init)
        u = torch.rand(d.shape, generator=g, dtype=torch.float32, device=device)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # inverse softplus
    if d.init == "ssm_alog":
        # log(1..H) in float32 through numpy, whose log gives XLA's bits for
        # the head counts of the ported configs (8 reduced, 24 full); torch's
        # CPU log differs in the last bit at log(7).  Neither matches XLA's
        # (not correctly rounded) log for every H: 5 of 1..256 differ.
        a = torch.from_numpy(np.log(np.arange(1, d.shape[-1] + 1, dtype=np.float32)))
        return a.expand(d.shape).to(device=device, dtype=dtype)
    if d.init != "normal":
        raise ValueError(f"{d.path}: unknown init {d.init!r}")
    fan_in = d.shape[d.fan_in_dim] if d.fan_in_dim is not None else d.shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=g, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# NN building blocks (plain functions, dtype-polymorphic)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Cast order of the reference: ``(xf·rsqrt(mean(xf²)+eps)).to(dt) * scale.to(dt)``."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def rotary_embedding(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape [..., head_dim/2] in float32 for ``positions``."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half
    )
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Half-split rope (not interleaved).  x: [..., seq, heads, head_dim];
    sin/cos: [..., seq, head_dim/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s = sin[..., None, :].to(x.dtype)
    c = cos[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    return (F.silu(g) * u) @ w_down.to(x.dtype)
