"""AdamW with fp32 master weights — the state UCP checkpoints
(port of ``repro.train.optimizer``).

The optimizer state is the paper's atom triple: fp32 master weights, first
moment (``exp_avg``), second moment (``exp_avg_sq``).  Moments are stored
in ``moment_dtype``; the math runs in fp32 and casts back on store.

The update is the reference's formula, not ``torch.optim.AdamW`` (whose
decay and eps placement round differently): clip by the global norm, then
the moments, then ``(m/c1)/(sqrt(v/c2)+eps)``, then weight decay on
``ndim ≥ 2`` added to the update, then ``p - lr·u``.  It is functional: it
returns new tensors and leaves the old state intact, so an asynchronous
save may hold the old state while training goes on.  The scalars (step, lr,
bias corrections) are fp32 tensors on the parameters' device, so every
division is a true division there.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths

__all__ = ["TrainState", "init_state", "adamw_update", "lr_schedule", "global_norm"]


@dataclasses.dataclass
class TrainState:
    """Nested dicts of tensors (params and both moments) and the step."""

    params: dict
    exp_avg: dict
    exp_avg_sq: dict
    step: int


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_state(params: dict, moment_dtype=torch.float32) -> TrainState:
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    return TrainState(params, _map(zeros, params), _map(zeros, params), 0)


def lr_schedule(cfg: TrainConfig, step: int) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in fp32 (CPU)."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * scale


def global_norm(tree) -> torch.Tensor:
    leaves = [g.float().square().sum() for g in flatten_with_paths(tree).values()]
    return torch.sqrt(sum(leaves))


def adamw_update(
    state: TrainState, grads: dict, cfg: TrainConfig, *, gnorm: torch.Tensor | None = None,
) -> tuple[TrainState, dict]:
    """One AdamW step (grad clip → moments → bias-corrected update → decay).

    ``gnorm``: the global gradient norm to clip by, when ``grads`` are one
    rank's regions of the full gradient (default: the norm of ``grads``).
    Returns the new state and ``{"grad_norm", "lr"}`` as 0-d fp32 tensors."""
    params = flatten_with_paths(state.params)
    g_flat = flatten_with_paths(grads)
    device = next(iter(params.values())).device
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=device)
    clip = torch.minimum(one, cfg.grad_clip * one / torch.clamp(gnorm, min=1e-9))
    lr = lr_schedule(cfg, step)
    b1, b2, eps = cfg.adam_b1, cfg.adam_b2, 1e-8
    s = torch.tensor(float(step), dtype=torch.float32)
    c1 = (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), s)).to(device)
    c2 = (1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), s)).to(device)
    lr_d = lr.to(device)
    m_flat = flatten_with_paths(state.exp_avg)
    v_flat = flatten_with_paths(state.exp_avg_sq)
    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        # Each temporary is dropped as soon as it is spent: a parameter's fp32
        # temporaries are GBs at full width, and the previous parameter's
        # would otherwise live on into the next (without this, a full-width
        # mixtral-8x22b layer's step ran out of an 80 GB H100's memory).
        m, v = m_flat[name], v_flat[name]
        g = g_flat[name].float() * clip
        mf = m.float() * b1 + (1 - b1) * g
        vf = v.float() * b2 + (1 - b2) * g.square()
        del g
        u = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        new_m[name] = mf.to(m.dtype)
        new_v[name] = vf.to(v.dtype)
        del mf, vf
        if p.dim() >= 2:  # no weight decay on norms/scalars
            u = u + cfg.weight_decay * p.float()
        new_p[name] = (p.float() - lr_d * u).to(p.dtype)
        del u
    new_state = TrainState(
        unflatten_from_paths(new_p), unflatten_from_paths(new_m),
        unflatten_from_paths(new_v), step,
    )
    return new_state, {"grad_norm": gnorm, "lr": lr}
