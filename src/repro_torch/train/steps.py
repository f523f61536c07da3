"""The train step (port of ``repro.train.steps.make_train_step``).

The step runs eagerly (there is no ``jit``): gradients by
``torch.autograd.grad`` of :meth:`LM.loss_fn`, then :func:`adamw_update`.
Gradient accumulation splits the global batch ``[B, ...]`` into ``accum``
microbatches of ``B/accum`` and sums fp32 gradients, as the reference's
``lax.scan`` does.  ``cast_params_once`` casts the fp32 master to the
compute dtype once per microstep (a differentiable cast).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ParallelismConfig, TrainConfig
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
from repro_torch.models.lm import LM

from .optimizer import TrainState, adamw_update

__all__ = ["make_train_step"]


def make_train_step(
    lm: LM,
    tcfg: TrainConfig,
    parallel: ParallelismConfig,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    accum = max(parallel.grad_accum, 1)

    def value_and_grad(params: dict, batch: dict):
        leaves = {n: t.detach().requires_grad_(True) for n, t in flatten_with_paths(params).items()}
        tree = unflatten_from_paths(leaves)
        if parallel.cast_params_once:
            # One explicit working copy in the compute dtype.
            tree = unflatten_from_paths({
                n: t.to(lm.compute_dtype) if t.dtype == torch.float32 else t
                for n, t in leaves.items()
            })
        loss, metrics = lm.loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), metrics, dict(zip(leaves, grads))

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if accum == 1:
            loss, metrics, grads = value_and_grad(state.params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            gsum: dict[str, torch.Tensor] = {}
            lsum = None
            for i in range(accum):
                loss_i, _, g = value_and_grad(state.params, {k: v[i] for k, v in micro.items()})
                for n, gi in g.items():
                    gsum[n] = gsum[n] + gi.float() if n in gsum else gi.float()
                lsum = loss_i if lsum is None else lsum + loss_i
            grads = {n: g / accum for n, g in gsum.items()}
            loss = lsum / accum
            metrics = {"loss": loss, "aux": torch.zeros((), device=loss.device)}
        new_state, opt_metrics = adamw_update(state, unflatten_from_paths(grads), tcfg)
        return new_state, {**metrics, **opt_metrics}

    return train_step
