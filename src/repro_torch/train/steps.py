"""The train step (port of ``repro.train.steps.make_train_step``).

The step runs eagerly (there is no ``jit``): gradients by
``torch.autograd.grad`` of :meth:`LM.loss_fn`, then :func:`adamw_update`.
Gradient accumulation splits the batch ``[B, ...]`` into ``accum``
microbatches of ``B/accum`` and sums fp32 gradients, as the reference's
``lax.scan`` does.  ``cast_params_once`` casts the fp32 master to the
compute dtype once per microstep (a differentiable cast).
``grad_transform`` maps the gradient tree before the update, as in the
reference.

With ``group`` (a :class:`~repro_torch.dist.sharding.RankGroups`) the state
holds the rank's local shards and the batch is the rank's rows
(:func:`~repro_torch.dist.sharding.rank_rows`).  One step:

1. gather each parameter's full fp32 weights from the ranks' shards;
2. forward and backward on the rank's rows;
3. all-reduce the gradients over the data subgroup, divided by its size
   (the loss and ``aux`` are averaged the same way, so every rank reports
   the single-device value);
4. ``grad_transform``;
5. clip by the global norm of the full reduced gradient;
6. AdamW on the rank's moment regions of the weights and gradients; where
   the weights' layout is not the moments' (ZeRO-1 keeps the weights
   replicated over the data axes), the new weights are gathered from the
   regions' owners, so every replica is bit-identical.

The step's wall is split into those phases in ``step.split`` (seconds, and
the all-reduced bytes), timed after a device synchronize.

When the model computes partitioned over the model axis (``lm.tp``, a
:class:`~repro_torch.dist.tensor_parallel.TensorParallel`: every family
under tensor parallelism), step 1 gathers each weight over the data
subgroup only, into the rank's model-local tensor (FSDP's gather), and over
the model subgroup only the weights no rank computes from its shard
(attention's where its heads do not divide the model axis); step 2 computes
the rank's partition; the gradients come back model-local (a gathered
weight's cut to the rank's shard, a replicated weight's summed over the
model subgroup where its stream was split by rows or where each rank reads
it in part), the clip takes the norm of the model-local gradients with each
element counted once, and the update reads its moment regions out of the
model-local tensors.  The split
then adds ``tp_s`` and ``tp_bytes``, the model-subgroup collectives (inside
the forward and backward, the gradients' reduction after, and the norm's);
``grad_s`` is the forward and backward less the collectives inside them.
``grad_transform`` then sees the rank's model-local gradients.  With
tensor parallelism off and sequence parallelism on the same context
computes each stream's rows from replicated weights (a replicated weight's
gradient summed over the model subgroup where its stream was split).

Under a pipe axis over 1 (``lm.pipe``, a
:class:`~repro_torch.dist.pipeline.Pipeline`) step 1 keeps the rank's stage
of every stacked weight (its chunk of the layers, the data axes gathered;
over the model axis as above, or gathered); step 2 runs the rank's
segments of each microbatch forward, then backward in reverse, handing the
stream and its gradient to the neighbouring stages
(:meth:`~repro_torch.dist.pipeline.Pipeline.forward_backward`); the
stacked gradients are the stage's, the unstacked ones summed over the pipe
group; the clip's norm counts each element once; the update reads its
moment regions out of the stage-local tensors.  The split adds ``pipe_s``
and ``pipe_bytes`` (every pipe-group exchange), out of ``grad_s``.
With ``accum > 1`` the microbatches go through the stages one after
another, their gradients summed in the one-process order.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ParallelismConfig, TrainConfig
from repro_torch.core.patterns import StateKind
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
from repro_torch.models.lm import LM

from .optimizer import TrainState, adamw_update, global_norm

__all__ = ["make_train_step"]


def make_train_step(
    lm: LM,
    tcfg: TrainConfig,
    parallel: ParallelismConfig,
    *,
    grad_transform: Callable | None = None,
    group=None,
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
        if lm.pipe is not None:  # the rank's segments, forward and backward
            metrics = lm.pipe.forward_backward(tree, batch)
            grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                     for t in leaves.values()]
            return metrics, dict(zip(leaves, grads))
        loss, metrics = lm.loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return metrics, dict(zip(leaves, grads))

    def loss_and_grads(params: dict, batch: dict):
        if accum == 1:
            metrics, grads = value_and_grad(params, batch)
            return {k: v.detach() for k, v in metrics.items()}, grads
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                 for k, v in batch.items()}
        gsum: dict[str, torch.Tensor] = {}
        lsum = None
        for i in range(accum):
            metrics, g = value_and_grad(params, {k: v[i] for k, v in micro.items()})
            for n, gi in g.items():
                gsum[n] = gsum[n] + gi.float() if n in gsum else gi.float()
            # the reference sums the cross-entropy (its m["loss"]), not the total
            loss_i = metrics["loss"].detach()
            lsum = loss_i if lsum is None else lsum + loss_i
        loss = lsum / accum
        return ({"loss": loss, "aux": torch.zeros((), device=loss.device)},
                {n: g / accum for n, g in gsum.items()})

    if group is None:
        def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
            metrics, grads = loss_and_grads(state.params, batch)
            grads = unflatten_from_paths(grads)
            if grad_transform is not None:
                grads = grad_transform(grads)
            new_state, opt_metrics = adamw_update(state, grads, tcfg)
            return new_state, {**metrics, **opt_metrics}

        return train_step
    return _sharded_step(loss_and_grads, tcfg, grad_transform, group, lm.tp, lm.pipe)


def _sharded_step(loss_and_grads, tcfg: TrainConfig, grad_transform, rg, tp=None, pipe=None):
    from repro_torch.dist.sharding import gather_full, local_shard, relocal

    specs = rg.plan.param_specs
    mesh, rank = rg.mesh, rg.rank
    w_layout = {n: s.layout_for(StateKind.FP32, mesh) for n, s in specs.items()}
    m_layout = {n: s.layout_for(StateKind.EXP_AVG, mesh) for n, s in specs.items()}
    for n, s in specs.items():
        if s.states[StateKind.EXP_AVG_SQ].dims != s.states[StateKind.EXP_AVG].dims:
            raise NotImplementedError(f"{n}: the two moments are laid out differently")
    split: dict[str, float] = {}

    def clock(device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        local = flatten_with_paths(state.params)
        device = next(iter(local.values())).device
        t0 = clock(device)
        if pipe is not None:  # the stage's layers; over a model axis as tp computes
            full, comp = pipe.weights(local)
        elif tp is None:
            full = {n: gather_full(t, w_layout[n], rg.group) for n, t in local.items()}
            comp = full
        else:  # model-local weights; the gathered ones whole to compute from
            full, comp = tp.weights(local)
        for ctx in (tp, pipe):
            if ctx is not None:
                ctx.seconds, ctx.bytes = 0.0, 0
        t1 = clock(device)
        metrics, grads = loss_and_grads(unflatten_from_paths(comp), batch)
        del comp
        if pipe is not None:  # stacked padded back, unstacked summed over the pipe group
            grads = pipe.reduce_grads(grads)
        elif tp is not None:  # summed over the model group as the forward sharded the stream
            grads = tp.reduce_grads(grads)
        t2 = clock(device)
        inside = sum(ctx.seconds for ctx in (tp, pipe) if ctx is not None)
        reduced = 0
        if rg.data is not None:
            for g in grads.values():
                dist.all_reduce(g, group=rg.data)
                g.div_(rg.data_size)
                reduced += g.numel() * g.element_size()
            # loss and aux: the mean over the data group, as on one device
            la = torch.stack([metrics["loss"].float(), metrics["aux"].float()])
            dist.all_reduce(la, group=rg.data)
            la = la / rg.data_size
            metrics = {"loss": la[0], "aux": la[1]}
        t3 = clock(device)
        tree = unflatten_from_paths(grads)
        if grad_transform is not None:
            tree = grad_transform(tree)
        grads = flatten_with_paths(tree)
        if pipe is not None:
            gnorm = pipe.global_norm(grads)
            cut = lambda n, t: relocal(t, pipe.layouts[n], m_layout[n], rank)  # noqa: E731
        elif tp is None:
            gnorm = global_norm(tree)
            cut = lambda n, t: local_shard(t, m_layout[n], rank)  # noqa: E731
        else:
            gnorm = tp.global_norm(grads)
            cut = lambda n, t: tp.relayout(n, t, m_layout[n])  # noqa: E731
        del tree
        p_mom = {n: cut(n, full[n]) for n in local}
        g_mom = {n: cut(n, grads.pop(n)) for n in local}
        del full
        upd, opt_metrics = adamw_update(
            TrainState(unflatten_from_paths(p_mom), state.exp_avg, state.exp_avg_sq, state.step),
            unflatten_from_paths(g_mom), tcfg, gnorm=gnorm,
        )
        del p_mom, g_mom
        new_p = flatten_with_paths(upd.params)
        for n, t in new_p.items():
            if specs[n].states[StateKind.FP32].dims != specs[n].states[StateKind.EXP_AVG].dims:
                # ZeRO-1: the weights' shard spans several ranks' moment
                # regions; take each region from its owner
                new_p[n] = local_shard(gather_full(t, m_layout[n], rg.group), w_layout[n], rank)
        t4 = clock(device)
        split.clear()
        # grad_s: the forward and backward less the tp and pipe exchanges inside them
        split.update(gather_s=t1 - t0, grad_s=t2 - t1 - inside, all_reduce_s=t3 - t2,
                     all_reduce_bytes=reduced, update_s=t4 - t3)
        if tp is not None:
            split.update(tp_s=tp.seconds, tp_bytes=tp.bytes)
        if pipe is not None:
            split.update(pipe_s=pipe.seconds, pipe_bytes=pipe.bytes)
        new_state = TrainState(unflatten_from_paths(new_p), upd.exp_avg, upd.exp_avg_sq, upd.step)
        return new_state, {**metrics, **opt_metrics}

    train_step.split = split
    return train_step
