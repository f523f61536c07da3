"""The train step (port of ``repro.train.steps.make_train_step``), and the
serving steps (``make_serve_step``, ``make_prefill_step``: thin wrappers
over :mod:`repro_torch.models.decode`, as the reference's).

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
(:func:`~repro_torch.dist.sharding.rank_rows`).  The model computes from
those shards: ``make_train_step`` installs a
:class:`~repro_torch.dist.sharding.WeightGather` as ``LM.fsdp``, and each
weight is gathered where a layer reads it, as the reference's compiled step
gathers each layer's FSDP shard inside its layer scan.  One step:

1. forward and backward on the rank's rows: each layer's weights all-gathered
   over the data subgroup into the rank's model-local tensors inside the
   function that remat checkpoints (so a recomputed layer gathers them
   again and no layer's stay gathered; an unstacked weight where it is
   read); each read's backward all-reduces the model-local gradient over the
   data subgroup, divides it by its size and keeps the rank's shard of it,
   so the gradients come back at the size of the shards and the
   microbatches' sum is of shards (the loss and ``aux`` are averaged over
   the data subgroup, so every rank reports the single-device value);
2. ``grad_transform``;
3. clip by the global norm of the reduced gradient, each element counted
   once over the data, model and pipe shards
   (:func:`~repro_torch.dist.sharding.shard_norm`);
4. AdamW on the rank's moment regions of its weight and gradient shards
   (under FSDP the shards themselves); where the weights' layout is not
   the moments' (ZeRO-1 keeps the weights replicated over the data axes),
   the new weights are gathered from the regions' owners, so every replica
   is bit-identical.

The one weight gathered otherwise is a stack whose layers dim carries the
data axes (a small mesh's plan may put them there): whole over the data
axes once a forward, before its layers are split.

The step's wall is split into those phases in ``step.split``, timed after a
device synchronize: ``gather_s`` and ``gather_bytes`` (every weight gather,
the recomputes' too, timed inside them), ``all_reduce_s`` and
``all_reduce_bytes`` (the gradients' data all-reduces inside the backward,
and the loss's after), ``grad_s`` (the forward and backward less the
exchanges inside them) and ``update_s``.

When the model computes partitioned over the model axis (``lm.tp``, a
:class:`~repro_torch.dist.tensor_parallel.TensorParallel`: every family
under tensor parallelism), a read gathers over the data subgroup into the
rank's model-local tensor, and over the model subgroup too for the weights
no rank computes from its shard (attention's where its heads do not divide
the model axis; their backward sums over the model subgroup where the
gradient is partial and cuts the rank's part); the rank computes its
partition; a replicated weight's gradient is summed over the model subgroup
where its stream was split by rows or where each rank reads it in part.
The split then adds ``tp_s`` and ``tp_bytes``, the model-subgroup
collectives (inside the forward and backward, the gradients' reduction
after, and the norm's), out of ``grad_s``.  ``grad_transform`` sees the
rank's gradient shards.  With tensor parallelism off and sequence
parallelism on the same context computes each stream's rows from
replicated weights.  Without a partitioned computation, every weight the
model axis splits is gathered over the model subgroup too.

Under a pipe axis over 1 (``lm.pipe``, a
:class:`~repro_torch.dist.pipeline.Pipeline`) the model reads the rank's
stage of every stacked weight (its chunk of the layers); the rank runs its
segments of each microbatch forward, then backward in reverse, handing the
stream and its gradient to the neighbouring stages
(:meth:`~repro_torch.dist.pipeline.Pipeline.forward_backward`); the
unstacked gradients are summed over the pipe group.  The split adds
``pipe_s`` and ``pipe_bytes`` (every pipe-group exchange), out of
``grad_s``.  With ``accum > 1`` the microbatches go through the stages one
after another, their gradients summed in the one-process order.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ParallelismConfig, TrainConfig
from repro_torch.core.patterns import StateKind
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
from repro_torch.models import decode as decode_lib
from repro_torch.models.lm import LM

from .optimizer import TrainState, adamw_update

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step"]


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
    return _sharded_step(loss_and_grads, tcfg, grad_transform, group, lm)


def _sharded_step(loss_and_grads, tcfg: TrainConfig, grad_transform, rg, lm: LM):
    from repro_torch.dist.sharding import (
        WeightGather, gather_full, local_shard, relocal, shard_norm,
    )

    tp, pipe = lm.tp, lm.pipe
    specs = rg.plan.param_specs
    mesh, rank = rg.mesh, rg.rank
    w_layout = {n: s.layout_for(StateKind.FP32, mesh) for n, s in specs.items()}
    m_layout = {n: s.layout_for(StateKind.EXP_AVG, mesh) for n, s in specs.items()}
    for n, s in specs.items():
        if s.states[StateKind.EXP_AVG_SQ].dims != s.states[StateKind.EXP_AVG].dims:
            raise NotImplementedError(f"{n}: the two moments are laid out differently")
    fsdp = lm.fsdp = WeightGather(rg, tp, pipe)
    split: dict[str, float] = {}

    def clock(device) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        local = flatten_with_paths(state.params)
        device = next(iter(local.values())).device
        fsdp.reset()
        for ctx in (tp, pipe):
            if ctx is not None:
                ctx.seconds, ctx.bytes = 0.0, 0
        t0 = clock(device)
        # the shards themselves (a stage's cut to its layers): the model
        # gathers each layer's weights where it reads them
        comp = local if pipe is None else pipe.weights(local)[1]
        metrics, grads = loss_and_grads(unflatten_from_paths(comp), batch)
        del comp
        t1 = clock(device)
        reduced = 0
        if rg.data is not None:
            for n, g in grads.items():
                if n in fsdp.seen:  # reduced over data in the backward of its reads
                    continue
                # read by no layer of this rank (another pipeline stage's)
                dist.all_reduce(g, group=rg.data)
                g.div_(rg.data_size)
                reduced += g.numel() * g.element_size()
        t2 = clock(device)
        if pipe is not None:  # stacked padded back, unstacked summed over the pipe group
            grads = pipe.reduce_grads(grads)
        elif tp is not None:  # summed over the model group as the forward sharded the stream
            grads = tp.reduce_grads(grads)
        t3 = clock(device)
        inside = (sum(ctx.seconds for ctx in (tp, pipe) if ctx is not None)
                  + fsdp.gather_s + fsdp.reduce_s)
        if rg.data is not None:
            # loss and aux: the mean over the data group, as on one device
            la = torch.stack([metrics["loss"].float(), metrics["aux"].float()])
            dist.all_reduce(la, group=rg.data)
            la = la / rg.data_size
            metrics = {"loss": la[0], "aux": la[1]}
        t4 = clock(device)
        tree = unflatten_from_paths(grads)
        if grad_transform is not None:
            tree = grad_transform(tree)
        grads = flatten_with_paths(tree)
        del tree
        # each element once; the model and pipe groups' sums timed by their contexts
        gnorm = shard_norm(grads, rg, model_sum=tp.all_reduce if tp is not None else None,
                           pipe_sum=pipe.all_reduce if pipe is not None else None)
        # the shards cut to the moment regions (under FSDP the shards themselves)
        p_mom = {n: relocal(t, w_layout[n], m_layout[n], rank) for n, t in local.items()}
        g_mom = {n: relocal(grads.pop(n), w_layout[n], m_layout[n], rank) for n in local}
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
        t5 = clock(device)
        split.clear()
        # grad_s: the forward and backward (and the tp and pipe sums after
        # them) less the exchanges inside them
        split.update(gather_s=fsdp.gather_s, gather_bytes=fsdp.gather_bytes,
                     grad_s=t1 - t0 + t3 - t2 - inside,
                     all_reduce_s=fsdp.reduce_s + t2 - t1 + t4 - t3,
                     all_reduce_bytes=fsdp.reduce_bytes + reduced, update_s=t5 - t4)
        if tp is not None:
            split.update(tp_s=tp.seconds, tp_bytes=tp.bytes)
        if pipe is not None:
            split.update(pipe_s=pipe.seconds, pipe_bytes=pipe.bytes)
        new_state = TrainState(unflatten_from_paths(new_p), upd.exp_avg, upd.exp_avg_sq, upd.step)
        return new_state, {**metrics, **opt_metrics}

    train_step.split = split
    return train_step


def make_serve_step(lm: LM) -> Callable:
    """One-token decode: (params, cache, tokens[B,1]) → (logits, cache)."""

    def serve_step(params, cache, tokens):
        return decode_lib.decode_step(lm, params, cache, tokens)

    return serve_step


def make_prefill_step(lm: LM) -> Callable:
    """(params, cache, tokens[B,S], source_embeds=None) → (logits, cache)."""

    def prefill_step(params, cache, tokens, source_embeds=None):
        return decode_lib.prefill(lm, params, cache, tokens, source_embeds=source_embeds)

    return prefill_step
