"""Trainer: model + optimizer + data + checkpointing on one explicit device
(port of ``repro.train.trainer``).

Without a group the logical model trains on one device, and the
:class:`ShardingPlan` built for the run's mesh sets the checkpoint geometry
only (which shards a save writes, and what a resume under another mesh must
reshard), as in serving.  On start-up the trainer asks the
:class:`CheckpointManager` for the newest committed checkpoint: DIRECT when
the layout is unchanged, RESHARD_STREAM when it changed; training continues
at the checkpointed step with the same global data order (the stateless
pipeline of :mod:`.data`).

Every family trains: dense, MoE (a MoE config's plan shards its expert
tensors by expert parallelism or by expert-TP, ``moe_mode``), Mamba-2, the
Mamba-2/attention/MoE hybrid, and the cross-attention families (vlm,
encdec), whose batches carry the stubbed frontend's ``source_embeds``
beside the tokens.
Each step's record carries the cross-entropy ``loss`` and the MoE ``aux``
loss (0 for a model without experts).

With ``group`` (an initialized ``torch.distributed`` group of the mesh's
size) the run is multi-rank: this process is rank ``dist.get_rank(group)``
of the mesh, holds only its shards of every state kind (its checkpoint
shards), and the ranks together take the single-device step (:mod:`.steps`);
the manager saves and restores the rank's shards alone (and, with the hot
tier, holds its own fragments and its buddies' mirrors).  What a rank
computes follows the mesh:

* the data axes: its rows of each global batch (the gradients averaged
  over the data subgroup);
* a model axis over 1, under tensor parallelism: its part of every layer
  by the plan's split of the weights, each stream's rows where sequence
  parallelism shards it (:class:`~repro_torch.dist.tensor_parallel.TensorParallel`,
  installed as ``lm.tp``: whisper's encoder and decoder streams each take
  their own decision); with tensor parallelism off and sequence
  parallelism on, each stream's rows from replicated weights (the same
  class); with both off, the whole model gathered over the model axis;
* a pipe axis over 1: only its stage's layers of every stack, the chunk of
  its checkpoint shard, handing the residual stream to the next stage and
  its gradient back (:class:`~repro_torch.dist.pipeline.Pipeline`,
  installed as ``lm.pipe``), each stage's model ranks computing as above.

A MoE layer routes one token group a sequence unless ``moe_groups`` says
otherwise, so capacity and the aux loss split over the data axes with the
batch rows; a ``moe_groups`` that does not divide by the data size is
refused.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.distributed as dist

import repro_torch.obs as obs
from repro_torch.ckpt.manager import CheckpointManager, RestoreInfo
from repro_torch.ckpt.policy import CheckpointPolicy
from repro_torch.configs.base import ModelConfig, ParallelismConfig, ShapeSpec, TrainConfig
from repro_torch.core.layout import MeshSpec, slice_shard
from repro_torch.core.patterns import StateKind
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
from repro_torch.dist.sharding import (
    RankGroups, ShardingPlan, batch_axes, gather_full, make_plan, rank_rows, vocab_multiple,
)
from repro_torch.dist.pipeline import Pipeline, pipelines
from repro_torch.dist.tensor_parallel import TensorParallel, partitions
from repro_torch.models import build_model
from repro_torch.models.lm import LM

from .data import batch_for_step
from .optimizer import TrainState, init_state
from .steps import make_train_step

__all__ = ["Trainer", "gather_state", "shard_state"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


_KINDS = (("params", StateKind.FP32), ("exp_avg", StateKind.EXP_AVG),
          ("exp_avg_sq", StateKind.EXP_AVG_SQ))


def shard_state(state: TrainState, plan: ShardingPlan, rank: int) -> TrainState:
    """Rank ``rank``'s local state: every tensor cut to the rank's
    checkpoint shard of its kind (``slice_shard``, padding zero)."""
    trees = {}
    for field, kind in _KINDS:
        flat = flatten_with_paths(getattr(state, field))
        trees[field] = unflatten_from_paths({
            n: slice_shard(t, plan.param_specs[n].layout_for(kind, plan.mesh), rank)
            for n, t in flat.items()
        })
    return TrainState(step=state.step, **trees)


def gather_state(state: TrainState, plan: ShardingPlan, group) -> TrainState:
    """The runtime-shaped state from every rank's local state (a collective
    over ``group``): :func:`~repro_torch.dist.sharding.gather_full` of each
    tensor."""
    trees = {}
    for field, kind in _KINDS:
        flat = flatten_with_paths(getattr(state, field))
        trees[field] = unflatten_from_paths({
            n: gather_full(t, plan.param_specs[n].layout_for(kind, plan.mesh), group)
            for n, t in flat.items()
        })
    return TrainState(step=state.step, **trees)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    parallel: ParallelismConfig
    tcfg: TrainConfig
    mesh: MeshSpec
    device: torch.device
    lm: LM
    plan: ShardingPlan
    manager: CheckpointManager | None
    step_fn: Callable
    batch_size: int
    seq_len: int
    data_seed: int
    # The rank's place in a multi-rank run (None: one device).
    ranks: RankGroups | None = None
    # What the saves of run() reported, oldest first.
    save_results: list = dataclasses.field(default_factory=list)

    @classmethod
    def create(
        cls,
        cfg: ModelConfig,
        parallel: ParallelismConfig,
        tcfg: TrainConfig,
        mesh: MeshSpec,
        *,
        batch_size: int,
        seq_len: int,
        ckpt_dir: str | None = None,
        policy: CheckpointPolicy | None = None,
        device: str | torch.device | None = None,
        group=None,
        grad_transform: Callable | None = None,
        moe_groups: int | None = None,
    ) -> "Trainer":
        """``device`` defaults to ``cuda``, and under ``group`` to
        ``cuda:(rank % device_count)``.  ``grad_transform`` maps the
        gradient tree before the update (the reference's hook).
        ``moe_groups``: the token groups a MoE layer routes over the global
        batch (the reference's ``LM.moe_groups``; None: one a sequence);
        under a group each rank routes its share of them."""
        if device is None:
            device = "cuda"
            if group is not None and torch.cuda.is_available():
                device = f"cuda:{dist.get_rank(group) % torch.cuda.device_count()}"
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but is not available (pass device='cpu')")
        dsize = 1
        if group is not None:
            dsize = math.prod(mesh.axis_size(a) for a in batch_axes(parallel, mesh))
            if moe_groups is not None and moe_groups % dsize:
                raise ValueError(f"moe_groups {moe_groups} does not split over the data size "
                                 f"{dsize}")
        lm = build_model(
            cfg,
            vocab_multiple=vocab_multiple(parallel, mesh),
            compute_dtype=_DTYPES[parallel.compute_dtype],
            remat=parallel.remat,
            moe_groups=None if moe_groups is None else moe_groups // dsize,
        )
        plan = make_plan(cfg, lm.registry, parallel, mesh)
        ranks = None
        if group is not None:
            ranks = RankGroups.create(group, plan, parallel)
            if partitions(cfg, parallel, mesh):
                lm.tp = TensorParallel(ranks, cfg)
            if pipelines(parallel, mesh):
                lm.pipe = Pipeline(ranks, lm)
        manager = (
            CheckpointManager(
                ckpt_dir, plan, policy=policy,
                config_fingerprint={
                    "model": cfg.fingerprint(), "parallel": parallel.fingerprint(),
                },
                group=group,
            )
            if ckpt_dir
            else None
        )
        return cls(
            cfg=cfg, parallel=parallel, tcfg=tcfg, mesh=mesh, device=device, lm=lm,
            plan=plan, manager=manager,
            step_fn=make_train_step(lm, tcfg, parallel, grad_transform=grad_transform,
                                    group=ranks),
            batch_size=batch_size, seq_len=seq_len, data_seed=tcfg.seed, ranks=ranks,
        )

    def init_state(self) -> TrainState:
        """Fresh weights from a generator on the device seeded with the run's
        seed, zero moments in ``moment_dtype``.  Under a group the full
        weights are drawn on every rank (mesh-invariant) and the rank keeps
        its shards."""
        params = self.lm.init(torch.Generator(device=self.device).manual_seed(self.tcfg.seed))
        mdt = _DTYPES[self.parallel.moment_dtype]
        if self.ranks is None:
            return init_state(params, moment_dtype=mdt)
        rank, mesh, specs = self.ranks.rank, self.mesh, self.plan.param_specs
        flat = flatten_with_paths(params)
        del params
        local = {}
        for n in list(flat):
            local[n] = slice_shard(flat.pop(n), specs[n].layout_for(StateKind.FP32, mesh), rank)
        zeros = {
            n: torch.zeros(specs[n].layout_for(StateKind.EXP_AVG, mesh).local_shape, dtype=mdt,
                           device=self.device)
            for n in local
        }
        return TrainState(unflatten_from_paths(local), unflatten_from_paths(zeros),
                          unflatten_from_paths({n: z.clone() for n, z in zeros.items()}), 0)

    def init_or_restore(self) -> tuple[TrainState, RestoreInfo | None]:
        if self.manager is not None:
            res = self.manager.restore_latest(self.device)
            if res is not None:
                return res
        return self.init_state(), None

    def batch(self, step: int) -> dict:
        shape = ShapeSpec("train", self.seq_len, self.batch_size, "train")
        full = batch_for_step(
            self.cfg, shape, step, seed=self.data_seed,
            batch_override=self.batch_size, seq_override=self.seq_len,
        )
        keys = [k for k in ("tokens", "source_embeds") if k in full]  # vlm and encdec: embeddings
        if self.ranks is not None:
            sl = rank_rows(self.batch_size, self.parallel, self.mesh, self.ranks.rank)
            full = {k: full[k][sl] for k in keys}
        out = {"tokens": torch.from_numpy(full["tokens"]).long().to(self.device)}
        if "source_embeds" in keys:  # the stubbed frontend's embeddings
            out["source_embeds"] = torch.from_numpy(full["source_embeds"]).to(self.device)
        return out

    def run(
        self,
        state: TrainState,
        start_step: int,
        num_steps: int,
        *,
        log: Callable[[dict], None] | None = None,
    ) -> tuple[TrainState, list[dict[str, Any]]]:
        history: list[dict[str, Any]] = []
        for step in range(start_step, start_step + num_steps):
            batch = self.batch(step)
            with obs.timed("train.step", step=step + 1) as sw:
                state, metrics = self.step_fn(state, batch)
                _sync(self.device)
            rec = {
                "step": step + 1,
                "loss": float(metrics["loss"]),
                "aux": float(metrics["aux"]),
                "grad_norm": float(metrics["grad_norm"]),
                "lr": float(metrics["lr"]),
                "dt": sw.elapsed_s,
            }
            if self.ranks is not None:
                rec["split"] = dict(self.step_fn.split)
            history.append(rec)
            if log:
                log(rec)
            if self.manager is not None and self.manager.should_save(step + 1):
                self.manager.save(state, step + 1)
        if self.manager is not None:
            self.save_results += self.manager.wait()
        return state, history
