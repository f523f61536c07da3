"""Trainer: model + optimizer + data + checkpointing on one explicit device
(port of ``repro.train.trainer``).

The logical model trains on one device.  The :class:`ShardingPlan` built
for the run's mesh sets the checkpoint geometry only (which shards a save
writes, and what a resume under another mesh must reshard), as in serving.
On start-up the trainer asks the :class:`CheckpointManager` for the newest
committed checkpoint: DIRECT when the layout is unchanged, RESHARD_STREAM
when it changed; training continues at the checkpointed step with the same
global data order (the stateless pipeline of :mod:`.data`).

Every family trains: dense, MoE (a MoE config's plan shards its expert
tensors by expert parallelism or by expert-TP, ``moe_mode``), Mamba-2, the
Mamba-2/attention/MoE hybrid, and the cross-attention families (vlm,
encdec), whose batches carry the stubbed frontend's ``source_embeds``
beside the tokens.
Each step's record carries the cross-entropy ``loss`` and the MoE ``aux``
loss (0 for a model without experts).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

import repro_torch.obs as obs
from repro_torch.ckpt.manager import CheckpointManager, RestoreInfo
from repro_torch.ckpt.policy import CheckpointPolicy
from repro_torch.configs.base import ModelConfig, ParallelismConfig, ShapeSpec, TrainConfig
from repro_torch.core.layout import MeshSpec
from repro_torch.dist.sharding import ShardingPlan, make_plan, vocab_multiple
from repro_torch.models import build_model
from repro_torch.models.lm import LM

from .data import batch_for_step
from .optimizer import TrainState, init_state
from .steps import make_train_step

__all__ = ["Trainer"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        device: str | torch.device = "cuda",
    ) -> "Trainer":
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but is not available (pass device='cpu')")
        lm = build_model(
            cfg,
            vocab_multiple=vocab_multiple(parallel, mesh),
            compute_dtype=_DTYPES[parallel.compute_dtype],
            remat=parallel.remat,
        )
        plan = make_plan(cfg, lm.registry, parallel, mesh)
        manager = (
            CheckpointManager(
                ckpt_dir, plan, policy=policy,
                config_fingerprint={
                    "model": cfg.fingerprint(), "parallel": parallel.fingerprint(),
                },
            )
            if ckpt_dir
            else None
        )
        return cls(
            cfg=cfg, parallel=parallel, tcfg=tcfg, mesh=mesh, device=device, lm=lm,
            plan=plan, manager=manager,
            step_fn=make_train_step(lm, tcfg, parallel),
            batch_size=batch_size, seq_len=seq_len, data_seed=tcfg.seed,
        )

    def init_state(self) -> TrainState:
        """Fresh weights from a generator on the device seeded with the run's
        seed, zero moments in ``moment_dtype``."""
        params = self.lm.init(torch.Generator(device=self.device).manual_seed(self.tcfg.seed))
        return init_state(params, moment_dtype=_DTYPES[self.parallel.moment_dtype])

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
        out = {"tokens": torch.from_numpy(full["tokens"]).long().to(self.device)}
        if "source_embeds" in full:  # vlm and encdec: the stubbed frontend's embeddings
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
            history.append(rec)
            if log:
                log(rec)
            if self.manager is not None and self.manager.should_save(step + 1):
                self.manager.save(state, step + 1)
        if self.manager is not None:
            self.save_results += self.manager.wait()
        return state, history
