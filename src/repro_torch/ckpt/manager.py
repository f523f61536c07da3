"""CheckpointManager: the policy layer tying saving, discovery and resume
(port of the disk path of ``repro.ckpt.manager``).

* periodic saves, synchronous or asynchronous (:class:`AsyncSaver`), atomic
  commit, keep-last-k GC (in-flight save directories are never wreckage);
* discovery that skips uncommitted (crashed) checkpoint directories;
* resume from disk: DIRECT per-rank reads when the Target layout equals the
  Source's, RESHARD_STREAM otherwise (fragments streamed straight into the
  Target layout, consolidating the few params that need it in memory, with
  zero intermediate bytes on disk), VIA_UCP when the parameter set changed
  (convert once into ``<step dir>.ucp``, then Load from the atoms);
* a stream that fails after planning (a shard lost or corrupt: ``OSError``,
  ``KeyError``, ``IntegrityError``) falls back to VIA_UCP, with the failure
  in ``RestoreInfo.reason``, unless the mode was forced;
* :meth:`CheckpointManager.export_ucp`: the explicit export of one step as
  a UCP atom checkpoint, reusing a committed ``.ucp`` cache.

The hot tier, delta saves and fan-out publishing are refused by
:class:`CheckpointPolicy`.
"""

from __future__ import annotations

import dataclasses
import shutil
import time
from pathlib import Path
from typing import Any, Mapping

import torch

from repro_torch.core.atoms import UcpCheckpoint
from repro_torch.core.convert import ConvertStats, convert_to_ucp
from repro_torch.core.dist_ckpt import DistCheckpoint
from repro_torch.core.engine import CheckpointEngine
from repro_torch.core.plan import ResumeMode, TargetSpec, plan_resume, stream_transforms
from repro_torch.core.tensor_io import IntegrityError
from repro_torch.dist.sharding import ShardingPlan
from repro_torch.train.optimizer import TrainState

from .policy import CheckpointPolicy
from .restore import state_from_source, state_from_stream, state_from_ucp
from .saver import AsyncSaver, SaveResult, snapshot_state, write_distributed

__all__ = ["CheckpointManager", "RestoreInfo", "cached_ucp"]


def cached_ucp(
    ckpt: DistCheckpoint, engine: CheckpointEngine
) -> tuple[UcpCheckpoint, ConvertStats | None]:
    """A step's UCP atom checkpoint in ``<step dir>.ucp``: reuse the
    committed cache, else remove a partial one and convert once (the
    hub-format property).  ``ConvertStats`` is None on a reuse."""
    ucp_dir = Path(str(ckpt.root) + ".ucp")
    if (ucp_dir / "COMMIT").exists():
        return UcpCheckpoint.open(ucp_dir), None
    shutil.rmtree(ucp_dir, ignore_errors=True)  # a partial convert
    return convert_to_ucp(ckpt, str(ucp_dir), engine=engine)


@dataclasses.dataclass
class RestoreInfo:
    step: int
    mode: ResumeMode
    reason: str
    scalars: dict[str, Any]
    wall_time_s: float
    convert_stats: ConvertStats | None = None  # set when VIA_UCP converted this time


class CheckpointManager:
    def __init__(
        self,
        root: str | Path,
        plan: ShardingPlan,
        *,
        policy: CheckpointPolicy | None = None,
        config_fingerprint: Mapping[str, Any] | None = None,
    ):
        """All checkpointing knobs live on one validated
        :class:`~repro_torch.ckpt.policy.CheckpointPolicy`;
        ``config_fingerprint`` is this run's identity, recorded into every
        manifest."""
        self.policy = policy if policy is not None else CheckpointPolicy()
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.plan = plan
        self.keep_last = self.policy.keep_last
        self.save_interval = self.policy.save_interval
        self.save_mode = self.policy.save_mode
        self.codec = self.policy.codec
        self.config_fingerprint = dict(config_fingerprint or {})
        self._async = (
            AsyncSaver(max_pending=self.policy.max_pending_saves)
            if self.policy.async_save
            else None
        )

    # ------------------------------------------------------------------ save
    def step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def save(
        self, state: TrainState, step: int, *, scalars: Mapping[str, Any] | None = None
    ) -> None:
        kw = dict(
            scalars=dict(scalars or {}),
            config_fingerprint=self.config_fingerprint,
            save_mode=self.save_mode,
            codec=self.codec,
        )
        if self._async is not None:
            self._async.submit(state, self.plan, step, self.step_dir(step), **kw)
        else:
            snap = snapshot_state(state, self.codec)
            write_distributed(snap, self.plan, step, self.step_dir(step), **kw)
        self.gc()

    def wait(self) -> list[SaveResult]:
        res: list[SaveResult] = []
        try:
            if self._async is not None:
                res.extend(self._async.wait())
        finally:
            if self._async is not None:
                self.gc()
        return res

    def close(self) -> None:
        if self._async is not None:
            self._async.close()

    # ----------------------------------------------------------------- lookup
    def steps(self) -> list[int]:
        out = []
        for p in sorted(self.root.glob("step_*")):
            if p.is_dir() and not p.name.endswith(".ucp") and (p / "COMMIT").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def _inflight_roots(self) -> set[Path]:
        return self._async.pending_roots() if self._async is not None else set()

    def gc(self) -> None:
        """Keep the newest ``keep_last`` committed checkpoints; remove
        uncommitted wreckage older than the newest commit.  Directories an
        async save is still writing are never wreckage.  (The port writes no
        delta chains, so no kept step pins an ancestor.)"""
        # Read order matters: in-flight BEFORE committed.  A background save
        # commits and *then* leaves the pending set, so any save gone from
        # `inflight` is already visible in `steps`.
        inflight = self._inflight_roots()
        steps = self.steps()
        for s in steps[: -self.keep_last]:
            step_dir = self.step_dir(s)
            if step_dir in inflight:
                continue
            shutil.rmtree(step_dir, ignore_errors=True)
            shutil.rmtree(Path(str(step_dir) + ".ucp"), ignore_errors=True)
        if steps:
            newest = self.step_dir(steps[-1])
            for p in self.root.glob("step_*"):
                if (
                    p.is_dir()
                    and not p.name.endswith(".ucp")
                    and not (p / "COMMIT").exists()
                    and p not in inflight
                    and p.name < newest.name
                ):
                    shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------------- restore
    def restore(
        self, device: str | torch.device, *, force_mode: ResumeMode | None = None
    ) -> tuple[TrainState, RestoreInfo] | None:
        """Resume the newest committed step onto ``device`` under this
        manager's plan: DIRECT when the layouts are equal, RESHARD_STREAM
        when they differ, VIA_UCP when the parameter set changed.  A stream
        that fails with ``OSError``, ``KeyError`` or ``IntegrityError``
        falls back to VIA_UCP; other errors propagate.

        ``force_mode`` pins RESHARD_STREAM or VIA_UCP (no fallback when
        forced), or DIRECT only when the layouts are equal.  Returns None
        when no committed checkpoint exists (a fresh start)."""
        plan = self.plan
        step = self.latest_step()
        if step is None:
            return None
        t0 = time.perf_counter()
        device = torch.device(device)
        ckpt = DistCheckpoint.open(self.step_dir(step))
        target = TargetSpec(plan.mesh, plan.param_specs)
        rp = plan_resume(ckpt.manifest, target)
        mode, reason = rp.mode, rp.reason
        if force_mode is not None:
            force = ResumeMode(force_mode)
            if force is ResumeMode.DIRECT and rp.mode is not ResumeMode.DIRECT:
                raise ValueError(f"cannot force DIRECT resume: layouts differ ({rp.reason})")
            if force not in (ResumeMode.DIRECT, ResumeMode.RESHARD_STREAM, ResumeMode.VIA_UCP):
                raise ValueError(f"cannot force disk resume mode {force}")
            mode, reason = force, f"forced {force.value}; planner said {rp.mode.value}"
        state, cstats = None, None
        if mode is ResumeMode.DIRECT:
            state = state_from_source(ckpt, plan, device, engine=CheckpointEngine(device))
        elif mode is ResumeMode.RESHARD_STREAM:
            transforms = rp.transforms or stream_transforms(ckpt.manifest, target)
            try:
                state = state_from_stream(
                    ckpt, plan, device, transforms, engine=CheckpointEngine(device)
                )
            except (OSError, KeyError, IntegrityError) as e:
                # Expected stream-time failures: a shard lost or corrupt after
                # planning, a manifest entry gone.  Programming errors
                # propagate.  The conversion below reads through a fresh
                # engine, so nothing cached from the failed stream is reused.
                if force_mode is not None:
                    raise
                mode = ResumeMode.VIA_UCP
                reason = (
                    f"{reason}; stream failed ({type(e).__name__}: {e}), "
                    "falling back to via_ucp"
                )
        if mode is ResumeMode.VIA_UCP:
            engine = CheckpointEngine(device)
            ucp, cstats = cached_ucp(ckpt, engine)
            state = state_from_ucp(ucp, plan, device, engine=engine)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        info = RestoreInfo(
            step=step, mode=mode, reason=reason,
            scalars=dict(ckpt.manifest.scalars), wall_time_s=time.perf_counter() - t0,
            convert_stats=cstats,
        )
        return state, info

    def export_ucp(
        self, step: int | None = None, *, device: str | torch.device = "cuda"
    ) -> tuple[UcpCheckpoint, ConvertStats | None]:
        """Export one step (the newest by default) as a UCP atom checkpoint
        in ``<step dir>.ucp``: the portable hub format, for publishing a
        checkpoint or feeding another framework.  Coded moment shards are
        decoded on ``device`` (the dequantize kernel on a card; pass "cpu"
        to decode on the host).  Reuses a committed cache (``ConvertStats``
        is then None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise ValueError(f"no committed checkpoint under {self.root} to export")
        ckpt = DistCheckpoint.open(self.step_dir(step))
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but is not available (pass device='cpu')")
        ucp, cstats = cached_ucp(ckpt, CheckpointEngine(device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return ucp, cstats

    def restore_latest(self, device: str | torch.device) -> tuple[TrainState, RestoreInfo] | None:
        """Tiered resume over the disk tiers (the hot tier is not ported):
        :meth:`restore` of the newest committed step."""
        return self.restore(device)
