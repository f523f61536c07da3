"""CheckpointManager: the policy layer tying saving, discovery and resume
(port of the disk path of ``repro.ckpt.manager``).

* periodic saves, synchronous or asynchronous (:class:`AsyncSaver`), atomic
  commit, keep-last-k GC — delta-aware (a base that a kept or in-flight
  delta references is never collected) and in-flight-aware (directories an
  async save is still writing are never wreckage);
* incremental saves (``save_mode="delta"``): a steady-state save writes
  only the shards whose content changed since the previous commit, and
  every ``full_interval``-th save is a full rebase that bounds the chain;
* one I/O engine per device, ``policy.io_workers`` wide (the process
  default engines when None): saves write through it, restores and exports
  read through it and drop what it cached of their checkpoint at the end;
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
  a UCP atom checkpoint, reusing a committed ``.ucp`` cache;
* the hot in-memory tier (``hot_interval``): every ``hot_interval`` steps a
  peer-replicated host snapshot, every ``disk_interval // hot_interval``-th
  of them promoted to disk in the background (coded fragments encoded on
  the state's device), see :mod:`repro_torch.hot`;
* tiered resume (:meth:`CheckpointManager.restore_latest`): HOT_DIRECT →
  HOT_RESHARD → DIRECT → RESHARD_STREAM → VIA_UCP, surviving in-memory
  replicas first, then the disk tiers;
* fan-out (``policy.registry``, a
  :class:`~repro_torch.serve.PublicationRegistry`): every newly committed
  step is published (``_maybe_publish`` runs after ``save()`` and in
  ``wait()``, so an async save is announced once its commit is observed),
  and GC keeps the currently published step, the fleet's disk tier, past
  ``keep_last``.

Spans, counters, events and fault points are the reference's
(:mod:`repro_torch.obs`, :mod:`repro_torch.chaos.points`); no fault point
fires while a lock of the manager is held.
"""

from __future__ import annotations

import dataclasses
import shutil
import threading
from pathlib import Path
from typing import Any, Mapping

import torch

import repro_torch.obs as obs
from repro_torch.chaos.points import fault_point
from repro_torch.core.atoms import UcpCheckpoint
from repro_torch.core.convert import ConvertStats, convert_to_ucp
from repro_torch.core.dist_ckpt import DistCheckpoint
from repro_torch.core.engine import CheckpointEngine, default_engine, device_key
from repro_torch.core.plan import ResumeMode, TargetSpec, plan_resume, stream_transforms
from repro_torch.core.tensor_io import IntegrityError
from repro_torch.core.pytree import flatten_with_paths
from repro_torch.dist.sharding import ShardingPlan
from repro_torch.train.optimizer import TrainState

from .policy import CheckpointPolicy
from .restore import RestoreStats, state_from_source, state_from_stream, state_from_ucp
from .saver import AsyncSaver, SaveResult, snapshot_state, write_distributed

__all__ = ["CheckpointManager", "RestoreInfo", "cached_ucp"]


def _dir_bytes(root: Path) -> int:
    """Recursive file-size sum of one step directory (GC accounting; only
    walked while a tracer is enabled)."""
    total = 0
    try:
        for p in root.rglob("*"):
            try:
                if p.is_file():
                    total += p.stat().st_size
            except OSError:
                continue
    except OSError:
        pass
    return total


def _state_device(state: TrainState) -> torch.device:
    return next(iter(flatten_with_paths(state.params).values())).device


def cached_ucp(
    ckpt: DistCheckpoint, engine: CheckpointEngine, *, convert_workers: int | None = None
) -> tuple[UcpCheckpoint, ConvertStats | None]:
    """A step's UCP atom checkpoint in ``<step dir>.ucp``: reuse the
    committed cache, else remove a partial one and convert once (the
    hub-format property).  ``ConvertStats`` is None on a reuse; an explicit
    ``convert_workers`` wins over the engine's width."""
    ucp_dir = Path(str(ckpt.root) + ".ucp")
    if (ucp_dir / "COMMIT").exists():
        return UcpCheckpoint.open(ucp_dir), None
    shutil.rmtree(ucp_dir, ignore_errors=True)  # a partial convert
    return convert_to_ucp(ckpt, str(ucp_dir), workers=convert_workers, engine=engine)


@dataclasses.dataclass
class RestoreInfo:
    step: int
    mode: ResumeMode
    reason: str
    scalars: dict[str, Any]
    wall_time_s: float
    convert_stats: ConvertStats | None = None  # set when VIA_UCP converted this time
    restore_stats: RestoreStats | None = None


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
        manifest.

        Delta policy: with ``save_mode="delta"`` the steady-state save
        writes only the shards whose content digest changed since the
        previous committed step, the rest being manifest references into
        the chain; every ``full_interval``-th save is full (a rebase),
        which bounds the chain and lets GC collect old ones.

        Hot-tier policy: ``hot_interval`` (None = off) captures a
        peer-replicated host snapshot every N steps; every
        ``disk_interval // hot_interval``-th snapshot is promoted to a
        durable disk checkpoint in the background (``disk_interval``
        defaults to ``save_interval``).  ``hot_replication`` extra copies
        per fragment; ``hot_max_snapshots`` / ``hot_max_bytes`` bound the
        ring.

        Fan-out policy: ``registry`` publishes every newly committed step;
        the newest committed step is always within ``keep_last`` and the
        published one is kept too, so a publication's disk tier outlives
        GC."""
        self.policy = policy if policy is not None else CheckpointPolicy()
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.plan = plan
        self.keep_last = self.policy.keep_last
        self.save_interval = self.policy.save_interval
        self.disk_interval = self.policy.effective_disk_interval
        self.hot_interval = self.policy.hot_interval
        self.save_mode = self.policy.save_mode
        self.full_interval = self.policy.full_interval
        self.codec = self.policy.codec
        self.registry = self.policy.registry
        self._published_step: int | None = None
        self.config_fingerprint = dict(config_fingerprint or {})
        self._disk_save_seq = 0  # the save counter behind the rebase cadence
        # Chain pins: save root -> the chain directories its in-flight delta
        # resolved as base (registered by the base loader on the writer
        # thread, pruned by gc() once the save leaves the pending set).
        self._pin_lock = threading.Lock()
        self._pinned_chains: dict[Path, set[Path]] = {}  #: guarded by self._pin_lock
        # Committed manifests are immutable: memoize referenced_steps per step.
        self._refs_cache: dict[int, set[int]] = {}
        # One engine per device key; private ones when io_workers is set.
        self._engines: dict[str, CheckpointEngine] = {}
        self.engine = self.engine_for(None)  # the engine saves write through
        self._async = (
            AsyncSaver(max_pending=self.policy.max_pending_saves)
            if self.policy.async_save
            else None
        )
        self.hot = None
        self._drainer = None
        if self.hot_interval is not None:
            from repro_torch.hot import HotDrainer, HotTier

            self.hot = HotTier(
                replication=self.policy.hot_replication,
                max_snapshots=self.policy.hot_max_snapshots,
                max_bytes=self.policy.hot_max_bytes,
                engine=self.engine,
                # "all" captures every replica's write set, or the promoted
                # checkpoints would be dedup'd; "delta" captures the dedup set
                save_mode="all" if self.save_mode == "all" else "dedup",
            )
            self._drainer = HotDrainer(
                every=max(1, self.disk_interval // self.hot_interval),
                engine=self.engine,
                max_pending=self.policy.max_pending_saves,
            )

    def engine_for(self, device) -> CheckpointEngine:
        """This manager's I/O engine of ``device`` (None: the host): a
        private ``io_workers``-wide engine, or the process default one."""
        key = device_key(device)
        eng = self._engines.get(key)
        if eng is None:
            dev = None if key == "cpu" else key
            eng = self._engines[key] = (
                CheckpointEngine(dev, workers=self.policy.io_workers)
                if self.policy.io_workers is not None
                else default_engine(dev)
            )
        return eng

    # ------------------------------------------------------------------ save
    def step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def should_save(self, step: int) -> bool:
        if step <= 0:
            return False
        if self.hot is not None:
            # the hot cadence subsumes the disk one: every Nth snapshot is
            # promoted to disk by the drainer
            return step % self.hot_interval == 0
        return step % self.save_interval == 0

    def _base_loader(self, step: int):
        """A callable resolving the delta base of a save of ``step``, run on
        the writing thread, so a queued delta diffs against the newest step
        that actually committed before it runs.

        The resolved base's chain is pinned before the loader returns, and
        ``gc()`` collects no pinned directory until the save leaves the
        in-flight set.  Resolution runs under ``_pin_lock``, the lock gc()
        holds around each deletion, so the loader either pins the base
        before gc can consider it or sees it deleted and rebases (the
        saver's pre-commit chain check is the last resort)."""
        save_root = self.step_dir(step)

        def load() -> DistCheckpoint | None:
            with self._pin_lock:
                older = [s for s in self.steps() if s < step]
                if not older:
                    return None
                try:
                    base = DistCheckpoint.open(self.step_dir(older[-1]))
                except (OSError, ValueError, KeyError):
                    return None  # an unreadable base: rebase to a full save
                self._pinned_chains[save_root] = set(base.chain_roots())
            return base

        return load

    def _next_save_kw(self, step: int) -> dict[str, Any]:
        """Per-save delta policy: the ``save_mode``/``base`` of the next
        save, advancing the rebase cadence (every ``full_interval``-th save
        is full)."""
        if self.save_mode != "delta":
            return {"save_mode": self.save_mode}
        seq = self._disk_save_seq
        self._disk_save_seq += 1
        if seq % self.full_interval == 0:
            return {"save_mode": "dedup"}  # forced rebase: a plain full save
        return {"save_mode": "delta", "base": self._base_loader(step)}

    def save(
        self, state: TrainState, step: int, *, scalars: Mapping[str, Any] | None = None,
        block: bool = False,
    ) -> None:
        """Save ``state`` as ``step``: queued on the async writer unless the
        policy is synchronous or ``block`` asks to wait; then GC.  With the
        hot tier on, a hot step is captured into host memory and maybe
        promoted to disk by the drainer."""
        fault_point("manager.save.begin", step=step, block=block)
        with obs.span("manager.save", step=step):
            self._save(state, step, scalars=scalars, block=block)

    def _save(
        self, state: TrainState, step: int, *, scalars: Mapping[str, Any] | None, block: bool,
    ) -> None:
        # a re-save into an existing step replaces its manifest
        self._refs_cache.pop(step, None)
        if self.hot is not None and step % self.hot_interval == 0:
            # host arrays (no coded kind left on the card): the ring holds
            # host memory, and the drain encodes on the state's device
            snap = snapshot_state(state)
            hs, _ = self.hot.capture(
                snap, self.plan, step, scalars=dict(scalars or {}),
                config_fingerprint=self.config_fingerprint, device=_state_device(state),
            )
            del snap
            drain_kw = self._next_save_kw(step) if self._drainer.next_drains else {}
            self._drainer.maybe_drain(hs, self.step_dir(step), codec=self.codec, **drain_kw)
            if block:
                self._drainer.wait()
            self.gc()
            self._maybe_publish()
            return
        kw = dict(
            scalars=dict(scalars or {}),
            config_fingerprint=self.config_fingerprint,
            engine=self.engine,
            codec=self.codec,
        )
        kw.update(self._next_save_kw(step))
        if self._async is not None and not block:
            self._async.submit(state, self.plan, step, self.step_dir(step), **kw)
        else:
            snap = snapshot_state(state, self.codec)
            write_distributed(snap, self.plan, step, self.step_dir(step), **kw)
        self.gc()
        self._maybe_publish()

    def wait(self) -> list[SaveResult]:
        # A drainer failure must not leave async-saver errors undrained (or
        # the reverse), and GC and publishing still see whatever did commit.
        res: list[SaveResult] = []
        try:
            if self._drainer is not None:
                res.extend(self._drainer.wait())
        finally:
            try:
                if self._async is not None:
                    res.extend(self._async.wait())
            finally:
                if self._async is not None or self._drainer is not None:
                    self.gc()
                self._maybe_publish()
        return res

    # ----------------------------------------------------------- publishing
    def publish(self, step: int | None = None):
        """Announce one committed step (the newest by default) to the fan-out
        registry (:mod:`repro_torch.serve`).  Returns the
        :class:`~repro_torch.serve.registry.Publication`, or None when
        nothing is committed yet."""
        if self.registry is None:
            raise ValueError("CheckpointManager has no publication registry")
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        pub = self.registry.publish(DistCheckpoint.open(self.step_dir(step)))
        self._published_step = max(step, self._published_step or step)
        return pub

    def _maybe_publish(self) -> None:
        """Publish the newest committed step not announced yet.  Runs after
        every ``save()`` and ``wait()``: a synchronous save publishes at
        once, an async or drained one on the next call that sees its
        commit."""
        if self.registry is None:
            return
        step = self.latest_step()
        if step is None or (self._published_step is not None and step <= self._published_step):
            return
        self.publish(step)

    def close(self) -> None:
        """Drain the hot drainer and the async writer (surfacing their
        errors), free the hot ring, then close the private engines (their
        pools and caches; a later use reopens)."""
        try:
            if self._drainer is not None:
                self._drainer.close()
        finally:
            try:
                if self._async is not None:
                    self._async.close()
            finally:
                if self.hot is not None:
                    self.hot.clear()
                if self.policy.io_workers is not None:
                    for eng in self._engines.values():
                        eng.close()

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
        """Step directories with a save queued or mid-write right now."""
        out: set[Path] = set()
        if self._async is not None:
            out |= self._async.pending_roots()
        if self._drainer is not None:
            out |= self._drainer.pending_roots()
        return out

    def gc(self) -> None:
        """Keep the newest ``keep_last`` committed checkpoints (and their UCP
        caches); remove uncommitted wreckage older than the newest commit.

        Delta-aware: a kept delta's whole ancestor chain stays (a base is
        collectable once no surviving manifest references it; a rebase is
        what frees an old chain), and chains pinned by an in-flight delta's
        base resolution stay until that save completes.  In-flight-aware:
        directories an async save is still writing are never wreckage.
        Deletes newest-first (references only point backwards, so a GC cut
        short leaves no committed manifest naming a deleted ancestor) and
        drops the engines' handles of what it deletes."""
        with obs.span("ckpt.gc"):
            self._gc()

    def _gc(self) -> None:
        fault_point("manager.gc.begin")
        # Read order matters: in-flight BEFORE committed.  A background save
        # commits and *then* leaves the pending set, so any save gone from
        # `inflight` is already visible in `steps`.
        inflight = self._inflight_roots()
        steps = self.steps()
        keep: set[int] = set(steps[-self.keep_last:])
        if self.registry is not None:
            # The fleet's disk tier: the currently published step outlives GC
            # even when newer commits pushed it past keep_last (a crash
            # between commit and announce leaves the fleet on the older
            # publication).
            pub = self.registry.current()
            if pub is not None and pub.step in steps:
                keep.add(pub.step)
        # every step a kept chain references, to a fixpoint
        frontier = list(keep)
        while frontier:
            s = frontier.pop()
            refs = self._refs_cache.get(s)
            if refs is None:
                try:
                    refs = DistCheckpoint.open(self.step_dir(s)).referenced_steps()
                except (OSError, ValueError, KeyError):
                    continue  # an unreadable manifest pins nothing
                if self.step_dir(s) not in inflight:
                    # only settled steps: an in-flight re-save may replace it
                    self._refs_cache[s] = refs
            for r in refs:
                if r not in keep:
                    keep.add(r)
                    frontier.append(r)
        with self._pin_lock:
            # pins die with their save
            self._pinned_chains = {r: c for r, c in self._pinned_chains.items() if r in inflight}
        for s in sorted(steps, reverse=True):
            step_dir = self.step_dir(s)
            if s in keep or step_dir in inflight:
                continue
            # Outside the pin lock: a thread paused here must not block the
            # base loader.
            fault_point("manager.gc.delete", step=s)
            # One critical section per deletion, shared with the base loader:
            # a base resolved concurrently is either pinned already (skip) or
            # resolves after the deletion (the loader rebases).
            with self._pin_lock:
                if step_dir in set().union(*self._pinned_chains.values()):
                    obs.add("gc.pinned_steps")
                    continue
                self._refs_cache.pop(s, None)
                if obs.active() is not None:  # the sizing walk only when traced
                    obs.add("gc.collected_bytes", _dir_bytes(step_dir))
                obs.add("gc.collected_steps")
                shutil.rmtree(step_dir, ignore_errors=True)
                shutil.rmtree(Path(str(step_dir) + ".ucp"), ignore_errors=True)
            for eng in self._engines.values():
                eng.invalidate(step_dir)
                eng.invalidate(str(step_dir) + ".ucp")
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
                    fault_point("manager.gc.wreckage", path=p.name)
                    obs.add("gc.wreckage_removed")
                    shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------------- restore
    def restore(
        self, device: str | torch.device, *, step: int | None = None,
        force_mode: ResumeMode | None = None, target_plan: ShardingPlan | None = None,
        verify: bool = False,
    ) -> tuple[TrainState, RestoreInfo] | None:
        """Resume ``step`` (the newest committed one by default) onto
        ``device`` under ``target_plan`` (this manager's plan by default)
        from the disk tiers: DIRECT when the layouts are equal,
        RESHARD_STREAM when they differ, VIA_UCP when the parameter set
        changed.  A stream that fails with ``OSError``, ``KeyError`` or
        ``IntegrityError`` falls back to VIA_UCP; other errors propagate.
        Reads go through this manager's engine of ``device``.

        ``force_mode`` pins RESHARD_STREAM or VIA_UCP (no fallback when
        forced), or DIRECT only when the layouts are equal.  ``verify``
        checks the checkpoint's content digests first and raises
        :class:`IntegrityError` on a mismatch.  Returns None when no
        committed checkpoint exists (a fresh start)."""
        plan = target_plan or self.plan
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        fault_point("manager.restore.begin", step=step)
        with obs.timed("ckpt.restore", step=step) as sw:
            return self._restore_traced(sw, plan, torch.device(device), step, force_mode,
                                        verify)

    def _restore_traced(self, sw, plan, device, step, force_mode, verify):
        # The body of restore(), inside its ``ckpt.restore`` span: ``sw``
        # gives the wall time and carries the plan's decision.
        ckpt = DistCheckpoint.open(self.step_dir(step))
        if verify:
            problems = ckpt.validate()
            if problems:
                raise IntegrityError(
                    f"checkpoint step {step} failed verification: " + "; ".join(problems[:5])
                )
        target = TargetSpec(plan.mesh, plan.param_specs)
        with obs.span("restore.plan"):
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
        stats = RestoreStats()
        engine = self.engine_for(device)
        try:
            if mode is ResumeMode.DIRECT:
                with obs.span("restore.tier", tier="direct"):
                    state = state_from_source(ckpt, plan, device, engine=engine, stats=stats)
            elif mode is ResumeMode.RESHARD_STREAM:
                transforms = rp.transforms or stream_transforms(ckpt.manifest, target)
                try:
                    with obs.span("restore.tier", tier="reshard_stream"):
                        state = state_from_stream(ckpt, plan, device, transforms,
                                                  engine=engine, stats=stats)
                except (OSError, KeyError, IntegrityError) as e:
                    # Expected stream-time failures: a shard lost or corrupt after
                    # planning, a manifest entry gone.  Programming errors
                    # propagate.
                    if force_mode is not None:
                        raise
                    # drop what the engine cached of the (possibly damaged) source
                    # — for a delta, of its whole chain — and convert instead
                    engine.invalidate_chain(ckpt)
                    obs.event("restore.fallback", step=step, tier="reshard_stream",
                              to="via_ucp", error=f"{type(e).__name__}: {e}")
                    mode = ResumeMode.VIA_UCP
                    reason = (
                        f"{reason}; stream failed ({type(e).__name__}: {e}), "
                        "falling back to via_ucp"
                    )
                    stats = RestoreStats()
            if mode is ResumeMode.VIA_UCP:
                with obs.span("restore.tier", tier="via_ucp"):
                    ucp, cstats = cached_ucp(ckpt, engine)
                    state = state_from_ucp(ucp, plan, device, engine=engine, stats=stats)
        finally:
            engine.release(ckpt)  # no decoded shard outlives the restore
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sw.set(mode=mode.value, reason=reason)
        obs.add("restore.count")
        info = RestoreInfo(
            step=step, mode=mode, reason=reason,
            scalars=dict(ckpt.manifest.scalars), wall_time_s=sw.elapsed_s,
            convert_stats=cstats, restore_stats=stats,
        )
        return state, info

    def export_ucp(
        self, step: int | None = None, *, device: str | torch.device = "cuda",
        convert_workers: int | None = None,
    ) -> tuple[UcpCheckpoint, ConvertStats | None]:
        """Export one step (the newest by default) as a UCP atom checkpoint
        in ``<step dir>.ucp``: the portable hub format, for publishing a
        checkpoint or feeding another framework.  Coded moment shards are
        decoded on ``device`` (the dequantize kernel on a card; pass "cpu"
        to decode on the host).  ``convert_workers`` overrides the pool
        width of this conversion (None: the manager's engine).  Reuses a
        committed cache (``ConvertStats`` is then None)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise ValueError(f"no committed checkpoint under {self.root} to export")
        ckpt = DistCheckpoint.open(self.step_dir(step))
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but is not available (pass device='cpu')")
        engine = self.engine_for(device)
        try:
            ucp, cstats = cached_ucp(ckpt, engine, convert_workers=convert_workers)
        finally:
            engine.release(ckpt)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return ucp, cstats

    def restore_latest(
        self, device: str | torch.device, *, target_plan: ShardingPlan | None = None,
        verify: bool = False,
    ) -> tuple[TrainState, RestoreInfo] | None:
        """Tiered resume onto ``device``: HOT_DIRECT → HOT_RESHARD → DIRECT
        → RESHARD_STREAM → VIA_UCP.

        Prefers the newest surviving in-memory snapshot when it is at least
        as fresh as the best committed disk checkpoint and its replicas
        still cover the full state (after any ``hot.fail_ranks``);
        otherwise falls through to :meth:`restore`.  A hot restore opens no
        checkpoint file.  With the hot tier off this is :meth:`restore`."""
        plan = target_plan or self.plan
        device = torch.device(device)
        if self.hot is not None:
            from repro_torch.hot import plan_hot_recovery, state_from_hot

            target = TargetSpec(plan.mesh, plan.param_specs)
            with obs.span("restore.plan"):
                hp = plan_hot_recovery(self.hot, target, min_step=self.latest_step())
            if hp is not None:
                engine = self.engine_for(device)
                with obs.timed("ckpt.restore", step=hp.step, mode=hp.mode.value,
                               reason=hp.reason) as sw:
                    stats = RestoreStats()
                    try:
                        with obs.span("restore.tier", tier=hp.mode.value):
                            state = state_from_hot(hp.snapshot, plan, device, stats,
                                                   engine=engine, verify=verify)
                    finally:
                        engine.release(hp.snapshot)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    obs.add("restore.count")
                    info = RestoreInfo(
                        step=hp.step, mode=hp.mode, reason=hp.reason,
                        scalars=dict(hp.snapshot.manifest.scalars), wall_time_s=sw.elapsed_s,
                        restore_stats=stats,
                    )
                return state, info
        return self.restore(device, target_plan=target_plan, verify=verify)
