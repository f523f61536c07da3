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

With ``group`` (a ``torch.distributed`` group of the plan's mesh size) the
manager is one rank's: every rank runs ``should_save`` and ``save``, each
writes only the shards it owns (:func:`write_distributed` with
``ranks=(rank,)``, coordinated on a gloo group the manager keeps for
checkpoints), rank 0 commits and then runs GC, the ranks agree on
``latest_step`` over ``group`` (rank 0's answer, broadcast), ``restore`` and
``restore_latest`` build the rank's shards, and ``wait()`` raises every
rank's writer error.  Under a group too:

* a delta diffs each rank's shards against the base rank 0 resolves (its
  base loader, and so its chain pins, run on rank 0 alone); the rebase
  cadence advances on every rank at the same saves;
* the hot tier is each rank's own ring (:class:`~repro_torch.hot.HotTier`
  with the group): a capture stages the rank's shards and exchanges buddy
  mirrors over a third gloo group, the hot group, on the calling thread.
  The drainer's promotions use the checkpoint group from the drainer's
  thread, so a capture never waits for a drain, and two threads never
  issue collectives on one group; the async writer and the drainer take
  the checkpoint group in turn (one's queue is drained before the other
  is handed a save);
* fan-out is rank 0's: a registry on any other rank is refused, every
  rank enters ``publish`` (a collective) and gets rank 0's publication;
* after a real process death, :meth:`leave_group` lets a lone survivor
  carry on as one process from its own memory
  (:func:`repro_torch.elastic.hot_recover`).

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
import torch.distributed as dist

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
from .saver import AsyncSaver, SaveResult, on_rank0, snapshot_state, write_distributed

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
        group=None,
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
        self.group = group
        self.rank = 0
        self._ckpt_group = None
        self._hot_group = None
        # whether (group) rank 0 publishes: every rank enters publish() then
        self._publishing = self.policy.registry is not None
        self._stash: list[SaveResult] = []  # results drained before a blocking save
        if group is not None:
            if group.size() != plan.mesh.size:
                raise ValueError(f"the group has {group.size()} ranks; the plan's mesh "
                                 f"{dict(plan.mesh.axes)} has {plan.mesh.size}")
            self.rank = dist.get_rank(group)
            has: list = [None] * group.size()
            dist.all_gather_object(has, self.policy.registry is not None, group=group)
            off = [r for r, h in enumerate(has) if h and r != 0]
            if off:
                raise ValueError(f"a publication registry belongs to group rank 0, which commits "
                                 f"and publishes; ranks {off} were given one")
            self._publishing = bool(has[0])
            ranks = [dist.get_global_rank(group, r) for r in range(group.size())]
            # saves coordinate on a group of their own: the async writer's
            # collectives never interleave with the training step's
            self._ckpt_group = dist.new_group(ranks, backend="gloo")
            if self.policy.hot_interval is not None:
                # the capture's and recovery's exchanges (host bytes, the
                # calling thread) never interleave with a drain's collectives
                self._hot_group = dist.new_group(ranks, backend="gloo")
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
                group=self._hot_group,
            )
            self._drainer = HotDrainer(
                every=max(1, self.disk_interval // self.hot_interval),
                engine=self.engine,
                max_pending=self.policy.max_pending_saves,
                group=self._ckpt_group,
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
            drain_kw = {}
            if self._drainer.next_drains:
                self._one_writer(self._drainer)
                drain_kw = self._next_save_kw(step)
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
        if self.group is not None:
            kw.update(ranks=(self.rank,), group=self._ckpt_group)
            self._one_writer(self._async)
            if self._async is not None and block:
                # the checkpoint group is the writer thread's until it drains
                self._stash += self._async.wait()
        if self._async is not None and not block:
            self._async.submit(state, self.plan, step, self.step_dir(step), **kw)
        else:
            snap = snapshot_state(state, self.codec)
            write_distributed(snap, self.plan, step, self.step_dir(step), **kw)
        self.gc()
        self._maybe_publish()

    def _one_writer(self, writer) -> None:
        """Under a group the async writer and the drainer share the
        checkpoint group: before ``writer`` (one of them, or None for a
        synchronous save) is handed a save, the other's queue is drained,
        its results kept for :meth:`wait`."""
        if self.group is None:
            return
        for other in (self._async, self._drainer):
            if other is None or other is writer:
                continue
            if other.pending_roots():
                self._stash += other.wait()
            if other.pending_roots():
                raise RuntimeError("an async save and a drain would share the checkpoint group")

    def wait(self) -> list[SaveResult]:
        # A drainer failure must not leave async-saver errors undrained (or
        # the reverse), and GC and publishing still see whatever did commit.
        res: list[SaveResult] = self._stash
        self._stash = []
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
                if self.group is not None:
                    self._from_rank0(None)  # every rank sees rank 0's commits and GC
        return res

    # ----------------------------------------------------------- publishing
    def publish(self, step: int | None = None):
        """Announce one committed step (the newest by default) to the fan-out
        registry (:mod:`repro_torch.serve`).  Returns the
        :class:`~repro_torch.serve.registry.Publication`, or None when
        nothing is committed yet.

        Under a group every rank calls it (a collective): rank 0 publishes
        to its registry, and every rank returns rank 0's publication."""
        if not self._publishing:
            raise ValueError("CheckpointManager has no publication registry"
                             + (" on group rank 0" if self.group is not None else ""))
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        if self.group is None:
            pub = self.registry.publish(DistCheckpoint.open(self.step_dir(step)))
        else:
            pub = on_rank0(
                lambda: self.registry.publish(DistCheckpoint.open(self.step_dir(step))),
                self.group)
        self._published_step = max(step, self._published_step or step)
        return pub

    def _maybe_publish(self) -> None:
        """Publish the newest committed step not announced yet.  Runs after
        every ``save()`` and ``wait()``: a synchronous save publishes at
        once, an async or drained one on the next call that sees its
        commit.  Under a group every rank runs it in the same order (its
        ``latest_step`` is a collective) when rank 0 publishes."""
        if not self._publishing:
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
        """The newest committed step; under a group, rank 0's answer on every
        rank (a collective: every rank calls it, from its main thread)."""
        s = self.steps()
        latest = s[-1] if s else None
        if self.group is None:
            return latest
        return self._from_rank0(latest)

    def _from_rank0(self, value):
        """Rank 0's ``value`` on every rank of the group (a barrier too)."""
        box = [value]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0), group=self.group)
        return box[0]

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
        if self.rank != 0:
            return  # rank 0 collects, after its commits
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
        rank = None if self.group is None else self.rank  # None: the whole state
        if rank is not None and plan.mesh.size != self.group.size():
            raise ValueError(f"the target mesh {dict(plan.mesh.axes)} is not the group's size "
                             f"{self.group.size()}")
        try:
            if mode is ResumeMode.DIRECT:
                with obs.span("restore.tier", tier="direct"):
                    state = state_from_source(ckpt, plan, device, engine=engine, stats=stats,
                                              rank=rank)
            elif mode is ResumeMode.RESHARD_STREAM:
                transforms = rp.transforms or stream_transforms(ckpt.manifest, target)
                failure = None
                try:
                    with obs.span("restore.tier", tier="reshard_stream"):
                        state = state_from_stream(ckpt, plan, device, transforms,
                                                  engine=engine, stats=stats, rank=rank)
                except (OSError, KeyError, IntegrityError) as e:
                    # Expected stream-time failures: a shard lost or corrupt after
                    # planning, a manifest entry gone.  Programming errors
                    # propagate.
                    if force_mode is not None and self.group is None:
                        raise
                    failure = f"{type(e).__name__}: {e}"
                if self.group is not None:
                    # the ranks fall back together, or not at all
                    failed = self._all_failures(failure)
                    if failed and force_mode is not None:
                        raise IntegrityError(f"forced reshard_stream failed: {'; '.join(failed)}")
                    failure = failed[0] if failed else None
                if failure is not None:
                    # drop what the engine cached of the (possibly damaged) source
                    # — for a delta, of its whole chain — and convert instead
                    engine.invalidate_chain(ckpt)
                    obs.event("restore.fallback", step=step, tier="reshard_stream",
                              to="via_ucp", error=failure)
                    mode = ResumeMode.VIA_UCP
                    reason = f"{reason}; stream failed ({failure}), falling back to via_ucp"
                    stats = RestoreStats()
                    state = None
            if mode is ResumeMode.VIA_UCP:
                with obs.span("restore.tier", tier="via_ucp"):
                    ucp, cstats = self._shared_ucp(ckpt, engine)
                    state = state_from_ucp(ucp, plan, device, engine=engine, stats=stats,
                                           rank=rank)
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

    def _all_failures(self, failure: str | None) -> list[str]:
        """Every rank's stream failure (None where it succeeded), as text,
        on every rank."""
        everyone: list = [None] * self.group.size()
        dist.all_gather_object(everyone, failure, group=self.group)
        return [f"rank {r}: {f}" for r, f in enumerate(everyone) if f is not None]

    def _shared_ucp(
        self, ckpt: DistCheckpoint, engine: CheckpointEngine, convert_workers: int | None = None,
    ) -> tuple[UcpCheckpoint, ConvertStats | None]:
        """:func:`cached_ucp`; under a group rank 0 converts (once) and the
        other ranks open its atoms after it committed them."""
        if self.group is None:
            return cached_ucp(ckpt, engine, convert_workers=convert_workers)
        out, err = None, None
        if self.rank == 0:
            try:
                out = cached_ucp(ckpt, engine, convert_workers=convert_workers)
            except Exception as e:  # repro: allow[except-discipline] -- re-raised on every rank below
                err = e
        msg = self._from_rank0(None if err is None else f"{type(err).__name__}: {err}")
        if msg is not None:
            raise RuntimeError(f"UCP conversion on rank 0 failed: {msg}") from err
        if out is not None:
            return out
        return UcpCheckpoint.open(Path(str(ckpt.root) + ".ucp")), None

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
            ucp, cstats = self._shared_ucp(ckpt, engine, convert_workers)
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
                rank = None if self.group is None else self.rank  # None: the whole state
                if rank is not None and plan.mesh.size != self.group.size():
                    raise ValueError(f"the target mesh {dict(plan.mesh.axes)} is not the "
                                     f"group's size {self.group.size()}")
                with obs.timed("ckpt.restore", step=hp.step, mode=hp.mode.value,
                               reason=hp.reason) as sw:
                    stats = RestoreStats()
                    try:
                        with obs.span("restore.tier", tier=hp.mode.value):
                            state = state_from_hot(hp.snapshot, plan, device, stats,
                                                   engine=engine, verify=verify, rank=rank,
                                                   group=self._hot_group)
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

    def leave_group(self, failed_ranks) -> None:
        """Carry on as one process after the group died with
        ``failed_ranks`` (real process deaths; the default group already
        destroyed): this rank, the lone survivor, keeps its hot snapshots,
        its own fragments and its peers' mirrors, and restores, saves and
        publishes on its own from here (its plan's mesh stays the group's).

        Re-forming a group of two or more survivors is not supported
        (ROADMAP item 11b.5) and raises; so does a rank among the failed."""
        if self.group is None:
            return
        failed = {int(r) for r in failed_ranks}
        survivors = [r for r in range(self.plan.mesh.size) if r not in failed]
        if self.rank in failed:
            raise ValueError(f"rank {self.rank} is among the failed ranks {sorted(failed)}: "
                             "it has nothing to recover")
        if len(survivors) > 1:
            raise NotImplementedError(
                f"{len(survivors)} ranks survive ({survivors}): re-forming a group of the "
                "survivors is not supported (ROADMAP item 11b.5); a lone survivor recovers alone")
        self.group = self._ckpt_group = self._hot_group = None
        self.rank = 0
        self._publishing = self.registry is not None
        if self.hot is not None:
            self.hot.leave_group()
        if self._drainer is not None:
            self._drainer.group = None
