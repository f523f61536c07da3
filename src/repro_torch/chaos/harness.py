"""ChaosHarness: a real (small) training run driven through a fault schedule
(port of ``repro.chaos.harness``).

One harness instance owns everything a production deployment would: a
:class:`~repro_torch.ckpt.manager.CheckpointManager` (async saver, optional hot
tier + drainer, delta mode, GC), a :class:`~repro_torch.serve.registry.PublicationRegistry`
with one subscribed :class:`~repro_torch.serve.fleet.FleetReplica`, and a tiny
3-parameter model state on ``device`` (a card by default) advanced by
seeded sparse updates.  ``run()``
replays the seed's :class:`~repro_torch.chaos.schedule.Schedule` against it:
every event is one train-mutate → save → wait cycle, with the armed fault
firing wherever its point is hit — on the main thread or a background
saver/drainer thread — and after every event the full ladder invariant is
checked (:mod:`repro_torch.chaos.invariants`) plus a bit-identity restore
against the reference snapshot recorded at save time.

Determinism levers (why the same seed always replays the same run):

* the manager runs ``io_workers=1`` — the engine's exact serial reference
  path, so per-shard fault-point hit order is the job list order;
* ``wait()`` after every save — at most one background job is in flight
  when the next event starts, so cross-thread interleaving cannot reorder
  fault-point hits between events;
* a fault point hit off the driving thread waits while the driving
  thread is inside ``save()`` (:class:`_SaveGate`, the bootstrap's saves
  included): ``save()``
  runs GC and publishes the newest commit after queueing its write, so a
  writer or drainer that committed first (a loaded host descheduling the
  driving thread) would move a deletion, a publication and the faults
  armed on them from the following ``wait()`` into ``save()``;
* all randomness (state updates, fault generation, restore-mode choice)
  derives from the seed; the commit/GC wall clock is the injectable
  :mod:`repro_torch.core.clock`.

Crash semantics: a :class:`~repro_torch.chaos.points.FaultError` surfacing from
``save()``/``wait()`` (directly, or wrapped by the async-saver/drainer
error path) is a *scheduled process death* — the harness tears the
manager down (host memory and hot tier die with it), rebuilds it over the
same storage root and registry, restores through the ladder, verifies
bit-identity against the reference for whatever step it found, and keeps
training from the restored state.  Destructive environment faults
(``lose_storage``) can also make an in-flight save fail loudly
(``check_chain_committed``, a deleted base mid-delta) — those errors are
*crash-equivalent*: the process would have died there, so they take the
same recovery path.  Anything else propagates: it is a bug, not chaos.
"""

from __future__ import annotations

import copy
import dataclasses
import random
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.ckpt.policy import CheckpointPolicy
from repro_torch.ckpt.saver import snapshot_state
from repro_torch.core import DimSpec, MeshSpec, STATE_KINDS, StateKind, uniform_param_spec
from repro_torch.core import clock
from repro_torch.core.engine import CheckpointEngine
from repro_torch.core.plan import ResumeMode
from repro_torch.dist.sharding import ShardingPlan
from repro_torch.elastic.resume import ElasticEvent, hot_recover
from repro_torch.serve import FleetReplica, PublicationRegistry
from repro_torch.train.optimizer import TrainState

from .invariants import Violation, check_invariants, diff_snapshots
from .points import FaultError, activate, deactivate
from .schedule import ChaosController, Schedule, generate_schedule

__all__ = ["ChaosHarness", "ChaosReport", "harness_config", "reachable_points"]

MESH_2X2 = MeshSpec.from_dict({"data": 2, "model": 2})
MESH_1X1 = MeshSpec.from_dict({"data": 1, "model": 1})

# Fault points a schedule can actually reach, by configuration.  With the
# hot tier on, every disk save goes through capture/drain (the saver.*
# direct path is idle); with it off, the reverse.  Arming an unreachable
# fault would stall the rest of the schedule for nothing.
_COMMON_POINTS = (
    "dist.pre_commit", "dist.committed",
    "manager.save.begin", "manager.gc.begin", "manager.gc.delete",
    "manager.gc.wreckage", "manager.restore.begin",
    "registry.publish.begin", "registry.publish.deliver",
    "peer.fetch",
)
_HOT_POINTS = ("hot.capture", "drain.enqueue", "drain.shard", "drain.pre_commit")
_SAVER_POINTS = ("saver.shard", "saver.pre_manifest", "saver.pre_commit")


def reachable_points(hot: bool) -> tuple[str, ...]:
    return _COMMON_POINTS + (_HOT_POINTS if hot else _SAVER_POINTS)


def harness_config(seed: int) -> dict[str, Any]:
    """The deterministic seed → run-configuration map (which tiers are on,
    delta or full saves, GC pressure)."""
    rng = random.Random(seed * 0x9E3779B1 + 1)
    hot = rng.random() < 0.5
    return {
        "hot": hot,
        "save_mode": "delta" if rng.random() < 0.6 else "dedup",
        "keep_last": rng.choice([1, 2, 3]),
        "full_interval": rng.choice([2, 3, 4]),
        "disk_every": rng.choice([1, 2]) if hot else 1,
        "n_faults": 6,
    }


@dataclasses.dataclass
class ChaosReport:
    ok: bool
    seed: int
    config: dict[str, Any]
    schedule: Schedule
    events_completed: int
    violations: list[str]
    error: str | None
    log: list[str]
    # Merged span+event records of the run (repro_torch.obs timeline form) — what
    # the sweep attaches to a failing seed's artifact so the exact sequence
    # of lifecycle operations, fault-point hits and invariant checks that
    # led to the failure can be read offline.
    timeline: list[dict[str, Any]] = dataclasses.field(default_factory=list)

    def describe(self) -> str:
        head = (
            f"seed {self.seed}: {'OK' if self.ok else 'FAILED'} after "
            f"{self.events_completed} events (config {self.config})"
        )
        body = []
        if self.error:
            body.append(f"error: {self.error}")
        body += [f"violation: {v}" for v in self.violations]
        body += [f"  {line}" for line in self.log[-12:]]
        return "\n".join([head] + body)


def _specs():
    return {
        "w": uniform_param_spec("w", (8, 6), [DimSpec(("data",)), DimSpec(("model",))]),
        "u": uniform_param_spec("u", (6, 4), [DimSpec(("model",)), DimSpec()]),
        "b": uniform_param_spec("b", (4,), [DimSpec()]),
    }


def _is_fault(err: BaseException | None) -> bool:
    """Is a scheduled FaultError anywhere in the cause/context chain
    (including the async check() ``.failures`` attachments)?"""
    seen: set[int] = set()
    stack: list[BaseException] = [err] if err is not None else []
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, FaultError):
            return True
        for nxt in (e.__cause__, e.__context__):
            if nxt is not None:
                stack.append(nxt)
        stack.extend(getattr(e, "failures", ()))
    return False


class _SaveGate:
    """A fault-point sink that records nothing: a hit on a thread other than
    ``owner`` waits for ``saved`` (cleared while ``owner`` is inside
    ``save()``; a deadlock guard of ``timeout`` seconds).  Every background
    save and drain hits a fault point before its commit
    (``dist.pre_commit``), so none commits before ``save()``'s own GC and
    publication have run.  Active alone during the bootstrap's saves."""

    def __init__(self, owner: threading.Thread, saved: threading.Event, timeout: float = 30.0):
        self.owner = owner
        self.saved = saved
        self.timeout = timeout

    def hold(self) -> None:
        if threading.current_thread() is not self.owner:
            self.saved.wait(self.timeout)

    def on_point(self, name: str, ctx) -> None:
        self.hold()

    def __enter__(self) -> "_SaveGate":
        activate(self)
        return self

    def __exit__(self, *exc) -> None:
        deactivate(self)


class _SaveGatedController(ChaosController):
    """The harness's controller: each hit first passes ``gate``
    (:class:`_SaveGate`), so a background hit counts after ``save()``'s."""

    def __init__(self, schedule: Schedule, *, env: Any, gate: _SaveGate):
        super().__init__(schedule, env=env)
        self.gate = gate

    def on_point(self, name: str, ctx) -> None:
        self.gate.hold()
        super().on_point(name, ctx)


class ChaosHarness:
    """One seeded chaos run; see the module docstring.

    ``schedule`` overrides the generated one (how shrunk schedules and
    emitted regression tests replay).  ``device`` holds the state, the
    restores and the replica's weights (a card by default; the tests pass
    ``"cpu"``).
    """

    def __init__(
        self,
        seed: int,
        root: str | Path,
        *,
        events: int = 12,
        schedule: Schedule | None = None,
        config: dict[str, Any] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA was requested but is not available (pass device='cpu')")
        self.seed = int(seed)
        self.root = Path(root)
        self.events = int(events)
        self.config = dict(config) if config is not None else harness_config(seed)
        self.schedule = (
            schedule
            if schedule is not None
            else generate_schedule(
                seed,
                n_faults=self.config["n_faults"],
                points=reachable_points(self.config["hot"]),
            )
        )
        self.specs = _specs()
        self.plan = ShardingPlan(mesh=MESH_2X2, param_specs=self.specs)
        self.tgt_plan = ShardingPlan(mesh=MESH_1X1, param_specs=self.specs)
        self.registry = PublicationRegistry(name=f"chaos{seed}")
        self.replica_engine = CheckpointEngine(self.device, workers=1)
        self.replica: FleetReplica | None = None
        self._replica_seq = 0
        self.mgr: CheckpointManager | None = None
        self.references: dict[int, dict] = {}  # step -> snapshot copy
        self.log: list[str] = []
        self._env_lock = threading.Lock()
        self._saved = threading.Event()  # cleared while the driving thread is in save()
        self._saved.set()
        self._pending_rank_loss: list[int] = []  #: guarded by self._env_lock
        self._storage_lost = False  #: guarded by self._env_lock
        self._rng = random.Random(seed ^ 0xC0FFEE)
        self._snap = {
            n: {
                # stable per-(param, kind) streams — builtin hash() is
                # process-salted and would break cross-process determinism
                k: np.random.default_rng(
                    [seed, sum(ord(c) for c in n), i]
                ).normal(size=s.runtime_shape).astype(np.float32)
                for i, k in enumerate(STATE_KINDS)
            }
            for n, s in self.specs.items()
        }

    # -------------------------------------------------------------- plumbing
    def _build_manager(self) -> CheckpointManager:
        cfg = self.config
        return CheckpointManager(self.root, self.plan, policy=CheckpointPolicy(
            keep_last=cfg["keep_last"],
            save_interval=10,
            hot_interval=10 if cfg["hot"] else None,
            disk_interval=10 * cfg["disk_every"] if cfg["hot"] else None,
            async_save=True,
            io_workers=1,  # exact serial engine: deterministic hit order
            save_mode=cfg["save_mode"],
            full_interval=cfg["full_interval"],
            registry=self.registry,
        ))

    def _train_state(self, step: int) -> TrainState:
        def tree(kind):
            return {n: torch.tensor(self._snap[n][kind], device=self.device) for n in self.specs}

        return TrainState(params=tree(StateKind.FP32), exp_avg=tree(StateKind.EXP_AVG),
                          exp_avg_sq=tree(StateKind.EXP_AVG_SQ), step=step)

    def _advance(self, event: int) -> None:
        """One "training step": seeded sparse updates (delta-friendly — a
        delta save after this writes only the touched shards)."""
        rng = np.random.default_rng([self.seed, 7919, event])
        names = sorted(self.specs)
        for name in rng.choice(names, size=rng.integers(1, 3), replace=False):
            arrs = self._snap[str(name)]
            arrs[StateKind.FP32] = arrs[StateKind.FP32] + rng.normal(
                scale=0.01, size=arrs[StateKind.FP32].shape
            ).astype(np.float32)
            if rng.random() < 0.5:
                arrs[StateKind.EXP_AVG] = arrs[StateKind.EXP_AVG] * np.float32(0.9)

    # ------------------------------------------------- chaos action handlers
    # Called by the controller (on whatever thread hit the fault point).
    def chaos_lose_ranks(self, rank: int) -> None:
        with self._env_lock:
            self._pending_rank_loss.append(int(rank))
        self.log.append(f"fault: rank {rank} lost")

    def chaos_lose_storage(self) -> None:
        """Storage-root loss of the newest committed step.  No-ops unless an
        older committed step survives — total storage loss plus a process
        crash is unrecoverable by construction, and an unrecoverable seed
        proves nothing about the ladder."""
        mgr = self.mgr
        if mgr is None:
            return
        with self._env_lock:
            steps = mgr.steps()
            if len(steps) < 2:
                self.log.append("fault: lose_storage no-op (sole committed step)")
                return
            victim = mgr.step_dir(steps[-1])
            shutil.rmtree(victim, ignore_errors=True)
            shutil.rmtree(Path(str(victim) + ".ucp"), ignore_errors=True)
            for eng in mgr._engines.values():
                eng.invalidate(victim)
                eng.invalidate(str(victim) + ".ucp")
            mgr._refs_cache.pop(steps[-1], None)
            self._storage_lost = True
        self.log.append(f"fault: storage lost newest committed step {steps[-1]}")

    def chaos_poison_peer(self) -> None:
        with self.registry._lock:
            candidates = sorted(
                (skey, held[0])
                for skey, held in self.registry._holders.items()
                if held and skey in self.registry._store
            )
        if not candidates:
            self.log.append("fault: poison_peer no-op (empty peer store)")
            return
        skey, holder = candidates[self._rng.randrange(len(candidates))]
        self.registry.poison_holder(holder, skey)
        self.log.append(f"fault: poisoned {holder}'s copy of {skey.split('@')[0]}")

    def chaos_skew_clock(self, seconds: float) -> None:
        clock.skew(seconds)
        self.log.append(f"fault: clock skewed by {seconds:+}s")

    # -------------------------------------------------------------- recovery
    def _expected_failure(self, err: BaseException, ctrl) -> bool:
        """A non-FaultError save failure that a scheduled destructive fault
        legitimately causes (the process would die there: crash-equivalent).
        """
        destructive = {"lose_storage", "lose_ranks"} & ctrl.fired_actions()
        return bool(destructive) and isinstance(
            err, (RuntimeError, ValueError, OSError, KeyError)
        )

    def _save(self, step: int) -> None:
        """``mgr.save`` of ``step``, background fault points held meanwhile
        (:class:`_SaveGate`)."""
        self._saved.clear()
        try:
            self.mgr.save(self._train_state(step), step)
        finally:
            self._saved.set()

    def _recover_from_crash(self, err: BaseException) -> list[Violation]:
        """Simulated process death: host memory (hot tier, async queues) is
        gone; rebuild over the same root + registry and resume through the
        ladder.  Recovery itself can be hit by the next armed fault — each
        such hit is another death, so retry a bounded number of times."""
        self.log.append(f"crash: {type(err).__name__}: {err}")
        for attempt in range(4):
            mgr, self.mgr = self.mgr, None
            if mgr is not None:
                try:
                    mgr.close()  # drains queues; errors died with the process
                except BaseException:  # repro: allow[except-discipline] -- simulated-dead process: whatever close() raises died with it
                    pass
            self.mgr = self._build_manager()
            try:
                res = self.mgr.restore_latest(
                    self.device, target_plan=self.tgt_plan, verify=True
                )
            except BaseException as e:  # repro: allow[except-discipline] -- injected faults surface as arbitrary types; _is_fault classifies the cause chain
                if _is_fault(e):
                    self.log.append(f"crash during recovery (attempt {attempt})")
                    continue
                return [Violation(
                    "restore",
                    f"recovery restore raised {type(e).__name__}: {e}")]
            break
        else:
            return [Violation("restore", "recovery kept crashing (4 attempts)")]
        if res is None:
            return [Violation(
                "resume", "crash recovery found no committed checkpoint "
                          "(bootstrap committed one)")]
        state, info = res
        self.log.append(f"recovered at step {info.step} via {info.mode.value}")
        ref = self.references.get(info.step)
        if ref is None:
            return [Violation(
                "restore", f"recovered step {info.step} has no recorded "
                           "reference (committed a step never saved?)")]
        diffs = diff_snapshots(snapshot_state(state), ref)
        if diffs:
            return [Violation(
                "restore", f"post-crash restore of step {info.step} not "
                           f"bit-identical: {d}") for d in diffs[:5]]
        # Continue training from exactly what the ladder served.
        self._snap = copy.deepcopy(ref)
        return []

    def _apply_rank_loss(self) -> list[Violation]:
        with self._env_lock:
            ranks, self._pending_rank_loss = self._pending_rank_loss, []
        if not ranks or self.mgr is None:
            return []
        event = ElasticEvent(
            healthy_devices=4, reason="failure", failed_ranks=tuple(sorted(ranks))
        )
        try:
            res = hot_recover(
                self.mgr, event, self.device, target_plan=self.tgt_plan
            )
        except BaseException as e:  # repro: allow[except-discipline] -- injected faults surface as arbitrary types; _is_fault classifies the cause chain
            if _is_fault(e):
                return self._recover_from_crash(e)
            return [Violation(
                "restore",
                f"rank-loss recovery raised {type(e).__name__}: {e}")]
        if res is None:
            return [Violation(
                "resume", f"no tier could serve after losing ranks {ranks}")]
        state, info = res
        self.log.append(
            f"rank loss {ranks}: recovered step {info.step} via {info.mode.value}"
        )
        ref = self.references.get(info.step)
        if ref is None:
            return [Violation(
                "restore", f"rank-loss recovery step {info.step} has no reference")]
        diffs = diff_snapshots(snapshot_state(state), ref)
        if diffs:
            return [Violation(
                "restore", f"rank-loss restore of step {info.step} differs: {d}")
                for d in diffs[:5]]
        self._snap = copy.deepcopy(ref)
        return []

    def _sync_replica(self) -> list[Violation]:
        if self.replica is None:
            self._replica_seq += 1
            self.replica = FleetReplica(
                f"rep{self._replica_seq}", self.registry, self.tgt_plan,
                self.device, engine=self.replica_engine,
            )
        try:
            self.replica.sync()
        except BaseException as e:  # repro: allow[except-discipline] -- injected faults surface as arbitrary types; _is_fault classifies the cause chain
            if _is_fault(e):
                # the replica process died mid-stream; a fresh one rejoins
                self.log.append("replica crashed mid-fetch; replaced")
                self.replica = None
                return []
            with self._env_lock:
                storage_lost = self._storage_lost
            if storage_lost:
                # the published step's disk fallback was the storage we lost;
                # the fleet heals at the next successful publish
                self.log.append(f"replica sync degraded after storage loss: {e}")
                self.replica = None
                return []
            return [Violation(
                "registry", f"replica sync raised {type(e).__name__}: {e}")]
        return []

    def _verify_restore(self, event: int) -> list[Violation]:
        """Bit-identity spot check: restore the newest committed step onto
        the 1x1 target (a real reshard) and compare against the reference;
        a seeded minority of events forces the VIA_UCP fallback tier too."""
        assert self.mgr is not None
        step = self.mgr.latest_step()
        if step is None:
            return []  # resume check already decided if this is a violation
        force = ResumeMode.VIA_UCP if self._rng.random() < 0.25 else None
        try:
            res = self.mgr.restore(
                self.device, step=step, target_plan=self.tgt_plan,
                force_mode=force,
            )
        except BaseException as e:  # repro: allow[except-discipline] -- injected faults surface as arbitrary types; _is_fault classifies the cause chain
            if _is_fault(e):
                return self._recover_from_crash(e)
            return [Violation(
                "restore",
                f"restore of committed step {step} raised "
                f"{type(e).__name__}: {e}")]
        if res is None:
            return [Violation("restore", f"step {step} vanished mid-check")]
        state, info = res
        ref = self.references.get(step)
        if ref is None:
            return [Violation("restore", f"committed step {step} has no reference")]
        out = [
            Violation(
                "restore",
                f"event {event}: step {step} via {info.mode.value} differs: {d}")
            for d in diff_snapshots(snapshot_state(state), ref)[:5]
        ]
        if int(info.scalars.get("step", -1)) != step:
            out.append(Violation(
                "restore", f"step {step}: manifest scalars carry "
                           f"step={info.scalars.get('step')}"))
        return out

    # ------------------------------------------------------------------- run
    def run(self) -> ChaosReport:
        violations: list[Violation] = []
        error: str | None = None
        completed = 0
        # Record the run's timeline: reuse an already-enabled tracer (the
        # caller is tracing a bigger picture), else enable a private one so
        # every ChaosReport carries its timeline unconditionally.
        tracer = obs.active()
        own_tracer = tracer is None
        if own_tracer:
            tracer = obs.enable()
        try:
            clock.reset()
            # Bootstrap fault-free: commit at least one step so "some tier
            # always serves" is a meaningful promise when faults start.
            self.mgr = self._build_manager()
            gate = _SaveGate(threading.current_thread(), self._saved)
            with gate:
                for step in (10, 20):
                    self.references[step] = copy.deepcopy(self._snap)
                    self._save(step)
                    self.mgr.wait()
                    self._advance(step)
            assert self.mgr.latest_step() is not None, "bootstrap never committed"
            with _SaveGatedController(self.schedule, env=self, gate=gate) as ctrl:
                for event in range(1, self.events + 1):
                    step = 10 * (event + 2)
                    self._advance(event)
                    self.references[step] = copy.deepcopy(self._snap)
                    crash: BaseException | None = None
                    try:
                        self._save(step)
                        self.mgr.wait()
                    except BaseException as e:  # repro: allow[except-discipline] -- faults vs real bugs split by _is_fault/_expected_failure; real bugs re-raise
                        if _is_fault(e) or self._expected_failure(e, ctrl):
                            crash = e
                        else:
                            raise
                    if crash is not None:
                        violations += self._recover_from_crash(crash)
                    violations += self._apply_rank_loss()
                    violations += self._sync_replica()
                    with self._env_lock:
                        storage_lost = self._storage_lost
                    if storage_lost and self.mgr.latest_step() is not None:
                        # a fresh commit re-arms the disk fallback tier
                        pub = self.registry.current()
                        if pub is not None and pub.checkpoint.is_committed:
                            with self._env_lock:
                                self._storage_lost = False
                    found = check_invariants(self.mgr, registry=self.registry)
                    obs.event(
                        "chaos.invariant_check", event=event,
                        violations=len(found),
                    )
                    violations += found
                    violations += self._verify_restore(event)
                    if violations:
                        break
                    completed = event
                self.log.append(f"fired: {ctrl.describe()}")
        except BaseException as e:  # repro: allow[except-discipline] -- sweep must always produce a report; the error field carries the failure
            error = f"{type(e).__name__}: {e}"
        finally:
            clock.reset()
            mgr, self.mgr = self.mgr, None
            if mgr is not None:
                try:
                    mgr.close()
                except BaseException:  # repro: allow[except-discipline] -- teardown after the run is scored; background errors already classified
                    pass
            self.replica_engine.close()
            if own_tracer:
                obs.disable(tracer)
        return ChaosReport(
            ok=error is None and not violations,
            seed=self.seed,
            config=self.config,
            schedule=self.schedule,
            events_completed=completed,
            violations=[str(v) for v in violations],
            error=error,
            log=self.log,
            timeline=tracer.timeline(),
        )
