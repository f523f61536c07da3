"""Deterministic fault schedules and the controller that replays them
(port of ``repro.chaos.schedule``; ``generate_schedule`` draws from
``random.Random(seed)`` in the reference's order, so one seed gives one
schedule in both packages).

A :class:`Schedule` is an ordered list of :class:`FaultSpec`s.  The
:class:`ChaosController` arms them strictly in order: only the head fault
is live, it fires when its point has been hit ``hit`` more times since it
was armed, and then the next fault arms.  Because arming is sequential
and hit counting restarts per armed fault, truncating a schedule to a
prefix changes *nothing* about how that prefix replays — which is what
makes shrink-to-minimal-prefix (:mod:`repro_torch.chaos.sweep`) sound.

Faults carry an action:

* ``crash``        — raise :class:`~repro_torch.chaos.points.FaultError` out of
  the fault point (the hitting thread dies exactly there; on a background
  saver/drainer thread this surfaces on the next ``wait()``).
* ``lose_ranks``   — args = rank ids whose host memory dies (hot-tier
  replica loss; the harness follows with an elastic recovery).
* ``lose_storage`` — delete the newest committed step directory out from
  under the run (storage-root loss).
* ``poison_peer``  — corrupt one holder's copy in the publication peer
  store (digest checks must catch it downstream).
* ``skew_clock``   — args = (seconds,): shift the injectable commit/GC
  clock (:mod:`repro_torch.core.clock`).
* ``pause``        — args = (gate,): block the hitting thread on a named
  gate until :meth:`ChaosController.release` — the deterministic
  interleaving primitive the race regression tests are written with.

``crash``/``pause`` execute inside the controller; every other action is
delegated to the environment (the harness, or a test) via ``env``, an
object with ``chaos_<action>(*args)`` methods.  Every firing is appended
to ``controller.log`` so a failing run can print exactly what it did.

``generate_schedule`` maps ``seed -> Schedule`` through a private
``random.Random(seed)``: the same seed always yields the same faults, so
a fallen seed in the nightly sweep replays exactly — locally, shrunk, and
finally as an emitted regression test.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Any, Iterable, Mapping, Sequence

import repro_torch.obs as obs

from .points import CATALOG, FaultError, activate, deactivate

__all__ = [
    "ACTIONS",
    "ChaosController",
    "FaultSpec",
    "Schedule",
    "generate_schedule",
]

# action name -> needs env handler (crash/pause are controller-internal)
ACTIONS: dict[str, bool] = {
    "crash": False,
    "pause": False,
    "lose_ranks": True,
    "lose_storage": True,
    "poison_peer": True,
    "skew_clock": True,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``action(*args)`` on the ``hit``-th hit of
    ``point`` counted from the moment this spec became armed."""

    point: str
    action: str = "crash"
    hit: int = 1
    args: tuple = ()

    def __post_init__(self):
        if self.point not in CATALOG:
            raise ValueError(
                f"unknown fault point {self.point!r}; catalog: {sorted(CATALOG)}"
            )
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r}; actions: {sorted(ACTIONS)}"
            )
        if self.hit < 1:
            raise ValueError(f"hit must be >= 1, got {self.hit}")

    def to_json(self) -> dict:
        return {
            "point": self.point,
            "action": self.action,
            "hit": self.hit,
            "args": list(self.args),
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "FaultSpec":
        return cls(
            point=str(d["point"]),
            action=str(d.get("action", "crash")),
            hit=int(d.get("hit", 1)),
            args=tuple(d.get("args", ())),
        )


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Seeded, ordered fault list (immutable; prefixes replay identically)."""

    seed: int
    faults: tuple[FaultSpec, ...]

    def __len__(self) -> int:
        return len(self.faults)

    def prefix(self, n: int) -> "Schedule":
        return Schedule(self.seed, self.faults[:n])

    def to_json(self) -> dict:
        return {"seed": self.seed, "faults": [f.to_json() for f in self.faults]}

    @classmethod
    def from_json(cls, d: Mapping) -> "Schedule":
        return cls(
            seed=int(d["seed"]),
            faults=tuple(FaultSpec.from_json(f) for f in d.get("faults", ())),
        )


def generate_schedule(
    seed: int,
    *,
    n_faults: int = 6,
    points: Sequence[str] | None = None,
    ranks: Iterable[int] = (0, 1, 2, 3),
) -> Schedule:
    """The deterministic ``seed -> ordered fault list`` map.

    ``points`` restricts generation to the fault points actually reachable
    under the run's configuration (e.g. ``drain.*`` never fires with the
    hot tier off, ``saver.*`` never fires with it on) — an unreachable
    armed fault would stall the rest of the schedule, wasting the seed.
    """
    rng = random.Random(seed)
    pool = list(points if points is not None else CATALOG)
    ranks = list(ranks)
    actions = [
        ("crash", 0.50),
        ("lose_ranks", 0.14),
        ("lose_storage", 0.12),
        ("poison_peer", 0.12),
        ("skew_clock", 0.12),
    ]
    faults = []
    for _ in range(n_faults):
        point = rng.choice(pool)
        r = rng.random()
        acc = 0.0
        action = actions[-1][0]
        for name, w in actions:
            acc += w
            if r < acc:
                action = name
                break
        if action == "lose_ranks":
            args: tuple = (rng.choice(ranks),)
        elif action == "skew_clock":
            args = (rng.choice([-7200, -600, 600, 7200]),)
        else:
            args = ()
        faults.append(
            FaultSpec(point=point, action=action, hit=rng.randint(1, 5), args=args)
        )
    return Schedule(seed, tuple(faults))


@dataclasses.dataclass
class FiredEvent:
    """One fault that actually fired (the schedule's observable trace)."""

    index: int  # position in the schedule
    spec: FaultSpec
    point_ctx: dict[str, Any]
    thread: str

    def __str__(self) -> str:
        ctx = ", ".join(f"{k}={v}" for k, v in self.point_ctx.items())
        return (
            f"#{self.index} {self.spec.action}{self.spec.args or ''} at "
            f"{self.spec.point}[hit {self.spec.hit}] ({ctx}) on {self.thread}"
        )


class ChaosController:
    """Replays one :class:`Schedule` against the active fault points.

    ``env`` provides ``chaos_<action>`` handlers for the environment
    actions (see module docstring); the harness is one such env, tests can
    pass their own.  Use as a context manager::

        with ChaosController(schedule, env=harness):
            ... drive the run ...
    """

    def __init__(self, schedule: Schedule, *, env: Any = None,
                 pause_timeout: float = 30.0):
        for spec in schedule.faults:
            if ACTIONS[spec.action] and not hasattr(env, f"chaos_{spec.action}"):
                raise ValueError(
                    f"schedule needs env.chaos_{spec.action} and env "
                    f"{env!r} does not provide it"
                )
        self.schedule = schedule
        self.env = env
        self.pause_timeout = float(pause_timeout)
        self.log: list[FiredEvent] = []  #: guarded by self._lock
        self.hits: dict[str, int] = {}  #: guarded by self._lock
        self._lock = threading.Lock()
        self._armed = 0  #: guarded by self._lock -- index of the live fault
        self._armed_at = 0  #: guarded by self._lock -- hits[point] when it became armed
        self._gates: dict[str, tuple[threading.Event, threading.Event]] = {}  #: guarded by self._lock

    # ------------------------------------------------------------- lifecycle
    def __enter__(self) -> "ChaosController":
        activate(self)
        return self

    def __exit__(self, *exc) -> None:
        self.release_all()  # never leave a paused thread stranded
        deactivate(self)

    # ----------------------------------------------------------- point sink
    def on_point(self, name: str, ctx: Mapping[str, Any]) -> None:
        # Every hit lands in the trace (no-op unless a tracer is enabled),
        # so a failing seed's timeline shows the hit sequence that armed
        # and fired each fault, interleaved with the lifecycle spans.
        obs.event("chaos.point", point=name)
        fired: FaultSpec | None = None
        with self._lock:
            self.hits[name] = self.hits.get(name, 0) + 1
            if self._armed < len(self.schedule.faults):
                spec = self.schedule.faults[self._armed]
                if (
                    spec.point == name
                    and self.hits[name] - self._armed_at >= spec.hit
                ):
                    fired = spec
                    self.log.append(
                        FiredEvent(
                            self._armed, spec, dict(ctx),
                            threading.current_thread().name,
                        )
                    )
                    self._armed += 1
                    if self._armed < len(self.schedule.faults):
                        nxt = self.schedule.faults[self._armed]
                        self._armed_at = self.hits.get(nxt.point, 0)
        if fired is None:
            return
        obs.event(
            "chaos.fault", point=name, action=fired.action,
            args=list(fired.args), hit=fired.hit,
        )
        # Execute OUTSIDE the lock: handlers touch manager/registry state and
        # other threads keep hitting fault points while a pause is parked.
        if fired.action == "crash":
            raise FaultError(f"injected crash at {name} ({dict(ctx)})")
        if fired.action == "pause":
            self._pause(str(fired.args[0]) if fired.args else "gate")
            return
        getattr(self.env, f"chaos_{fired.action}")(*fired.args)

    # ----------------------------------------------------------- pause gates
    def _gate(self, name: str) -> tuple[threading.Event, threading.Event]:
        with self._lock:
            if name not in self._gates:
                self._gates[name] = (threading.Event(), threading.Event())
            return self._gates[name]

    def _pause(self, name: str) -> None:
        reached, released = self._gate(name)
        reached.set()
        if not released.wait(self.pause_timeout):
            raise FaultError(f"pause gate {name!r} never released (deadlock guard)")

    def wait_paused(self, name: str, timeout: float = 30.0) -> None:
        """Block until some thread is parked on gate ``name``."""
        reached, _ = self._gate(name)
        if not reached.wait(timeout):
            raise TimeoutError(f"no thread reached pause gate {name!r}")

    def release(self, name: str) -> None:
        self._gate(name)[1].set()

    def release_all(self) -> None:
        with self._lock:
            gates = list(self._gates.values())
        for _, released in gates:
            released.set()

    # -------------------------------------------------------------- queries
    @property
    def fired(self) -> list[FaultSpec]:
        with self._lock:
            return [e.spec for e in self.log]

    def fired_actions(self) -> set[str]:
        with self._lock:
            return {e.spec.action for e in self.log}

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return self._armed >= len(self.schedule.faults)

    def describe(self) -> str:
        with self._lock:
            lines = [str(e) for e in self.log]
        if not lines:
            return "no faults fired"
        return "\n".join(lines)
