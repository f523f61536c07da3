"""Seed sweeps, failing-schedule shrinking, and regression-test emission
(port of ``repro.chaos.sweep``).

The nightly lane runs :func:`sweep` over a bounded seed batch.  When a
seed falls, :func:`shrink` reduces its schedule to the *minimal failing
prefix* — sound because the controller replays any prefix identically to
how it played inside the longer schedule (hit counters baseline per armed
fault; see :mod:`repro_torch.chaos.schedule`) — and :func:`emit_regression_test`
renders that prefix as a ready-to-paste pytest function pinning the exact
fault list, so the fallen seed becomes a permanent deterministic test
instead of a flaky nightly memory.

The harness's state lives on ``device`` (a card by default); the emitted
regression test runs on the CPU, as the tier-1 tests do.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
from pathlib import Path
from typing import Iterable

from .harness import ChaosHarness, ChaosReport
from .schedule import Schedule

__all__ = ["SweepResult", "emit_regression_test", "run_seed", "shrink", "sweep"]


def run_seed(
    seed: int,
    *,
    events: int = 12,
    schedule: Schedule | None = None,
    root: str | Path | None = None,
    device: str = "cuda",
) -> ChaosReport:
    """One seed, one report, with the harness's state on ``device``.
    ``root=None`` runs in a scratch directory removed afterwards (pass a
    path to keep the wreckage for autopsy)."""
    scratch = None
    if root is None:
        scratch = tempfile.mkdtemp(prefix=f"chaos_seed{seed}_")
        root = Path(scratch) / "run"
    try:
        return ChaosHarness(seed, root, events=events, schedule=schedule, device=device).run()
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)


@dataclasses.dataclass
class SweepResult:
    reports: list[ChaosReport]

    @property
    def failed(self) -> list[ChaosReport]:
        return [r for r in self.reports if not r.ok]

    @property
    def ok(self) -> bool:
        return not self.failed

    def describe(self) -> str:
        n = len(self.reports)
        if self.ok:
            return f"chaos sweep: {n}/{n} seeds passed the ladder invariant"
        lines = [f"chaos sweep: {len(self.failed)}/{n} seeds FAILED"]
        lines += [r.describe() for r in self.failed]
        return "\n".join(lines)


def sweep(seeds: Iterable[int], *, events: int = 12, device: str = "cuda") -> SweepResult:
    return SweepResult([run_seed(s, events=events, device=device) for s in seeds])


def shrink(report: ChaosReport, *, events: int | None = None,
           device: str = "cuda") -> ChaosReport:
    """Reduce a failing seed's schedule to its minimal failing prefix.

    Walks prefix lengths upward and returns the report of the first
    (shortest) prefix that still fails — every fault it lists is necessary
    in the sense that stopping one earlier makes the run pass.  Returns
    the original report unchanged if it passed, or if (rarely) no prefix
    reproduces — a failure that needs the *tail* faults is already minimal.
    """
    if report.ok:
        return report
    events = events if events is not None else max(report.events_completed + 1, 4)
    for n in range(len(report.schedule) + 1):
        trial = run_seed(
            report.seed, events=events, schedule=report.schedule.prefix(n), device=device
        )
        if not trial.ok:
            return trial
    return report


def emit_regression_test(report: ChaosReport, *, events: int | None = None) -> str:
    """Render a failing report as pytest source replaying its exact
    schedule on the CPU.  Paste into ``tests/test_torch_chaos.py`` (or
    anywhere on the tier-1 path); the test fails until the underlying bug
    is fixed."""
    events = events if events is not None else max(report.events_completed + 1, 4)
    faults = ",\n        ".join(
        f"FaultSpec(point={f.point!r}, action={f.action!r}, "
        f"hit={f.hit}, args={tuple(f.args)!r})"
        for f in report.schedule.faults
    )
    why = "; ".join(report.violations[:2]) or (report.error or "unknown failure")
    return f'''\
def test_chaos_seed_{report.seed}_regression(tmp_path):
    """Shrunk from a fallen chaos sweep seed ({why})."""
    from repro_torch.chaos.harness import ChaosHarness
    from repro_torch.chaos.schedule import FaultSpec, Schedule

    schedule = Schedule(seed={report.seed}, faults=(
        {faults},
    ))
    report = ChaosHarness(
        {report.seed}, tmp_path / "run", events={events}, schedule=schedule, device="cpu"
    ).run()
    assert report.ok, report.describe()
'''


def failing_artifact(
    result: SweepResult, *, shrunk: "dict[int, ChaosReport] | None" = None
) -> dict:
    """JSON-serializable record of a sweep's failures (the CI artifact).

    Each failure carries the obs timeline of the *failing run* — the
    time-ordered spans, fault-point hits and invariant checks the harness
    recorded — so an offline reader sees exactly what the ladder did
    before the violation, not just the schedule that provoked it.  When
    ``shrunk`` maps a seed to its minimal-prefix replay, that replay's
    schedule and timeline are attached instead (shorter, and the prefix
    is what the emitted regression test pins)."""
    failures = []
    for r in result.failed:
        best = (shrunk or {}).get(r.seed, r)
        failures.append(
            {
                "seed": r.seed,
                "config": best.config,
                "schedule": best.schedule.to_json(),
                "events_completed": best.events_completed,
                "violations": best.violations,
                "error": best.error,
                "log": best.log[-20:],
                "timeline": best.timeline[-400:],
            }
        )
    return {
        "failed_seeds": [r.seed for r in result.failed],
        "total_seeds": len(result.reports),
        "failures": failures,
    }
