"""The ladder invariant, as executable checks (port of
``repro.chaos.invariants``).

UCP's core promise is that after *any* single fault, some checkpoint tier
still serves a committed step, restoring it reproduces the exact saved
state, and nothing a live manifest references has been collected.  This
module walks the actual on-disk / in-memory / registry state of a
:class:`~repro_torch.ckpt.manager.CheckpointManager` and returns every way that
promise is currently broken, as :class:`Violation` records.

Checks, in ladder order:

* **disk** — every committed step directory has a readable manifest, its
  whole delta chain resolves to *committed* ancestor directories (the
  GC-pinning invariant: a collected base under a live delta shows up
  here), and ``validate()`` finds every shard file present with matching
  content digests;
* **resume** — ``plan_resume`` produces a mode for the newest committed
  step against the manager's own plan (the "some tier always serves"
  half; hot-tier coverage counts when the disk set is empty);
* **hot** — every ring snapshot's surviving fragments digest-verify, and
  a snapshot that lost fragments to rank failures knows it
  (``missing_fragments``) instead of silently serving holes;
* **registry** — the peer store is consistent: every holder list points
  at stored bytes, and every stored content key is live under the current
  publication (publish-time store GC did not leak or over-collect).

Bit-identity of an actual restore needs a reference snapshot and a device
to restore onto, so it lives in the harness (``ChaosHarness._verify_restore``)
— but the array comparison itself, :func:`diff_snapshots`, is here so the
harness and the regression tests agree on what "identical" means
(bit-exact per shard, same key set; tensors are compared by their host
bytes).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.dist_ckpt import DistCheckpoint
from repro_torch.core.plan import TargetSpec, plan_resume

__all__ = [
    "InvariantViolation",
    "Violation",
    "check_invariants",
    "diff_snapshots",
]


@dataclasses.dataclass(frozen=True)
class Violation:
    check: str  # "disk" | "resume" | "hot" | "registry" | "restore"
    detail: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.detail}"


class InvariantViolation(AssertionError):
    """Raised by :func:`check_invariants` in ``strict`` mode."""

    def __init__(self, violations: list[Violation]):
        self.violations = violations
        super().__init__(
            f"{len(violations)} ladder-invariant violation(s):\n"
            + "\n".join(f"  {v}" for v in violations)
        )


def _check_disk(manager) -> list[Violation]:
    out: list[Violation] = []
    for step in manager.steps():
        root = manager.step_dir(step)
        try:
            ckpt = DistCheckpoint.open(root)
        except (OSError, ValueError, KeyError) as e:
            out.append(Violation(
                "disk", f"step {step} committed but unreadable: "
                        f"{type(e).__name__}: {e}"))
            continue
        for chain_root in ckpt.chain_roots():
            if not (chain_root / "COMMIT").exists():
                out.append(Violation(
                    "disk",
                    f"step {step} references {chain_root.name} which is "
                    "missing or uncommitted (live base collected?)"))
        problems = ckpt.validate()
        for p in problems[:5]:
            out.append(Violation("disk", f"step {step}: {p}"))
        if len(problems) > 5:
            out.append(Violation(
                "disk", f"step {step}: ... {len(problems) - 5} more problems"))
    return out


def _check_resume(manager) -> list[Violation]:
    step = manager.latest_step()
    if step is None:
        hot = getattr(manager, "hot", None)
        if hot is not None and any(
            s.is_complete() for s in hot.snapshots()
        ):
            return []  # the hot tier alone can serve
        return [Violation(
            "resume", "no committed step on disk and no complete hot "
                      "snapshot — nothing on the ladder can serve")]
    try:
        ckpt = DistCheckpoint.open(manager.step_dir(step))
        target = TargetSpec(manager.plan.mesh, manager.plan.param_specs)
        rp = plan_resume(ckpt.manifest, target)
    except Exception as e:  # repro: allow[except-discipline] -- any planning failure IS the finding: report it as a resume violation
        return [Violation(
            "resume",
            f"plan_resume failed for newest committed step {step}: "
            f"{type(e).__name__}: {e}")]
    if rp.mode is None:
        return [Violation("resume", f"no resume mode for step {step}")]
    return []


def _check_hot(manager) -> list[Violation]:
    out: list[Violation] = []
    hot = getattr(manager, "hot", None)
    if hot is None:
        return out
    for snap in hot.snapshots():
        for p in snap.verify()[:5]:
            out.append(Violation("hot", f"snapshot step {snap.step}: {p}"))
        missing = set(snap.missing_fragments())
        for name, kv, f in snap.fragments():
            if f"{name}@{kv} owner {f.owner}" in missing:
                out.append(Violation(
                    "hot",
                    f"snapshot step {snap.step}: fragment {name}@{kv} is "
                    "both live and reported missing"))
    return out


def _check_registry(registry) -> list[Violation]:
    out: list[Violation] = []
    if registry is None:
        return out
    pub = registry.current()
    with registry._lock:  # the simulation registry is in-process; a
        # consistent cut needs its own lock (test-side introspection only)
        store = set(registry._store)
        holders = {k: list(v) for k, v in registry._holders.items()}
    for skey, held in holders.items():
        if held and skey not in store:
            out.append(Violation(
                "registry", f"holders registered for {skey} but no stored "
                            "bytes (holder list leaked past store GC)"))
    if pub is not None:
        live = {f"{k}@{d}" for k, d in pub.digests.items()}
        for skey in store - live:
            out.append(Violation(
                "registry",
                f"store holds {skey} not referenced by publication "
                f"seq {pub.seq} (publish-time GC missed it)"))
    return out


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def diff_snapshots(
    got: Mapping[str, Mapping],
    want: Mapping[str, Mapping],
) -> list[str]:
    """Bit-exact comparison of two ``snapshot_state``-shaped dicts
    (``{param: {StateKind: array}}``, numpy arrays or tensors on any
    device); returns human-readable diffs."""
    out: list[str] = []
    if set(got) != set(want):
        out.append(f"param sets differ: only-got={sorted(set(got) - set(want))} "
                   f"only-want={sorted(set(want) - set(got))}")
    for name in sorted(set(got) & set(want)):
        gk, wk = got[name], want[name]
        if set(gk) != set(wk):
            out.append(f"{name}: state kinds differ ({set(gk)} vs {set(wk)})")
        for kind in sorted(set(gk) & set(wk), key=str):
            g, w = _host(gk[kind]), _host(wk[kind])
            if g.shape != w.shape or g.dtype != w.dtype:
                out.append(
                    f"{name}@{kind}: shape/dtype {g.shape}/{g.dtype} "
                    f"vs {w.shape}/{w.dtype}")
            elif not np.array_equal(g, w):
                bad = int(np.sum(g != w))
                out.append(f"{name}@{kind}: {bad}/{g.size} elements differ")
    return out


def check_invariants(
    manager, *, registry=None, strict: bool = False
) -> list[Violation]:
    """Run every ladder check against the manager's current state.

    ``strict=True`` raises :class:`InvariantViolation` instead of
    returning a non-empty list (how the regression tests call it).
    """
    violations = (
        _check_disk(manager)
        + _check_resume(manager)
        + _check_hot(manager)
        + _check_registry(registry)
    )
    if strict and violations:
        raise InvariantViolation(violations)
    return violations
