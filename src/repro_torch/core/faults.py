"""Deterministic fault injection (port of ``repro/core/faults.py``).

A *named fault point* sits inside the code under test —
``faultpoint("compact.mid_fold")`` inside a streaming compaction, between
the survivor computation and the fold.  A :class:`FaultPlan` arms a
subset of them (fire on the Nth hit, or probabilistically under a seeded
RNG — both deterministic given the seed) and an armed point raises a
typed :class:`InjectedFault`.

The registry is append-only at import time: a module that hosts a point
calls :func:`register_fault_point` at its top level, and hitting an
unregistered name is a hard error, so a new point cannot ship
unregistered.  This registry is the port's own: it shares no state with
the JAX package's, so arming a plan in one package never fires a point in
the other.

Zero overhead when disarmed: ``faultpoint`` is a dict lookup + one
``is None`` check.  Stdlib-only, so the hot paths that call it pay
nothing at import either.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random

# name -> one-line description of where the point sits
FAULT_POINTS: dict[str, str] = {}


class InjectedFault(RuntimeError):
    """Raised by an armed :func:`faultpoint` — the simulated crash."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"injected fault at {point!r} (hit #{hit})")
        self.point = point
        self.hit = hit


def register_fault_point(name: str, doc: str = "") -> str:
    """Register ``name`` (idempotent); returns it so hosts can keep the
    constant."""
    FAULT_POINTS[name] = doc or FAULT_POINTS.get(name, "")
    return name


@dataclasses.dataclass
class FaultRule:
    """When an armed point fires.

    ``nth``: fire on exactly the Nth hit (1-based) of this point.
    ``prob``: else, fire each hit with this probability (seeded RNG).
    ``times``: maximum number of fires before the rule disarms
    (``None`` = unlimited — e.g. a permanently-failing dependency).
    """

    nth: int | None = None
    prob: float = 0.0
    times: int | None = 1


class FaultPlan:
    """A seeded, deterministic schedule of fault firings.

    ``rules`` maps fault-point name -> :class:`FaultRule` (a bare int is
    shorthand for ``FaultRule(nth=n)``).  ``hits`` / ``fired`` expose the
    per-point counters for assertions.
    """

    def __init__(self, rules: dict[str, "FaultRule | int"], seed: int = 0):
        self.rules: dict[str, FaultRule] = {
            name: (FaultRule(nth=r) if isinstance(r, int) else r)
            for name, r in rules.items()
        }
        self._rng = random.Random(seed)
        self.hits: dict[str, int] = {}
        self.fired: dict[str, int] = {}

    def should_fire(self, name: str) -> bool:
        self.hits[name] = hit = self.hits.get(name, 0) + 1
        rule = self.rules.get(name)
        if rule is None:
            return False
        if rule.times is not None and self.fired.get(name, 0) >= rule.times:
            return False
        if rule.nth is not None:
            fire = hit == rule.nth
        else:
            fire = self._rng.random() < rule.prob
        if fire:
            self.fired[name] = self.fired.get(name, 0) + 1
        return fire


_ACTIVE: FaultPlan | None = None


def install_plan(plan: FaultPlan | None) -> None:
    """Arm ``plan`` globally (``None`` disarms).  Prefer the
    :func:`inject` context manager in tests."""
    global _ACTIVE
    _ACTIVE = plan


def active_plan() -> FaultPlan | None:
    return _ACTIVE


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm ``plan`` for the duration of the block."""
    install_plan(plan)
    try:
        yield plan
    finally:
        install_plan(None)


def faultpoint(name: str) -> None:
    """A named crash site.  No-op unless a plan is armed and its rule for
    ``name`` fires; hitting an unregistered name is a bug in the host
    module (register at import time)."""
    if name not in FAULT_POINTS:
        raise RuntimeError(f"unregistered fault point {name!r}; "
                           f"call register_fault_point at import time")
    plan = _ACTIVE
    if plan is not None and plan.should_fire(name):
        raise InjectedFault(name, plan.hits[name])
