"""Span-based structured tracing + per-query "query cards".

Emits Chrome-trace-event JSON (load in Perfetto / ``chrome://tracing``):
every span becomes a complete event (``ph: "X"``) with microsecond
timestamps relative to the tracer epoch; query cards ride along under a
``queryCards`` top-level key (extra keys are legal in the trace format).

Two entry styles (DESIGN.md §6.2):

- ``with span("durability.snapshot", rows=n): ...`` — context-manager
  spans for code that is cheap to wrap.
- ``get_tracer().complete(name, t0, t1, **args)`` — retro-logged spans
  for hot paths that already collect ``perf_counter`` timestamps for
  metrics; no nesting rewrite, no overhead when tracing is off.

A *query card* is the per-batch accounting record the paper's claims
live or die on: which index key each query key routed to, the realized
elastic factor ``|S(L_q)|/|I_i|`` against the configured bound ``c``,
the segment span tier / Q-bucket / storage dtype the launch used, the
rerank shortlist size, tombstone density, and whether the batch
added a new device program (``recompiled``; the port has no program
cache yet, so it always reports False).

Tracing defaults OFF (it allocates one dict per span); enabling it
must not change search bits — everything here is plain host
Python.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any, Iterator

_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


MAX_EVENTS = 200_000
MAX_CARDS = 20_000


@dataclass
class QueryCard:
    """Per-batch routing/cost record (one card per routed query group)."""

    query_key: tuple[int, ...]
    selected_key: tuple[int, ...] | None
    n_queries: int
    elastic_factor: float | None  # |S(L_q)| / |I_i|; None for unseen keys
    bound: float | None  # configured c (None for SIS/unbounded)
    span_tier: int | None  # padded segment span the launch used
    q_bucket: int | None  # padded Q the launch used
    dtype: str | None  # arena scan dtype ("float32", "int8", ...)
    shortlist: int | None  # rerank shortlist k' (None: no rerank tier)
    tombstone_density: float | None  # dead / span rows (None: no bitmap)
    recompiled: bool  # batch added a device program (always False yet)
    backend: str = "flat"


class Tracer:
    """Collects complete events + query cards; caps and counts drops."""

    def __init__(self, max_events: int = MAX_EVENTS,
                 max_cards: int = MAX_CARDS):
        self._lock = threading.Lock()
        self.max_events = max_events
        self.max_cards = max_cards
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.events: list[dict[str, Any]] = []
            self.cards: list[QueryCard] = []
            self.dropped_events = 0
            self.dropped_cards = 0
            self.epoch = time.perf_counter()

    def _ts(self, t: float) -> float:
        return (t - self.epoch) * 1e6  # microseconds

    def complete(self, name: str, t0: float, t1: float,
                 **args: Any) -> None:
        """Retro-log a finished span from perf_counter endpoints."""
        if not _enabled:
            return
        ev = {
            "name": name,
            "ph": "X",
            "ts": self._ts(t0),
            "dur": max(0.0, (t1 - t0) * 1e6),
            "pid": 1,
            "tid": threading.get_ident() & 0xFFFF,
        }
        if args:
            ev["args"] = args
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped_events += 1
            else:
                self.events.append(ev)

    def instant(self, name: str, **args: Any) -> None:
        """Zero-duration marker (admission rejects, deadline misses...)."""
        if not _enabled:
            return
        t = time.perf_counter()
        self.complete(name, t, t, **args)

    def add_card(self, card: QueryCard) -> None:
        if not _enabled:
            return
        with self._lock:
            if len(self.cards) >= self.max_cards:
                self.dropped_cards += 1
            else:
                self.cards.append(card)

    def to_json(self) -> dict[str, Any]:
        with self._lock:
            return {
                "traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "queryCards": [asdict(c) for c in self.cards],
                "droppedEvents": self.dropped_events,
                "droppedCards": self.dropped_cards,
            }

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, default=_jsonable)


def _jsonable(o: Any) -> Any:
    if isinstance(o, tuple):
        return list(o)
    if hasattr(o, "item"):  # numpy scalars
        return o.item()
    return str(o)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def reset() -> None:
    _TRACER.reset()


class _Span:
    __slots__ = ("name", "args", "t0")

    def __init__(self, name: str, args: dict[str, Any]):
        self.name = name
        self.args = args

    def __enter__(self) -> _Span:
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _TRACER.complete(self.name, self.t0, time.perf_counter(),
                         **self.args)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _NullSpan()


def span(name: str, **args: Any) -> _Span | _NullSpan:
    """``with span("route", backend="flat"): ...`` — no-op when
    tracing is disabled (returns a shared null context manager)."""
    if not _enabled:
        return _NULL
    return _Span(name, args)


def iter_cards() -> Iterator[QueryCard]:
    return iter(list(_TRACER.cards))
