"""Process-wide metrics registry: counters, gauges, latency histograms.

Design (DESIGN.md §6.1):

- A ``MetricsRegistry`` owns metric *families*; a family has a name, a
  help string, and a tuple of label names.  ``family.labels(v1, v2)``
  returns (creating on first use) the *child* holding the actual value
  for one label combination; a label-less family is its own child.
- Registration is idempotent: re-declaring a family with the same type
  and label names returns the existing one, so instrumented modules can
  declare their series at import time without coordination.  A
  conflicting re-declaration raises.
- ``enabled()`` gates every mutation.  Disabled, each instrument method
  returns after one module-attribute check — no locks, no allocation —
  so the off path costs nothing measurable.  Telemetry defaults ON:
  the registry is the source of truth for ``RuntimeStats`` counters.
- Exposition: ``render()`` emits Prometheus text format (``# HELP`` /
  ``# TYPE`` plus one line per series; histograms emit cumulative
  ``_bucket{le=...}`` series, ``_sum`` and ``_count``);
  ``snapshot()`` returns the same data as a JSON-serializable dict.

Host-side only: this module never imports torch and is safe to call from
any thread (a single registry RLock guards mutation; the WAL fsync
syncer thread observes histograms concurrently with the main thread).
"""

from __future__ import annotations

import math
import re
import threading
from contextlib import contextmanager
from typing import Iterator

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-oriented default buckets (seconds): 100us .. 30s, roughly 1-2-5.
DEFAULT_BUCKETS = (
    0.0001,
    0.00025,
    0.0005,
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
    30.0,
)

_enabled = True


def enable() -> None:
    """Turn metric collection on (the default)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn metric collection off; every instrument becomes a no-op."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextmanager
def disabled() -> Iterator[None]:
    """Temporarily disable collection (tests / parity harnesses)."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _series(name: str, labels: dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return f"{name}{{{inner}}}"


class _Family:
    """Shared family machinery: label-name validation + child cache."""

    kind = "untyped"

    def __init__(self, registry: MetricsRegistry, name: str, help: str,
                 labelnames: tuple[str, ...]):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: dict[tuple[str, ...], _Family] = {}
        if labelnames:
            for ln in labelnames:
                if not _LABEL_RE.match(ln):
                    raise ValueError(f"bad label name {ln!r}")
        else:
            self._children[()] = self
        self.labelvalues: tuple[str, ...] = ()

    def labels(self, *values: object) -> _Family:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label "
                f"values, got {len(values)}"
            )
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._registry._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._new_child()
                    child.labelvalues = key
                    child._family = self  # type: ignore[attr-defined]
                    self._children[key] = child
        return child

    def _new_child(self) -> _Family:
        return type(self)(self._registry, self.name, self.help, ())

    def _label_dict(self) -> dict[str, str]:
        fam = getattr(self, "_family", self)
        return dict(zip(fam.labelnames, self.labelvalues))

    def children(self) -> list[_Family]:
        if self.labelnames:
            return list(self._children.values())
        return [self]


class Counter(_Family):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, registry, name, help, labelnames=()):
        super().__init__(registry, name, help, labelnames)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        if n < 0:
            raise ValueError("counters only go up")
        with self._registry._lock:
            self._value += n

    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Gauge(_Family):
    """A value that can go up and down (depths, sizes, bounds)."""

    kind = "gauge"

    def __init__(self, registry, name, help, labelnames=()):
        super().__init__(registry, name, help, labelnames)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not _enabled:
            return
        with self._registry._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        with self._registry._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Histogram(_Family):
    """Fixed-bucket histogram; supports quantile estimation.

    Buckets are upper bounds (exclusive of +Inf, which is implicit).
    ``quantile(q)`` linearly interpolates within the bucket containing
    the q-th observation — exact enough for p50/p99 reporting without
    retaining samples.
    """

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames=(), buckets=None):
        super().__init__(registry, name, help, labelnames)
        self.buckets = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be sorted")
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def _new_child(self) -> Histogram:
        return Histogram(
            self._registry, self.name, self.help, (), buckets=self.buckets
        )

    def _bucket_index(self, v: float) -> int:
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, v: float, n: int = 1) -> None:
        """Record ``n`` observations of value ``v`` (n>1 amortizes the
        lock on per-query loops that group identical observations)."""
        if not _enabled:
            return
        i = self._bucket_index(v)
        with self._registry._lock:
            self._counts[i] += n
            self._sum += v * n
            self._count += n

    def value(self) -> float:
        return float(self._count)

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def quantile(self, q: float) -> float | None:
        """Estimate the q-th quantile (0<=q<=1) from bucket counts, or
        None when the histogram is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        total = self._count
        if total == 0:
            return None
        target = q * total
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            lo = self.buckets[i - 1] if i > 0 else 0.0
            hi = self.buckets[i] if i < len(self.buckets) else lo
            if cum + c >= target:
                frac = (target - cum) / c if c else 0.0
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.buckets[-1] if self.buckets else 0.0

    def _reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0


class MetricsRegistry:
    """Owns families; renders exposition; resettable for tests."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _register(self, cls, name, help, labelnames, **kw) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}"
                    )
                return fam
            fam = cls(self, name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None) -> Histogram:
        return self._register(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> _Family | None:
        return self._families.get(name)

    def reset(self) -> None:
        """Zero every child value (families stay registered)."""
        with self._lock:
            for fam in self._families.values():
                for child in fam.children():
                    child._reset()

    def render(self) -> str:
        """Prometheus text exposition format, one block per family."""
        out: list[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    out.append(f"# HELP {name} {_escape(fam.help)}")
                out.append(f"# TYPE {name} {fam.kind}")
                for child in fam.children():
                    lbl = child._label_dict()
                    if isinstance(child, Histogram):
                        cum = 0
                        for i, ub in enumerate(
                            list(child.buckets) + [math.inf]
                        ):
                            cum += child._counts[i]
                            ble = dict(lbl)
                            ble["le"] = _fmt(ub)
                            out.append(
                                f"{_series(name + '_bucket', ble)} {cum}"
                            )
                        out.append(f"{_series(name + '_sum', lbl)} "
                                   f"{_fmt(child._sum)}")
                        out.append(f"{_series(name + '_count', lbl)} "
                                   f"{child._count}")
                    else:
                        out.append(
                            f"{_series(name, lbl)} {_fmt(child.value())}"
                        )
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-serializable snapshot of every series."""
        snap: dict[str, dict] = {}
        with self._lock:
            for name, fam in self._families.items():
                series = []
                for child in fam.children():
                    entry: dict = {"labels": child._label_dict()}
                    if isinstance(child, Histogram):
                        entry["count"] = child._count
                        entry["sum"] = child._sum
                        entry["buckets"] = {
                            _fmt(ub): child._counts[i]
                            for i, ub in enumerate(child.buckets)
                            if child._counts[i]
                        }
                        inf_n = child._counts[len(child.buckets)]
                        if inf_n:
                            entry["buckets"]["+Inf"] = inf_n
                    else:
                        entry["value"] = child.value()
                    series.append(entry)
                snap[name] = {"type": fam.kind, "help": fam.help,
                              "series": series}
        return snap


# The process-wide registry every instrumented module declares into.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(), buckets=None) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def render() -> str:
    return REGISTRY.render()


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()


# --- exposition schema check (shared by tests and scripts/obs_smoke.py) ---

_HELP_LINE = re.compile(r"^# HELP [a-zA-Z_:][a-zA-Z0-9_:]* .*$")
_TYPE_LINE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (counter|gauge|histogram)$"
)
_SAMPLE_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r" (-?\d+(\.\d+)?([eE][+-]?\d+)?|\+Inf|-Inf|NaN)$"
)


def validate_exposition(text: str) -> list[str]:
    """Validate Prometheus text exposition; returns a list of problems
    (empty = valid).  Checks line grammar, that every sample belongs to
    a family announced by a ``# TYPE`` line, and histogram completeness
    (``_bucket``/``_sum``/``_count`` all present, ``le="+Inf"`` last)."""
    problems: list[str] = []
    typed: dict[str, str] = {}
    sampled: set[str] = set()
    for ln, line in enumerate(text.splitlines(), start=1):
        if not line:
            continue
        if line.startswith("# HELP "):
            if not _HELP_LINE.match(line):
                problems.append(f"line {ln}: malformed HELP: {line!r}")
            continue
        if line.startswith("# TYPE "):
            m = _TYPE_LINE.match(line)
            if not m:
                problems.append(f"line {ln}: malformed TYPE: {line!r}")
            else:
                typed[m.group(1)] = m.group(2)
            continue
        if line.startswith("#"):
            problems.append(f"line {ln}: unknown comment: {line!r}")
            continue
        m = _SAMPLE_LINE.match(line)
        if not m:
            problems.append(f"line {ln}: malformed sample: {line!r}")
            continue
        sname = m.group(1)
        base = sname
        for suffix in ("_bucket", "_sum", "_count"):
            if sname.endswith(suffix) and sname[: -len(suffix)] in typed:
                base = sname[: -len(suffix)]
        if base not in typed:
            problems.append(f"line {ln}: sample {sname!r} has no TYPE line")
        else:
            sampled.add(base)
            if typed[base] == "histogram" and base == sname:
                problems.append(
                    f"line {ln}: bare histogram sample {sname!r}"
                )
    for base, kind in typed.items():
        if kind == "histogram" and base in sampled:
            if 'le="+Inf"' not in text:
                problems.append(f"histogram {base!r} missing +Inf bucket")
    return problems
