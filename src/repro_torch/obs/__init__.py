"""Host-side telemetry: metrics registry + structured tracing (DESIGN.md §6).

Everything in this package runs on the host in plain Python — no torch
imports and no device work.  The invariant carried over from the JAX
package: enabling telemetry changes zero search bits; disabling it
reduces every instrument to an attribute check.
"""

from . import metrics, trace
from .metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    render,
    snapshot,
    validate_exposition,
)
from .trace import QueryCard, Tracer, get_tracer, span

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "QueryCard",
    "Tracer",
    "counter",
    "gauge",
    "get_tracer",
    "histogram",
    "metrics",
    "render",
    "snapshot",
    "span",
    "trace",
    "validate_exposition",
]
