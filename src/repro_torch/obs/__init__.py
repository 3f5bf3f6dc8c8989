"""Tracing and metrics plane, the port's copy of ``repro.obs``.

One `Observability` holder pairs a `MetricsRegistry` with a `Tracer`; the
module-level active instance (default: fully disabled) is what every
instrumented hot path reads via `get()`:

    from repro_torch import obs
    ob = obs.get()
    with ob.tracer.span("channel.send", args={"step": step}):
        ...
    ob.metrics.counter("channel_sends_total").inc(1, channel=name)

Both calls are near-zero-cost no-ops until a session is installed:

    with obs.enabled_session() as ob:
        train(cfg, ..., device="cpu")
        ob.tracer.write("trace.json")        # Chrome/Perfetto JSON
        print(ob.metrics.to_prometheus())

The span and metric names are the JAX package's (docs/ARCHITECTURE.md,
docs/observability.md), the fabric's simulated-time spans and counters
included. The port adds spans of its training loop, each with the
``step`` it serves: ``data.batch`` (the batch drawn and placed on the
device), ``step.forward`` and ``step.backward`` (each microbatch's),
``step.optimizer`` (norm, clip and update) and, inside ``capture.d2h``,
``bucket.pack`` and ``capture.to_host`` (with the ``bytes`` copied off
the card). The default clock is the one ``torch.profiler`` stamps its
records with, so a device trace can be read span by span.

CLI: ``python -m repro_torch.obs {trace,summary,diff}``.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

from repro_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry,
                                     diff_snapshots)
from repro_torch.obs.trace import ManualClock, Tracer  # noqa: F401


@dataclass
class Observability:
    """One metrics registry + one tracer, enabled/disabled together."""
    metrics: MetricsRegistry
    tracer: Tracer

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled or self.tracer.enabled

    @classmethod
    def disabled(cls) -> "Observability":
        return cls(MetricsRegistry(enabled=False), Tracer(enabled=False))

    @classmethod
    def session(cls, clock=None,
                trace_maxlen: Optional[int] = None) -> "Observability":
        return cls(MetricsRegistry(),
                   Tracer(clock=clock, maxlen=trace_maxlen))


_ACTIVE = Observability.disabled()


def get() -> Observability:
    """The active observability plane (disabled no-op by default)."""
    return _ACTIVE


def install(ob: Observability) -> Observability:
    """Swap the active plane; returns the previous one (for restore)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, ob
    return prev


@contextmanager
def enabled_session(clock=None, trace_maxlen: Optional[int] = None):
    """Scoped fully-enabled plane; restores the previous one on exit."""
    ob = Observability.session(clock=clock, trace_maxlen=trace_maxlen)
    prev = install(ob)
    try:
        yield ob
    finally:
        install(prev)
