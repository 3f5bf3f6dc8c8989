"""Labeled metrics registry: counters, gauges, bounded histograms — the
port's copy of ``repro.obs.metrics``.

One `MetricsRegistry` unifies the scattered per-subsystem counters
(`ShadowNode` apply stats, checkpointer stall/resync accounting,
per-channel sends and wire bytes) behind a
single exposition surface: `snapshot()` returns a deterministic JSON-able
dict, `to_prometheus()` the text exposition format.

The registry is *near-zero-cost when disabled*: every instrument accessor
returns one shared no-op instrument whose methods do nothing, so a hot
path may write

    reg.counter("channel_sends_total").inc(1, channel=name)

unconditionally and pay only an attribute lookup + a no-op call when the
registry is off. Instrument state is guarded by a per-family lock, so
shadow worker threads can observe concurrently with the training thread.
"""
from __future__ import annotations

import bisect
import json
import threading
from typing import Optional

DEFAULT_BOUNDS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


class _NullInstrument:
    """Shared no-op stand-in handed out by a disabled registry."""
    __slots__ = ()

    def inc(self, value=1, **labels):
        pass

    def set(self, value, **labels):
        pass

    def observe(self, value, **labels):
        pass


NULL_INSTRUMENT = _NullInstrument()


def _key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Family:
    """One named metric family; children are keyed by sorted label tuples."""
    kind = "untyped"
    __slots__ = ("name", "help", "_data", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._data: dict = {}
        self._lock = threading.Lock()

    def labelsets(self) -> list[tuple]:
        with self._lock:
            return sorted(self._data)

    def _sample_value(self, raw):
        return raw

    def samples(self) -> list[dict]:
        with self._lock:
            items = sorted(self._data.items())
        return [{"labels": dict(k), **self._sample_value(v)}
                for k, v in items]


class Counter(_Family):
    kind = "counter"
    __slots__ = ()

    def inc(self, value=1, **labels):
        k = _key(labels)
        with self._lock:
            self._data[k] = self._data.get(k, 0) + value

    def value(self, **labels):
        return self._data.get(_key(labels), 0)

    def _sample_value(self, raw):
        return {"value": raw}


class Gauge(_Family):
    kind = "gauge"
    __slots__ = ()

    def set(self, value, **labels):
        with self._lock:
            self._data[_key(labels)] = value

    def inc(self, value=1, **labels):
        k = _key(labels)
        with self._lock:
            self._data[k] = self._data.get(k, 0) + value

    def value(self, **labels):
        return self._data.get(_key(labels), 0)

    def _sample_value(self, raw):
        return {"value": raw}


class Histogram(_Family):
    """Bounded histogram: fixed bucket bounds, exact count/sum, no sample
    retention — safe for long runs (unlike an unbounded list of applies)."""
    kind = "histogram"
    __slots__ = ("bounds",)

    def __init__(self, name: str, help: str = "",
                 bounds: tuple = DEFAULT_BOUNDS):
        super().__init__(name, help)
        self.bounds = tuple(sorted(bounds))

    def observe(self, value, **labels):
        k = _key(labels)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            st = self._data.get(k)
            if st is None:
                st = self._data[k] = {
                    "buckets": [0] * (len(self.bounds) + 1),
                    "sum": 0.0, "count": 0, "max": value}
            st["buckets"][i] += 1
            st["sum"] += value
            st["count"] += 1
            if value > st["max"]:
                st["max"] = value

    def _sample_value(self, raw):
        cum, out = 0, {}
        for bound, n in zip(self.bounds, raw["buckets"]):
            cum += n
            out[repr(bound)] = cum
        out["+Inf"] = cum + raw["buckets"][-1]
        return {"count": raw["count"], "sum": raw["sum"],
                "max": raw["max"], "buckets": out}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """The one place metrics live. ``enabled=False`` turns every accessor
    into a constant returning the shared no-op instrument."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help, **kw)
            elif not isinstance(fam, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{fam.kind}, not {cls.kind}")
            return fam

    def counter(self, name: str, help: str = "") -> Counter:
        if not self.enabled:
            return NULL_INSTRUMENT
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        if not self.enabled:
            return NULL_INSTRUMENT
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds: Optional[tuple] = None) -> Histogram:
        if not self.enabled:
            return NULL_INSTRUMENT
        return self._get(Histogram, name, help,
                         bounds=bounds or DEFAULT_BOUNDS)

    # -- exposition ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Deterministic JSON-able view: families sorted by name, samples
        by label tuple."""
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            out[name] = {"type": fam.kind, "help": fam.help,
                         "samples": fam.samples()}
        return {"metrics": out}

    def write_json(self, path):
        from pathlib import Path
        Path(path).write_text(json.dumps(self.snapshot(), indent=2,
                                         sort_keys=True))

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for s in fam.samples():
                lbl = ",".join(f'{k}="{v}"'
                               for k, v in sorted(s["labels"].items()))
                if fam.kind == "histogram":
                    for bound, cum in s["buckets"].items():
                        ble = (lbl + "," if lbl else "") + f'le="{bound}"'
                        lines.append(f"{name}_bucket{{{ble}}} {cum}")
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}_sum{suffix} {s['sum']}")
                    lines.append(f"{name}_count{suffix} {s['count']}")
                else:
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}{suffix} {s['value']}")
        return "\n".join(lines) + "\n"


def diff_snapshots(before: dict, after: dict) -> list[dict]:
    """Changed/new samples between two `snapshot()` dicts (or files the
    CLI loaded) — the trend-tracking primitive behind ``repro_torch.obs diff``."""

    def flat(snap):
        out = {}
        for name, fam in snap.get("metrics", {}).items():
            for s in fam["samples"]:
                lbl = tuple(sorted(s["labels"].items()))
                val = s.get("value", s.get("sum"))
                out[(name, lbl)] = val
        return out

    a, b = flat(before), flat(after)
    rows = []
    for key in sorted(set(a) | set(b)):
        va, vb = a.get(key), b.get(key)
        if va != vb:
            name, lbl = key
            rows.append({"metric": name, "labels": dict(lbl),
                         "before": va, "after": vb})
    return rows
