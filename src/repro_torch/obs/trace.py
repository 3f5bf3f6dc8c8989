"""Structured span/event tracer with Chrome/Perfetto ``trace_event`` export,
the port's copy of ``repro.obs.trace``.

Spans are emitted at every stage boundary of the capture->shadow pipeline
(step compute, bucket pack, channel send, per-frame fabric traversal,
shadow apply, resync, recovery). Two *clock domains* live on separate
process tracks in the export:

* ``pid 1`` — **host wall clock**: spans timed with the tracer's injected
  clock (`ManualClock` for deterministic golden traces). The default is
  ``time.time``, the clock (``CLOCK_REALTIME``) that ``torch.profiler``
  stamps its records with: a span's start in epoch nanoseconds is
  ``base_ns + ts * 1000``, so spans and a device trace share one time
  base, and each device operation can be placed in the span open when it
  was launched.
* ``pid 2`` — **simulated fabric time**: the event-driven simulator's
  virtual timestamps (`Frame.t_send`/``t_arrive``, `FabricResult
  .duration_s`). Each fabric iteration is laid out after the previous one
  via ``fabric_advance``, so a multi-step run reads as a contiguous
  virtual-time timeline.

The tracer is *near-zero-cost when disabled*: ``span()`` returns one
shared no-op context manager and ``instant``/``fabric_span`` return
immediately, so hot paths may call them unconditionally. ``maxlen`` makes
the event buffer a ring that keeps only the trailing trace window.
``threads`` maps each host track to the ids (``threading.get_ident``, the
``pthread_t`` whose low 32 bits the profiler records as a runtime call's
thread) of the threads that emitted on it: a launch from one of a shadow
track's threads is the shadow's.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Optional

HOST_PID = 1
FABRIC_PID = 2
_PROCESS_NAMES = {HOST_PID: "host (wall clock)",
                  FABRIC_PID: "fabric (simulated time)"}


class ManualClock:
    """Deterministic logical clock: every read advances by ``tick``.

    Makes trace output a pure function of the traced code path (golden
    deterministic exports in tests), at the cost of spans measuring call
    counts, not wall time.
    """

    def __init__(self, start: float = 0.0, tick: float = 1e-6):
        self._t = float(start)
        self._tick = float(tick)

    def __call__(self) -> float:
        t = self._t
        self._t = t + self._tick
        return t


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tr", "name", "track", "cat", "args", "t0")

    def __init__(self, tr, name, track, cat, args):
        self.tr = tr
        self.name = name
        self.track = track
        self.cat = cat
        self.args = args

    def __enter__(self):
        self.t0 = self.tr._clock()
        return self

    def __exit__(self, *exc):
        tr = self.tr
        tr._emit(self.name, HOST_PID, self.track, self.cat,
                 self.t0 - tr._t0, tr._clock() - tr._t0, self.args)
        return False


class Tracer:
    """Span/event collector; export() renders Chrome ``trace_event`` JSON.

    ``base_ns`` is the default clock's reading at the tracer's origin, in
    integer nanoseconds since the epoch (None under an injected clock or
    when disabled); ``threads`` maps each host track to the set of thread
    ids (``threading.get_ident``) that emitted on it.
    """

    def __init__(self, enabled: bool = True, clock=None,
                 maxlen: Optional[int] = None):
        self.enabled = enabled
        self.base_ns = None
        self.threads: dict[str, set] = {}
        if clock is None:
            self._clock = time.time
            if enabled:
                self.base_ns = time.time_ns()
            self._t0 = self.base_ns * 1e-9 if enabled else 0.0
        else:
            self._clock = clock
            self._t0 = clock() if enabled else 0.0
        self._events = deque(maxlen=maxlen)
        self._tracks: dict[tuple, int] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self.fabric_base_s = 0.0           # virtual-time offset of this step

    # -- emission ------------------------------------------------------------
    def _tid(self, pid: int, track: str) -> int:
        key = (pid, track)
        tid = self._tracks.get(key)
        if tid is None:
            with self._lock:
                tid = self._tracks.setdefault(key,
                                              len(self._tracks) + 1)
        return tid

    def _emit(self, name, pid, track, cat, t0_s, t1_s, args):
        with self._lock:
            self._seq += 1
            seq = self._seq
            if pid == HOST_PID:
                self.threads.setdefault(track, set()).add(
                    threading.get_ident())
        ev = {"name": name, "ph": "X", "cat": cat, "pid": pid,
              "tid": self._tid(pid, track),
              "ts": round(t0_s * 1e6, 3),
              "dur": round(max(t1_s - t0_s, 0.0) * 1e6, 3)}
        if args:
            ev["args"] = args
        ev["_seq"] = seq
        self._events.append(ev)

    # -- host clock domain ---------------------------------------------------
    def span(self, name: str, track: str = "train", cat: str = "host",
             args: Optional[dict] = None):
        """Context manager timing one host-side stage; no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, track, cat, args)

    def instant(self, name: str, track: str = "train", cat: str = "host",
                args: Optional[dict] = None):
        if not self.enabled:
            return
        t = self._clock() - self._t0
        self._emit(name, HOST_PID, track, cat, t, t, args)

    # -- fabric (simulated-time) clock domain --------------------------------
    def fabric_span(self, name: str, t0_s: float, t1_s: float,
                    track: str = "fabric", args: Optional[dict] = None):
        """One span on the simulated-time tracks, at this step's virtual
        offset. ``t0_s``/``t1_s`` are simulator timestamps within the
        current fabric iteration (e.g. ``Frame.t_send``/``t_arrive``)."""
        if not self.enabled:
            return
        base = self.fabric_base_s
        self._emit(name, FABRIC_PID, track, "fabric",
                   base + t0_s, base + t1_s, args)

    def fabric_advance(self, duration_s: float):
        """Lay the next fabric iteration after this one in virtual time."""
        self.fabric_base_s += max(duration_s, 0.0)

    # -- export --------------------------------------------------------------
    def events(self) -> list[dict]:
        """The raw buffered events (ring-truncated when ``maxlen`` is set),
        without export metadata, ordered and stripped of internals."""
        evs = sorted(self._events, key=lambda e: (e["pid"], e["tid"],
                                                  e["ts"], e["_seq"]))
        return [{k: v for k, v in e.items() if k != "_seq"} for e in evs]

    def export(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object (load via
        chrome://tracing or https://ui.perfetto.dev)."""
        meta = []
        pids = sorted({pid for pid, _ in self._tracks})
        for pid in pids:
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0,
                         "args": {"name": _PROCESS_NAMES.get(pid,
                                                             f"pid{pid}")}})
        for (pid, track), tid in sorted(self._tracks.items(),
                                        key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": track}})
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms"}

    def write(self, path):
        from pathlib import Path
        Path(path).write_text(json.dumps(self.export(), indent=1,
                                         sort_keys=True))
