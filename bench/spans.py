"""The program's spans on the device trace's clock: the span each device
operation was launched in, and the span the host was in while the device
sat idle.

``repro_torch.obs.Tracer`` stamps its spans with ``time.time`` from its
``base_ns``; ``torch.profiler`` stamps its records with the same clock
(``CLOCK_REALTIME``) from the file's ``baseTimeNanoseconds``. A span moves
onto the trace's time base by the difference of the two bases, with no
synchronisation and nothing recorded on the device.

A device operation belongs to the innermost span open when the runtime
call that launched it began, on the launching thread's side: a thread
that emitted spans (the trainer's, a shadow node's worker) sees the spans
of the tracks it emitted on; any other thread (autograd's device thread,
which launches the backward) sees the trainer's, the tracks of the thread
that launched the harness's markers. The profiler records a runtime
call's thread by the low 32 bits of its ``pthread_t`` (``kineto_tid``),
which the tracer's ``threads`` hold whole (``threading.get_ident``).
``attribute`` sweeps the launches in
time order, with one stack of open spans a track, in O(n log n).

``load`` reads a file that ``profile.export_chrome_trace`` wrote;
``phases`` gives the readings ``bench/phases.py`` prints. Times are
seconds on the trace's base.
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

from bench.trace import DEVICE_CATS, MARKER, gaps, union_s

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the step's phases, and the reading of each one's device time
PHASES = {"step.forward": "fwd_device_ms", "step.backward": "bwd_device_ms",
          "step.optimizer": "opt_device_ms"}


@dataclass
class Trace:
    """A device trace: every device operation by correlation id, and the
    runtime calls that launched them."""
    base_ns: int = 0
    ops: dict = field(default_factory=dict)   # corr -> (t0, t1, cat, name)
    launches: list = field(default_factory=list)   # (t, tid, corr), sorted
    marks: list = field(default_factory=list)      # (t0, corr), sorted

    @property
    def start(self) -> float:
        return self.marks[0][0]

    @property
    def end(self) -> float:
        return self.marks[-1][0]

    @property
    def main_tid(self):
        """The thread that launched the first marker: the trainer's."""
        first = self.marks[0][1]
        return next((tid for _, tid, c in self.launches if c == first), None)

    def window_ops(self) -> dict:
        """corr -> (t0, t1, cat, name) of every operation but the markers,
        clipped to the first and the last marker."""
        lo, hi = self.start, self.end
        return {c: (max(a, lo), min(b, hi), cat, name)
                for c, (a, b, cat, name) in self.ops.items()
                if b > lo and a < hi}


def load(path) -> Trace:
    """Parse a trace written by ``profile.export_chrome_trace``."""
    with open(path) as fh:
        doc = json.load(fh)
    tr = Trace(base_ns=int(doc.get("baseTimeNanoseconds", 0)))
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        corr = ev.get("args", {}).get("correlation")
        if corr is None:
            continue
        t0 = float(ev["ts"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "kernel" and MARKER in name:
            tr.marks.append((t0, corr))
        elif cat in DEVICE_CATS:
            tr.ops[corr] = (t0, t0 + float(ev["dur"]) * 1e-6, cat, name)
        elif cat in LAUNCH_CATS:
            tr.launches.append((t0, ev.get("tid"), corr))
    if len(tr.marks) < 2:
        raise ValueError("the trace lacks the harness's marker kernels")
    tr.marks.sort()
    tr.launches.sort()
    return tr


@dataclass
class Span:
    name: str
    track: str
    t0: float
    t1: float
    args: dict


def place(export: dict, base_ns: int, trace_base_ns: int) -> list[Span]:
    """The host spans of a tracer's ``export()`` on a trace's time base."""
    shift = (base_ns - trace_base_ns) * 1e-9
    tracks = {e["tid"]: e["args"]["name"] for e in export["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"
              and e["pid"] == 1}
    return [Span(e["name"], tracks[e["tid"]], shift + e["ts"] * 1e-6,
                 shift + (e["ts"] + e["dur"]) * 1e-6, e.get("args", {}))
            for e in export["traceEvents"]
            if e["ph"] == "X" and e["pid"] == 1]


def kineto_tid(ident: int) -> int:
    """The thread id the profiler's export gives a runtime call made on
    the thread whose ``threading.get_ident()`` is ``ident``: the magnitude
    of the low 32 bits of its ``pthread_t`` read as a signed integer
    (kineto's ``threadId()``; seen on an H100 host with torch 2.11)."""
    low = ident & 0xFFFFFFFF
    return (1 << 32) - low if low >> 31 else low


def attribute(trace: Trace, spans: list, threads: dict) -> dict:
    """corr -> the innermost span open at its launch on the launching
    thread's side (module docstring), or None; ``threads``: track -> the
    ids (``threading.get_ident``) of the threads that emitted on it."""
    by_track = {}
    for s in sorted(spans, key=lambda s: (s.t0, -s.t1)):
        by_track.setdefault(s.track, []).append(s)
    threads = {k: {kineto_tid(i) for i in ids} for k, ids in threads.items()}
    trainer = tuple(k for k, ids in threads.items()
                    if trace.main_tid in ids and k in by_track)
    sides = {}
    for k, ids in threads.items():
        for tid in ids:
            sides.setdefault(tid, []).append(k)
    stacks = {k: [] for k in by_track}
    nxt = dict.fromkeys(by_track, 0)
    out = {}
    for t, tid, corr in trace.launches:
        if corr not in trace.ops:
            continue
        best = None
        for k in sides.get(tid, trainer):
            if k not in by_track:
                continue
            seq, stack = by_track[k], stacks[k]
            while nxt[k] < len(seq) and seq[nxt[k]].t0 <= t:
                stack.append(seq[nxt[k]])
                nxt[k] += 1
            while stack and stack[-1].t1 < t:
                stack.pop()
            if stack and (best is None or stack[-1].t0 > best.t0):
                best = stack[-1]
        out[corr] = best
    return out


def merge(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint ones, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_in(ops: dict, lo: float, hi: float, spans: list) -> float:
    """Seconds of [lo, hi] in which none of ``ops`` (corr -> (t0, t1, ...))
    ran on any stream while one of ``spans`` was open."""
    cover = merge((max(s.t0, lo), min(s.t1, hi)) for s in spans
                  if s.t1 > lo and s.t0 < hi)
    starts = [a for a, _ in cover]
    ends = [b for _, b in cover]
    total = 0.0
    for g0, g1 in gaps([op[:2] for op in ops.values()], lo, hi):
        for a, b in cover[bisect.bisect_right(ends, g0):
                          bisect.bisect_left(starts, g1)]:
            total += min(b, g1) - max(a, g0)
    return total


def _inside(t: float, s: Span) -> float:
    """How far ``t`` lies inside ``s`` (negative: outside)."""
    return min(t - s.t0, s.t1 - t)


def phases(trace: Trace, export: dict, base_ns: int, threads: dict) -> dict:
    """The window's readings: the mean ``data.batch`` span, per iteration
    the device ms of each phase's
    launches (on the trainer's side; the backward's include the remat
    recompute), the idle shares while the trainer is in ``data.batch`` and
    in the step's phases, the capture's copy rate, the shadow's copies and
    update per apply, and the clock checks: whether the markers' thread
    emitted spans, the share of device time that a program span owns, how
    deep into a ``step.*`` or ``data.*`` span a marker's launch falls, and
    the clock shifts at which every marker's launch stays between the
    trainer's spans."""
    spans = place(export, base_ns, trace.base_ns)
    owner = attribute(trace, spans, threads)
    lo, hi = trace.start, trace.end
    wall, iters = hi - lo, len(trace.marks) - 1
    ops = trace.window_ops()
    trainer = [s for s in spans if not s.track.startswith("shadow")]

    def owned(pick) -> list:
        return [op[:2] for c, op in ops.items()
                if owner.get(c) is not None and pick(owner[c])]
    out = {"iterations": iters, "wall_ms": 1e3 * wall,
           "busy_ms": 1e3 * union_s([op[:2] for op in ops.values()])}
    batches = [s.t1 - s.t0 for s in trainer if s.name == "data.batch"
               and lo <= s.t0 and s.t1 <= hi]
    if batches:
        out["batch_ms"] = 1e3 * sum(batches) / len(batches)
    for ph, key in PHASES.items():
        out[key] = 1e3 * union_s(owned(
            lambda s, ph=ph: s.name == ph
            and not s.track.startswith("shadow"))) / iters
    out["data_idle"] = 100 * idle_in(
        ops, lo, hi, [s for s in trainer if s.name == "data.batch"]) / wall
    out["dispatch_idle"] = 100 * idle_in(
        ops, lo, hi, [s for s in trainer if s.name in PHASES]) / wall
    whole = [s for s in spans if lo <= s.t0 and s.t1 <= hi]
    copies = [s for s in whole if s.name == "capture.to_host"]
    copy_s = union_s(owned(lambda s: s.name == "capture.to_host"))
    if copies and copy_s > 0:
        out["capture_copy_gbps"] = sum(s.args["bytes"] for s in copies) \
            / copy_s / 1e9
    applies = {id(s): ([], []) for s in whole if s.name == "shadow.apply"}
    if applies:
        for c, s in owner.items():
            if s is not None and id(s) in applies:
                a, b, _, name = trace.ops[c]
                applies[id(s)][0 if "HtoD" in name else 1].append((a, b))
        out["shadow_h2d_ms"] = 1e3 * sum(
            union_s(h) for h, _ in applies.values()) / len(applies)
        out["shadow_update_ms"] = 1e3 * sum(
            union_s(k) for _, k in applies.values()) / len(applies)
    busy = union_s([op[:2] for op in ops.values()])
    out["owned_share"] = union_s(owned(lambda s: True)) / busy \
        if busy else None
    out["markers_thread_spans"] = any(
        trace.main_tid in {kineto_tid(i) for i in ids}
        for ids in threads.values())
    marks = {c for _, c in trace.marks}
    at = [t for t, _, c in trace.launches if c in marks]
    phased = [s for s in trainer if s.name.startswith(("step.", "data."))]
    out["marker_depth_us"] = 1e6 * max(
        (_inside(t, s) for t in at for s in phased), default=0.0)
    # a shift d of the spans keeps each marker's launch t between the
    # trainer's spans for d in [max(t - next start), min(t - last end)]
    starts = sorted(s.t0 for s in trainer)
    ends = sorted(s.t1 for s in trainer)
    after = [t - starts[i] for t in at
             if (i := bisect.bisect_right(starts, t)) < len(starts)]
    before = [t - ends[i - 1] for t in at
              if (i := bisect.bisect_right(ends, t)) > 0]
    out["clock_shift_us"] = [1e6 * max(after) if after else None,
                             1e6 * min(before) if before else None]
    return out
