"""Reading ``torch.profiler``'s device trace: the device's busy time as
the union of kernel and copy intervals over all streams, each kernel's
time, and what the host was doing while the device sat idle.

``union_s`` is a copy of ``union_ms`` in ``tools/profile_port.py``, in
seconds. The harness launches a marker kernel (``torch.cuda._sleep``, a
``spin_kernel``) on the trainer's stream at the window's start and at
the end of each of its iterations: the first and the last bound the
profiled span, and device work is clipped to it; each pair between
bounds one iteration. The trace holds the device's activity and the CUDA
runtime calls that launched it, not the host's operators: recording
those would slow the host.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

MARKER = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def union_s(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


@dataclass
class Profile:
    """A device trace cut to the harness's markers; times in seconds."""
    start: float
    end: float
    kernels: list = field(default_factory=list)   # (name, t0, t1, stream)
    copies: list = field(default_factory=list)    # (name, t0, t1, stream)
    host: list = field(default_factory=list)  # (name, t0, t1, tid, corr)
    main_tid: object = None         # the thread that launched the markers
    launched: dict = field(default_factory=dict)  # runtime call -> device op
    marks: list = field(default_factory=list)     # every marker's start
    main_stream: object = None      # the stream the markers ran on

    @property
    def wall_s(self) -> float:
        return self.end - self.start

    def device_intervals(self) -> list[tuple[float, float]]:
        return [(max(a, self.start), min(b, self.end))
                for _, a, b, _ in self.kernels + self.copies
                if b > self.start and a < self.end]

    def busy_s(self) -> float:
        return union_s(self.device_intervals())

    def iterations(self) -> list[tuple[float, float]]:
        """(wall, busy) seconds of each stretch between two markers in
        turn: one iteration of the window each."""
        iv = self.device_intervals()
        return [(b - a, union_s([(max(s, a), min(e, b)) for s, e in iv
                                 if e > a and s < b]))
                for a, b in zip(self.marks, self.marks[1:])]

    def kernel_times(self, needle: str, stream=None) -> list[float]:
        """Durations of every kernel whose name holds ``needle`` (on
        ``stream`` alone, where given), over the whole trace (markers
        aside: a launch is counted whole)."""
        return [b - a for name, a, b, st in self.kernels
                if needle in name and (stream is None or st == stream)]

    def device_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, a, b, _ in self.kernels + self.copies:
            lo, hi = max(a, self.start), min(b, self.end)
            if hi > lo:
                by[name[:120]] += hi - lo
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10, short: float = 50e-6) -> list:
        """Idle time between the markers, summed by what the main thread
        (the one that launched the markers) was in: the innermost runtime
        call open at a gap's middle, or, where none is, the device
        operation that the first call it began after the gap launched (or
        that call). Gaps shorter than ``short`` seconds are summed under
        one label."""
        by = defaultdict(float)
        host = sorted((h for h in self.host if h[3] == self.main_tid),
                      key=lambda h: h[1])
        starts = [h[1] for h in host]
        for g0, g1 in gaps(self.device_intervals(), self.start, self.end):
            if g1 - g0 < short:
                by[f"gaps under {short * 1e6:.0f} us"] += g1 - g0
                continue
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid)
            label = None
            for h in reversed(host[max(0, i - 5000):i]):
                if h[2] > mid:          # the latest begun that is still open
                    label = h[0]
                    break
            if label is None:
                nxt = host[i] if i < len(host) else None
                label = "host, before " + (
                    "the end" if nxt is None
                    else self.launched.get(nxt[4], nxt[0]))
            by[label[:120]] += g1 - g0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def from_chrome_trace(path) -> Profile:
    """Parse a trace written by ``profile.export_chrome_trace``."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels, copies, host, marks = [], [], [], []
    launcher, launched = {}, {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        t0 = float(ev["ts"]) * 1e-6
        t1 = t0 + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        args = ev.get("args", {})
        corr = args.get("correlation")
        stream = args.get("stream", ev.get("tid"))
        if cat == "kernel" and MARKER in name:
            marks.append((t0, corr, stream))
        elif cat in DEVICE_CATS:
            (kernels if cat == "kernel" else copies).append(
                (name, t0, t1, stream))
            launched[corr] = name
        elif cat in HOST_CATS:
            host.append((name, t0, t1, ev.get("tid"), corr))
            if corr is not None:
                launcher[corr] = ev.get("tid")
    if len(marks) < 2:
        raise ValueError("the trace lacks the harness's marker kernels")
    marks.sort()
    return Profile(marks[0][0], marks[-1][0], kernels, copies, host,
                   launcher.get(marks[0][1]),
                   {c: n for c, n in launched.items() if c is not None},
                   [m[0] for m in marks], marks[0][2])
