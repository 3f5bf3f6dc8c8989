"""The program's spans against the device trace: the attribution of each
device operation to the span it was launched in and the idle arithmetic
on a hand-made trace, the new readers on hand-made runs, the traced tiny
CPU run, and on the card the check that the two clocks agree."""
import json
import subprocess
import sys

import pytest
from conftest import tiny_cell

from bench import harness, spans, spec
from bench.trace import Profile

TB = 10 ** 18                    # the trace's base, epoch ns
MAIN, AUTOGRAD, WORKER = 100, 300, 200
SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def _chrome(tmp_path):
    """A trace of one iteration between markers at 1.0 and 2.0 s: the
    forward's kernel from the trainer's thread, the backward's from
    autograd's, the optimizer's and the capture's copy from the trainer's,
    a shadow node's copy and update from its worker while the trainer is
    in the backward, and a kernel launched outside every span."""
    us = 1e6
    evs = []

    def op(corr, name, cat, t_launch, tid, t0, t1, stream=7):
        evs.append({"ph": "X", "cat": "cuda_runtime", "name":
                    "cudaLaunchKernel", "ts": t_launch * us, "dur": 2.0,
                    "pid": 1, "tid": tid, "args": {"correlation": corr}})
        evs.append({"ph": "X", "cat": cat, "name": name, "ts": t0 * us,
                    "dur": (t1 - t0) * us, "pid": 0, "tid": stream,
                    "args": {"correlation": corr, "stream": stream}})
    op(1, SPIN, "kernel", 0.999, MAIN, 1.0, 1.0)
    op(2, "fwd_gemm", "kernel", 1.15, MAIN, 1.15, 1.19)
    op(3, "bwd_gemm", "kernel", 1.25, AUTOGRAD, 1.25, 1.35)
    op(4, "adamw_kernel", "kernel", 1.41, MAIN, 1.41, 1.45)
    op(5, "Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1.53, MAIN, 1.53,
       1.57)
    op(6, "Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1.31, WORKER,
       1.31, 1.33, stream=20)
    op(7, "adamw_kernel", "kernel", 1.34, WORKER, 1.36, 1.40, stream=21)
    op(8, "stray", "kernel", 1.65, MAIN, 1.65, 1.66)
    op(99, SPIN, "kernel", 1.95, MAIN, 2.0, 2.0)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": evs,
                                "baseTimeNanoseconds": TB}))
    return path


def _export():
    """The tracer's export, its origin 1 s after the trace's base."""
    def x(name, tid, t0, t1, **args):
        return {"name": name, "ph": "X", "cat": "host", "pid": 1, "tid": tid,
                "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                "args": dict(step=1, **args)}
    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
             "args": {"name": name}} for tid, name in ((1, "train"),
                                                      (2, "shadow0"))]
    return {"traceEvents": meta + [
        x("data.batch", 1, 0.0, 0.1), x("step.compute", 1, 0.1, 0.5),
        x("step.forward", 1, 0.1, 0.2), x("step.backward", 1, 0.2, 0.4),
        x("step.optimizer", 1, 0.4, 0.5), x("capture.d2h", 1, 0.5, 0.6),
        x("capture.to_host", 1, 0.52, 0.6, bytes=8e8),
        x("shadow.apply", 2, 0.3, 0.9, node=0)]}


THREADS = {"train": {MAIN}, "shadow0": {WORKER}}


def test_bench_spans_attribute_each_launch_to_its_side(tmp_path):
    tr = spans.load(_chrome(tmp_path))
    assert tr.base_ns == TB and tr.main_tid == MAIN
    assert (tr.start, tr.end) == (1.0, 2.0) and len(tr.ops) == 7
    placed = spans.place(_export(), TB + 10 ** 9, TB)
    assert placed[0].t0 == pytest.approx(1.0)
    assert spans.kineto_tid(0x7F00_8000_0001) == 2 ** 31 - 1
    assert spans.kineto_tid(0x7F00_6BA6_9000) == 0x6BA6_9000
    owner = spans.attribute(tr, placed, THREADS)
    got = {c: (s.name if s else None) for c, s in owner.items()}
    assert got == {2: "step.forward", 3: "step.backward",
                   4: "step.optimizer", 5: "capture.to_host",
                   6: "shadow.apply", 7: "shadow.apply", 8: None}


def test_bench_spans_phases_and_idle_by_hand(tmp_path):
    tr = spans.load(_chrome(tmp_path))
    r = spans.phases(tr, _export(), TB + 10 ** 9, THREADS)
    want = {"iterations": 1, "wall_ms": 1000.0, "busy_ms": 270.0,
            "batch_ms": 100.0,
            "fwd_device_ms": 40.0, "bwd_device_ms": 100.0,
            "opt_device_ms": 40.0,
            # idle 1.0-1.1 in the batch; in the phases 1.1-1.15, 1.19-1.25,
            # 1.35-1.36, 1.40-1.41, 1.45-1.5
            "data_idle": 10.0, "dispatch_idle": 18.0,
            "capture_copy_gbps": 20.0, "shadow_h2d_ms": 20.0,
            "shadow_update_ms": 40.0, "owned_share": 26 / 27,
            "marker_depth_us": -1000.0}
    for k, v in want.items():
        assert r[k] == pytest.approx(v), k
    assert r["markers_thread_spans"]
    assert r["clock_shift_us"] == [pytest.approx(-1000.0),
                                   pytest.approx(350000.0)]
    # spans 2 ms early: the first marker's launch falls 1 ms inside the
    # batch's span
    late = spans.phases(tr, _export(), TB + 10 ** 9 - 2 * 10 ** 6, THREADS)
    assert late["marker_depth_us"] == pytest.approx(1000.0)


def test_bench_idle_in_merges_overlapping_spans():
    ops = {1: (0.2, 0.3), 2: (0.5, 0.6)}
    s = [spans.Span("a", "train", 0.0, 0.4, {}),
         spans.Span("b", "train", 0.35, 0.55, {})]
    # idle 0-0.2, 0.3-0.5, 0.6-1; covered 0-0.55
    assert spans.idle_in(ops, 0.0, 1.0, s) == pytest.approx(0.4)
    assert spans.merge([(0.35, 0.55), (0.0, 0.4), (0.7, 0.8)]) == [
        (0.0, 0.55), (0.7, 0.8)]


def _run(profile=None, spans_=(), shadow=None, n_buckets=1):
    return harness.Run(model={}, traffic={}, window_s=1.0, first_step=1,
                       last_step=1, capture_times=[], stall_times=[],
                       spans=list(spans_), shadow=shadow, profile=profile,
                       n_buckets=n_buckets)


def _profile():
    kernels = [("adamw_kernel", 1.41, 1.45, 7),
               ("adamw_kernel", 1.36, 1.40, 21),
               ("adamw_kernel", 1.38, 1.42, 21),
               ("adamw_kernel", 1.7, 1.72, 23),
               ("adamw_kernel", 2.5, 2.6, 23)]      # after the window
    copies = [("Memcpy DtoH (Device -> Pinned)", 1.53, 1.57, 7),
              ("Memcpy DtoH (Device -> Pinned)", 1.46, 1.460002, 7),
              ("Memcpy DtoH (Device -> Pageable)", 1.2, 1.3, 7),
              ("Memcpy HtoD (Pageable -> Device)", 1.0, 1.01, 7),
              ("Memcpy HtoD (Pinned -> Device)", 1.31, 1.33, 20),
              ("Memcpy HtoD (Pinned -> Device)", 1.5, 1.53, 22)]
    return Profile(1.0, 2.0, kernels, copies, main_stream=7)


SHADOW = {"start": {"apply_count": 4, "apply_total_s": 0.0,
                    "lag_waits": 0},
          "end": {"apply_count": 6, "apply_total_s": 0.0, "lag_waits": 0}}
TO_HOST = {"name": "capture.to_host", "dur": 8e4,
           "args": {"step": 1, "bytes": 8e8}}
BATCH = {"name": "data.batch", "dur": 3e3, "args": {"step": 1}}


def test_bench_new_readers_by_hand():
    run = _run(_profile(), [TO_HOST, BATCH, dict(BATCH, dur=5e3)], SHADOW)
    assert spec.reader("batch_ms").read(run) == pytest.approx(4.0)
    # the capture's copy, not the loss's read through pinned memory
    assert spec.reader("capture_copy_gbps").read(run) == pytest.approx(20.0)
    # per apply: copies 20 + 30 ms, kernels 60 (overlapping) + 20 ms
    assert spec.reader("shadow_h2d_ms").read(run) == pytest.approx(25.0)
    assert spec.reader("shadow_update_ms").read(run) == pytest.approx(40.0)


# each reader's runs that lack what it reads: no spans and no trace; the
# spans and counters without a trace (the CPU); the parent's program,
# without the new spans; no shadow (no checkpointer)
MISSING = {
    "batch_ms": [_run(), _run(_profile(), [TO_HOST], SHADOW)],
    "capture_copy_gbps": [_run(), _run(None, [TO_HOST], SHADOW),
                          _run(_profile(), [BATCH], SHADOW),
                          # a copy a bucket: three buckets, two copies
                          _run(_profile(), [TO_HOST], SHADOW, n_buckets=3)],
    "shadow_h2d_ms": [_run(), _run(None, [TO_HOST], SHADOW),
                      _run(_profile(), [TO_HOST])],
    "shadow_update_ms": [_run(), _run(None, [TO_HOST], SHADOW),
                         _run(_profile(), [TO_HOST])],
}


@pytest.mark.parametrize("metric", sorted(MISSING))
def test_bench_new_reader_reads_nothing_without_its_sources(metric):
    read = spec.reader(metric).read
    for run in MISSING[metric]:
        assert read(run) is None


def test_bench_traced_cpu_run_reads_the_batch():
    out = harness.run_cell(tiny_cell(), 2**31 + 977, 0.3, True,
                           device="cpu")
    assert out["correct"]
    m = out["metrics"]
    assert m["batch_ms"]["value"] > 0 and m["batch_ms"]["unit"] == "ms"
    for k in ("capture_copy_gbps", "shadow_h2d_ms", "shadow_update_ms"):
        assert k not in m                   # no device trace on the CPU


@pytest.mark.chip
def test_bench_spans_share_the_profilers_clock_on_the_card(chip):
    """One traced window of gpt2-1.5b.checkmate through ``phases.py``: the
    markers' thread emitted spans, 99% of the device time between the
    markers was launched inside a program span, and no marker's launch
    lies more than 100 us inside a ``step.*`` or ``data.*`` span; then a
    ``--trace 1`` run of the cell reads every new metric."""
    cell = "gpt2-1.5b.checkmate"
    out = subprocess.run([sys.executable, "bench/phases.py", "--workload",
                          cell, "--seed", "32", "--seconds", "8"],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.splitlines()[-1])
    print(json.dumps(r))
    assert r["markers_thread_spans"]
    assert r["owned_share"] >= 0.99
    assert r["marker_depth_us"] <= 100
    for k in ("fwd_device_ms", "bwd_device_ms", "opt_device_ms",
              "capture_copy_gbps", "shadow_h2d_ms", "shadow_update_ms"):
        assert r[k] > 0, k
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          cell, "--seed", "33", "--seconds", "8",
                          "--trace", "1"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    print(json.dumps(line["metrics"]))
    assert line["correct"]
    for k in ("batch_ms", "capture_copy_gbps", "shadow_h2d_ms",
              "shadow_update_ms"):
        assert k in line["metrics"], (k, out.stderr[-3000:])
        assert line["metrics"][k]["value"] > 0, k
