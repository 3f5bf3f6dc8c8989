"""One run of one training cell: set-up, the measured window, the check.

Set-up makes the weights from the seed (`reference.inputs`), builds the
checkpointer the way ``repro_torch.launch.train.build_checkpointer`` does,
and calls ``repro_torch.train.loop.train``, the loop the port's training
CLI runs, with a step hook. The loop's first ``warmup_steps`` iterations
are set-up: they compile and warm every shape, and steps 1 and 3 leave the
readings the check compares (the first gradient, from the optimizer's
first moment, and each leaf's change after three steps). The window
starts at the end of the last warm-up iteration and ends at the end of
the first iteration that finishes past ``seconds``, so it holds whole
iterations: batch, step, capture and checkpointer. A traced run profiles
the window itself with ``torch.profiler`` (the device alone, started in
set-up), a marker kernel at its start and at each iteration's end, so
that its device readings come from the iterations its spans time, with
the shadow lagging as it does in every run. Set-up ends with a full
collection and ``gc.freeze()``, so that the window's collections walk the
window's objects and not set-up's.

Once the loop has stopped, the peak device memory is read, Checkmate's
shadow consolidates its checkpoint (what a restore resumes from) and it
is compared bit for bit with the trainer's state, the program's state is
freed, and the plain reference follows the first three steps
(`compare`).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import torch

from bench import compare, flops, spec
from bench.reference import model as ref_model
from bench.reference.inputs import (iter_params, make_params, param_layout,
                                    probe_indices)
from bench.trace import from_chrome_trace

FOREVER = 1 << 40                # the loop's step count: the hook stops it
MARK_CYCLES = 1000               # a marker kernel's spin, well under 1 us


class _Stop(Exception):
    """Raised by the step hook to end the loop."""


@dataclass
class Run:
    """What a run leaves for the metric readers (``bench/metrics``)."""
    model: dict
    traffic: dict
    window_s: float
    first_step: int                  # the window's first and last steps
    last_step: int
    capture_times: list              # LoopStats' lists over the window
    stall_times: list
    spans: list = field(default_factory=list)   # obs events of the window
    shadow: dict | None = None       # counters at the window's ends
    profile: object = None           # trace.Profile of the window
    n_params: int = 0
    n_leaves: int = 0
    n_buckets: int = 0

    @property
    def n_iters(self) -> int:
        return self.last_step - self.first_step + 1

    def span_ms(self, name: str) -> list[float]:
        """Durations (ms) of the window's spans called ``name``."""
        return [e["dur"] * 1e-3 for e in self.spans if e["name"] == name]


def model_config(config: dict, traffic: dict):
    """The port's ``ModelConfig`` of a configuration file: the registry
    entry with the file's ``model`` group set, and the traffic's
    microbatches. The fields that differ from the registry entry must be
    exactly those the file lists under ``changed``."""
    import dataclasses

    from repro_torch import configs
    base = configs.get(config["registry"])
    model = config["model"]
    differ = {k for k, v in model.items() if getattr(base, k) != v}
    if differ != set(config["changed"]):
        raise ValueError(f"{config['name']}: fields {sorted(differ)} differ "
                         f"from the registry entry, the file lists "
                         f"{sorted(config['changed'])}")
    return dataclasses.replace(base, **model,
                               microbatches=traffic["microbatches"])


def build_checkpointer(traffic: dict, state, opt, device):
    """The checkpointer the traffic names, built by the training CLI's
    own ``build_checkpointer``."""
    from repro_torch.launch.train import build_checkpointer as build
    ck = traffic["checkpointer"]
    args = argparse.Namespace(
        checkpointer=ck["kind"], freq=1, channel=ck.get("channel",
                                                        "inprocess"),
        topology="rail-optimized", shadow_nodes=ck.get("shadow_nodes", 2),
        shadow_async=ck.get("shadow_async", False),
        max_lag_steps=ck.get("max_lag_steps"), compress=False)
    return build(args, state, opt, device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _shadow_counters(shadow) -> dict | None:
    if shadow is None:
        return None
    return {"apply_count": sum(n.apply_count for n in shadow.nodes),
            "apply_total_s": sum(n.apply_total_s for n in shadow.nodes),
            "lag_waits": shadow.lag_waits}


class Window:
    """The step hook: readings at steps 1 and 3, and the window's two
    ends; traced, the profiler over the window and a marker kernel at
    each of its iteration ends."""

    def __init__(self, *, layout, seed, opt, warmup, seconds, trace,
                 shadow, device):
        if warmup < 3:
            raise ValueError("warm-up must cover the three compared steps")
        self.layout, self.seed, self.opt = layout, seed, opt
        self.probe = probe_indices(layout, seed)
        self.grad_probe = None
        self.warmup, self.seconds = warmup, seconds
        self.profiled = trace and device.type == "cuda"
        self.shadow, self.device = shadow, device
        self.grad_norms = self.change_norms = None
        self.t0 = self.t1 = None
        self.first = self.last = None
        self.counters = []
        self.prof = None
        self.state = self.stats = None
        self.ends = []                   # each iteration's end, host clock

    def __call__(self, step, state, stats):
        self.state, self.stats = state, stats
        self.ends.append(time.perf_counter())
        if step == 1:
            omb1 = 1.0 - self.opt.b1
            norms = torch.stack([torch.linalg.vector_norm(m) / omb1
                                 for m in state.mu.values()]).tolist()
            self.grad_norms = dict(zip(state.mu, norms))
            self.grad_probe = {
                k: (m.reshape(-1)[self.probe[k].to(m.device)] / omb1).cpu()
                for k, m in state.mu.items()}
        if step == 3:
            with torch.no_grad():
                norms = {k: torch.linalg.vector_norm(state.params[k] - p0)
                         for k, p0 in iter_params(self.layout, self.seed,
                                                  self.device)}
            vals = torch.stack(list(norms.values())).tolist()
            self.change_norms = dict(zip(norms, vals))
        if step == self.warmup:
            # set-up's objects are long-lived: out of the collector's
            # sight, a full collection no longer walks them (on an H100
            # host such a walk took 0.14-0.25 s, several a window,
            # wherever it fell); the window's own garbage is collected
            # as before
            gc.collect()
            gc.freeze()
            _sync(self.device)
            if self.profiled:
                from torch.profiler import ProfilerActivity, profile
                # the device alone: recording every host op would slow
                # the host-bound parts of the step
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                torch.cuda._sleep(MARK_CYCLES)    # the window's start
            self.t0 = time.perf_counter()
            self.first = step + 1
            self.counters.append(_shadow_counters(self.shadow))
            return
        if self.t0 is None:
            return
        if time.perf_counter() - self.t0 < self.seconds:
            if self.profiled:
                torch.cuda._sleep(MARK_CYCLES)    # an iteration's end
            return
        _sync(self.device)
        self.t1 = time.perf_counter()
        self.last = step
        self.counters.append(_shadow_counters(self.shadow))
        if self.profiled:
            torch.cuda._sleep(MARK_CYCLES)        # the window's end
            _sync(self.device)
            self.prof.stop()
        raise _Stop


def card_label(device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i",
                              str(device.index or 0)],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or torch.cuda.get_device_name(device)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def _state_mismatch(restored: dict, state, device) -> int:
    """Elements (and the step) in which ``restored`` differs bit for bit
    from the trainer's ``state``."""
    bad = int(int(restored["step"]) != int(state.step))
    for tree in ("params", "mu", "nu"):
        mine = getattr(state, tree)
        if sorted(restored[tree]) != sorted(mine):
            return bad + sum(t.numel() for t in mine.values())
        for k, t in mine.items():
            got = restored[tree][k].to(device)
            if got.shape != t.shape or got.dtype != t.dtype:
                bad += t.numel()
                continue
            bad += int((got.view(torch.int32) != t.view(torch.int32)).sum())
            del got
    return bad


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _run_record(model, traffic, hook, spans, n_params, n_leaves,
                n_buckets) -> Run:
    """The window's readings for the metric readers; a traced run's
    profile is exported, parsed and its file removed."""
    lo, hi = hook.first, hook.last
    st = hook.stats
    run = Run(model=model, traffic=traffic,
              window_s=hook.t1 - hook.t0, first_step=lo, last_step=hi,
              capture_times=st.capture_times[lo - 1:hi],
              stall_times=st.stall_times[lo - 1:hi],
              spans=[e for e in spans
                     if lo <= e.get("args", {}).get("step", 0) <= hi],
              shadow=(None if hook.counters[0] is None
                      else {"start": hook.counters[0],
                            "end": hook.counters[1]}),
              n_params=n_params, n_leaves=n_leaves, n_buckets=n_buckets)
    if hook.prof is not None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            hook.prof.export_chrome_trace(path)
            run.profile = from_chrome_trace(path)
        finally:
            os.unlink(path)
        hook.prof = None
    return run


def end_to_end(name: str, run: Run, setup_s: float, peak: int):
    """The end-to-end metric ``name`` from the window's host clock."""
    tokens = (run.n_iters * run.traffic["batch"]
              * flops.tokens_per_row(run.model, run.traffic))
    if name == "tokens_per_s":
        return tokens / run.window_s
    if name == "mfu":
        return 100.0 * run.n_iters * flops.step_model_flops(
            run.model, run.traffic) / run.window_s / flops.PEAK_BF16
    if name == "ckpt_stall_ms":
        if not run.capture_times:
            return None
        return 1e3 * (sum(run.capture_times) + sum(run.stall_times)) \
            / run.n_iters
    if name == "peak_hbm_gb":
        return peak / 1e9
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r}")


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None) -> dict:
    """One run of ``cell``; returns ``{"correct", "attempted", "failed",
    "metrics", "device", "checks", ...}`` (the result line's fields)."""
    from repro_torch import obs
    from repro_torch.optim.functional import OptimizerConfig, init_state
    from repro_torch.train.loop import train
    from repro_torch.models import registry

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    model, traffic = cell.config["model"], cell.traffic
    cfg = model_config(cell.config, traffic)
    layout = param_layout(model)
    specs = registry.param_specs(cfg)
    if [(k, tuple(specs[k].shape)) for k in sorted(specs)] != \
            [(k, tuple(s)) for k, s, _ in layout]:
        raise ValueError(f"{cell.name}: the program's leaves are not the "
                         f"reference's")
    o = traffic["optimizer"]
    opt = OptimizerConfig(name=o["name"], lr=o["lr"], b1=o["b1"],
                          b2=o["b2"], eps=o["eps"],
                          weight_decay=o["weight_decay"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = init_state(make_params(layout, seed, device))
    ck = build_checkpointer(traffic, state, opt, device)
    shadow = getattr(ck, "shadow", None)
    n_params = sum(t.numel() for t in state.params.values())
    n_leaves = len(state.params)
    n_buckets = len(shadow.layout.buckets) if shadow is not None else 0
    hook = Window(layout=layout, seed=seed, opt=opt,
                  warmup=traffic["warmup_steps"], seconds=seconds,
                  trace=trace, shadow=shadow, device=device)
    session = obs.enabled_session() if trace else contextlib.nullcontext()
    init = [state]
    del state
    with session as ob:
        try:
            train(cfg, steps=FOREVER, batch=traffic["batch"],
                  seq=traffic["seq"], opt=opt, lr_fn=lambda s: o["lr"],
                  checkpointer=ck, seed=seed, state=init.pop(),
                  step_hook=hook, device=device)
        except _Stop:
            pass
        finally:
            gc.unfreeze()
        spans = ob.tracer.events() if trace else []
    if hook.t1 is None:
        raise RuntimeError("the loop ended before the window closed")
    setup_s = hook.t0 - t_start
    t_closed = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    state = hook.state
    checks = {}
    if shadow is not None:
        restored = ck.restore()
        checks["shadow_mismatch"] = float(
            _state_mismatch(restored, state, device))
        del restored
        shadow.shutdown()
        ck.channel.close()
    run = _run_record(model, traffic, hook, spans, n_params,
                      n_leaves, n_buckets)
    ends = hook.ends[hook.first - 2:hook.last]
    iters = [round(1e3 * (b - a), 1) for a, b in zip(ends, ends[1:])]
    prog = {"losses": hook.stats.losses[:3], "grad_norms": hook.grad_norms,
            "grad_probe": hook.grad_probe, "change_norms": hook.change_norms}
    t_restored = time.perf_counter()
    del state, ck, shadow, hook, init
    _free(device)
    ref = ref_model.train_reference(model, traffic, seed, device)
    t_ref = time.perf_counter()
    checks.update(compare.numbers(prog, ref))
    print(f"bench: setup {setup_s:.2f} s, window {run.window_s:.2f} s of "
          f"{run.n_iters} iterations, consolidation and state check "
          f"{t_restored - t_closed:.2f} s, reference {t_ref - t_restored:.2f}"
          f" s; worst leaves {compare.worst_leaves(prog, ref)}",
          file=sys.stderr)
    print(f"bench: iterations (ms) {iters}", file=sys.stderr)
    if run.profile is not None:
        per = [(round(1e3 * w, 1), round(1e3 * b, 1))
               for w, b in run.profile.iterations()]
        print(f"bench: traced iterations (ms, device wall and busy) {per}",
              file=sys.stderr)
    correct, judged = compare.judge(checks, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = (end_to_end(m["name"], run, setup_s, peak) if not trace
                 else spec.reader(m["name"]).read(run))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": run.n_iters, "failed": 0,
           "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile.busy_s()
        dev["window_s"] = run.profile.wall_s
        out["breakdown"] = {"device_ops": run.profile.device_ops(),
                            "idle_gaps": run.profile.idle_gaps()}
    out["card"] = card_label(device)
    out["checks"] = judged
    return out
