"""The port's observability plane against ``repro.obs``, and its stall
ledger inside the port's Checkmate checkpointer.

Tolerance: none. A fixed span and metric sequence under ``ManualClock``
must export byte-identical trace JSON, Prometheus text and digests in both
packages; every ledger must sum in order to ``stall_total`` bit for bit,
and every Checkmate step's stall must equal the in-order sum of its parts
bit for bit.
"""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.obs import __main__ as jcli
from repro.obs import publish as jpub

from repro_torch import configs as TC
from repro_torch import obs as tobs
from repro_torch.core import channel as tch
from repro_torch.core import shadow as tsh
from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.recovery import FailurePlan
from repro_torch.obs import __main__ as tcli
from repro_torch.obs import publish as tpub
from repro_torch.obs.stalls import KNOWN_STAGES
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.loop import train

torch.set_num_threads(2)   # leave cores to the other test workers


def _sequence(obs, maxlen=None):
    with obs.enabled_session(clock=obs.ManualClock(0.0),
                             trace_maxlen=maxlen) as ob:
        for step in (1, 2):
            with ob.tracer.span("step.compute", args={"step": step}):
                pass
            with ob.tracer.span("checkpoint.on_step", track="checkpoint",
                                args={"step": step, "ck": "checkmate"}):
                with ob.tracer.span("channel.send",
                                    args={"step": step,
                                          "channel": "inprocess"}):
                    with ob.tracer.span("bucket.pack", args={"step": step}):
                        pass
            with ob.tracer.span("shadow.apply", track="shadow0",
                                args={"step": step, "node": 0}):
                pass
            ob.metrics.counter("channel_sends_total", "Gradient sends").inc(
                1, channel="inprocess")
            ob.metrics.histogram("shadow_apply_seconds",
                                 "Per-apply wall time by shadow node"
                                 ).observe(0.002 * step, node=0)
        ob.tracer.instant("recovery.resume", track="recovery",
                          args={"resumed_step": 2})
        ob.metrics.gauge("shadow_lag_steps", "Backlog").set(2, node=1)
        ob.metrics.counter("checkpoint_stall_seconds_total",
                           "Booked stall seconds by stage").inc(
            0.25, stage="send")
        return (json.dumps(ob.tracer.export(), sort_keys=True),
                ob.metrics.to_prometheus(), ob.metrics.snapshot())


@pytest.mark.parametrize("maxlen", [None, 4])
def test_golden_sequence_exports_as_repro_obs(maxlen):
    trace, prom, snap = _sequence(tobs, maxlen)
    assert (trace, prom, snap) == _sequence(jobs, maxlen)
    assert "channel_sends_total{channel=\"inprocess\"} 2" in prom
    assert not tobs.get().enabled               # restored to the no-op plane


def test_disabled_plane_is_a_no_op():
    ob = tobs.get()
    assert not ob.enabled
    assert ob.tracer.span("x") is ob.tracer.span("y")
    ob.metrics.counter("x").inc(10)
    assert ob.metrics.snapshot() == {"metrics": {}}


def test_publish_and_digest_as_repro_obs():
    ck = SimpleNamespace(n_checkpoints=3, skipped_captures=1, resyncs=[2],
                         stall_stages={"send": 0.5, "inline-apply": 0.25},
                         stall_total=0.75)
    shadow = SimpleNamespace(
        stats=lambda: tsh.ShadowStats(3, 0, 1, 0.01, 0.02, [0.01]),
        nodes=[SimpleNamespace(apply_count=3, node_id=0)])
    ck.shadow, ck.channel = shadow, SimpleNamespace(name="inprocess")
    got = tpub.collect_run(tobs.MetricsRegistry(), checkpointer=ck)
    want = jpub.collect_run(jobs.MetricsRegistry(), checkpointer=ck)
    assert got == want
    assert tpub.render_digest(got, ck=ck) == jpub.render_digest(want, ck=ck)


# -- the stall ledger -------------------------------------------------------

SHAPES = {"a": (64, 16), "b": (16,), "c": (3, 16, 24)}


class _GateStep2(tch.InProcessChannel):
    """Delivers step 2 gated (incomplete)."""

    def poll(self):
        out = super().poll()
        for d in out:
            if d.step == 2:
                d.complete, d.flats = False, None
        return out


def _ledger(kind, monkeypatch, steps=5):
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in SHAPES.items()}
    zeros = {k: torch.zeros(s) for k, s in SHAPES.items()}
    kw = {"async": dict(async_mode=True, max_lag_steps=1)}.get(kind, {})
    if kind == "async":
        real = tsh.ShadowNode._apply

        def slow(self, *args):
            time.sleep(0.01)
            return real(self, *args)
        monkeypatch.setattr(tsh.ShadowNode, "_apply", slow)
    layout = layout_for_tree(params, cap_bytes=4096)
    shadow = tsh.ShadowCluster(layout, OptimizerConfig(), n_nodes=2,
                               device="cpu", **kw)
    shadow.bootstrap(params, zeros, zeros, 0)
    channel = {"compressed": tch.CompressedChannel(),
               "resync": _GateStep2()}.get(kind, tch.InProcessChannel())
    ck = CheckmateCheckpointer(shadow, channel=channel)
    snap = {"params": params, "mu": zeros, "nu": zeros, "step": 2}
    for step in range(1, steps + 1):
        grads = {k: torch.from_numpy(rng.standard_normal(s)
                                     .astype(np.float32))
                 for k, s in SHAPES.items()}
        stall = ck.on_step(tch.StepEvent(
            step=step, grads=grads, lr=1e-3,
            state_fn=lambda: dict(snap)))
        if ck._parts is not None and stall:
            assert stall == sum(ck._parts.values())
    ck.restore()
    ck.finalize()
    shadow.shutdown()
    return ck


@pytest.mark.parametrize("kind,stages", [
    ("sync", {"send", "inline-apply"}),
    ("async", {"send", "inline-apply", "apply-lag"}),
    ("compressed", {"quantize", "send", "inline-apply"}),
    ("resync", {"send", "inline-apply", "resync"})])
def test_checkmate_ledger_sums_bit_exactly(kind, stages, monkeypatch):
    ck = _ledger(kind, monkeypatch)
    assert set(ck.stall_stages) == stages | {"consolidate-wait"}
    assert set(ck.stall_stages) <= set(KNOWN_STAGES)
    total = 0.0
    for sec in ck.stall_stages.values():
        total += sec
    assert ck.stall_total == total
    if kind == "resync":
        # step 2 gated (no checkpoint), step 3 resyncs from state_fn
        assert ck.skipped_steps == [2] and ck.resyncs == [3]
        assert ck.skipped_captures == 1 and ck.n_checkpoints == 4
    if kind == "async":
        assert ck.shadow.stats().lag_waits > 0


def test_train_run_emits_the_named_spans_and_counters():
    with tobs.enabled_session() as ob:
        _, stats = train(TC.get("tinyllama-1.1b").reduced(), steps=3,
                         batch=2, seq=16, device="cpu",
                         channel=tch.InProcessChannel(),
                         failure_plan=FailurePlan((3,)))
        names = {e["name"] for e in ob.tracer.events()}
        snap = ob.metrics.snapshot()["metrics"]
    assert {"step.compute", "capture.d2h", "checkpoint.on_step",
            "channel.send", "bucket.pack", "shadow.apply",
            "shadow.consolidate", "recovery.restore",
            "recovery.consolidate", "recovery.resume"} <= names
    assert snap["train_steps_total"]["samples"][0]["value"] == 3
    assert snap["train_recoveries_total"]["samples"][0]["value"] == 1
    assert snap["channel_sends_total"]["samples"][0]["value"] == 3
    assert snap["shadow_apply_seconds"]["samples"]
    assert stats.throughput > 0 and stats.mean_iter > 0


def _train_traced(**kw):
    """Three steps of a reduced tinyllama in 2 microbatches through
    Checkmate (2 shadow nodes) on the CPU, under whatever plane is
    installed; returns the loop's stats."""
    import dataclasses
    cfg = dataclasses.replace(TC.get("tinyllama-1.1b").reduced(),
                              microbatches=2)
    _, stats = train(cfg, steps=3, batch=4, seq=16, device="cpu",
                     channel=tch.InProcessChannel(), **kw)
    return stats


def _inside(child, parent, eps=2e-3):
    return (child["tid"] == parent["tid"] and child["ts"] >= parent["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"]
            + eps)


def test_train_run_spans_the_batch_the_phases_and_the_capture():
    with tobs.enabled_session() as ob:
        _train_traced()
        evs = ob.tracer.events()

    def named(name):
        return [e for e in evs if e["name"] == name]
    for name in ("data.batch", "step.compute", "step.forward",
                 "step.backward", "step.optimizer", "capture.d2h",
                 "bucket.pack", "capture.to_host"):
        assert sorted(e["args"]["step"] for e in named(name)) == sorted(
            [1, 2, 3] * (2 if name in ("step.forward", "step.backward")
                         else 1)), name
    for step in (1, 2, 3):
        compute = next(e for e in named("step.compute")
                       if e["args"]["step"] == step)
        d2h = next(e for e in named("capture.d2h")
                   if e["args"]["step"] == step)
        fwd, bwd = ([e for e in named(n) if e["args"]["step"] == step]
                    for n in ("step.forward", "step.backward"))
        # the microbatches' forward/backward pairs, in turn, in the step
        pairs = sorted(fwd + bwd, key=lambda e: e["ts"])
        assert [e["name"] for e in pairs] == ["step.forward",
                                              "step.backward"] * 2
        opt = next(e for e in named("step.optimizer")
                   if e["args"]["step"] == step)
        assert all(_inside(e, compute) for e in pairs + [opt])
        assert opt["ts"] >= pairs[-1]["ts"] + pairs[-1]["dur"]
        for name in ("bucket.pack", "capture.to_host"):
            e = next(e for e in named(name) if e["args"]["step"] == step)
            assert _inside(e, d2h), name
        # on the CPU the pack writes host buffers: nothing is copied
        assert next(e for e in named("capture.to_host")
                    if e["args"]["step"] == step)["args"]["bytes"] == 0
        batch = next(e for e in named("data.batch")
                     if e["args"]["step"] == step)
        assert batch["ts"] + batch["dur"] <= compute["ts"] + 2e-3
    # the channel adopts the capture's flats: it packs nothing itself
    sends = named("channel.send")
    assert not any(_inside(p, s) for p in named("bucket.pack")
                   for s in sends)


def test_channel_opens_bucket_pack_where_it_packs():
    layout = layout_for_tree({"w": torch.zeros(4, 3)})
    chan = tch.InProcessChannel()
    chan.open(layout)
    grads = {"w": torch.ones(4, 3)}
    with tobs.enabled_session() as ob:
        chan.send(tch.StepEvent(step=1, grads=grads))
        chan.send(tch.StepEvent(step=2, flats=chan.poll()[0].flats))
        packs = [e["args"]["step"] for e in ob.tracer.events()
                 if e["name"] == "bucket.pack"]
    assert packs == [1]


def test_disabled_plane_emits_nothing_in_a_train_run():
    tr = tobs.get().tracer
    assert not tr.enabled and tr.base_ns is None
    _train_traced()
    assert tr.events() == [] and tr.threads == {}


def test_tracer_shares_the_profilers_clock_and_names_its_threads():
    import threading
    before = time.time_ns()
    with tobs.enabled_session() as ob:
        after = time.time_ns()
        stats = _train_traced(shadow_async=True)
        tr = ob.tracer
        workers = {t.ident for t in stats.checkpointer.shadow._workers}
        evs = tr.events()
    assert before <= tr.base_ns <= after
    assert abs(tr.base_ns - time.time_ns()) < 60e9
    # a span's start in epoch ns: base_ns + ts * 1000, read on time.time
    with tobs.enabled_session() as ob:
        t = time.time_ns()
        with ob.tracer.span("x", args={"step": 1}):
            pass
        ev = ob.tracer.events()[0]
        assert abs(ob.tracer.base_ns + ev["ts"] * 1e3 - t) < 1e6
    main = threading.get_ident()
    assert tr.threads["train"] == {main}
    # each node's applies on its worker thread; the consolidation on ours
    assert tr.threads["shadow0"] | tr.threads["shadow1"] == workers
    assert tr.threads["shadow"] == {main} and main not in workers
    assert {e["name"] for e in evs if e["name"] == "shadow.apply"}
    assert tobs.Tracer(clock=tobs.ManualClock(0.0)).base_ns is None


# -- the CLI ----------------------------------------------------------------

def test_cli_diff_prints_as_repro_obs(tmp_path, capsys):
    a, b = tobs.MetricsRegistry(), tobs.MetricsRegistry()
    a.counter("checkpoints_total").inc(3)
    b.counter("checkpoints_total").inc(5)
    b.gauge("shadow_lag_steps").set(1, node=0)
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    a.write_json(pa)
    b.write_json(pb)
    assert tcli.main(["diff", str(pa), str(pb)]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["diff", str(pa), str(pb)]) == 0
    assert got == capsys.readouterr().out
    assert "checkpoints_total {} 3 -> 5" in got
    assert tcli.main(["diff", str(pa), str(pa)]) == 0
    assert capsys.readouterr().out.strip() == "no metric changed"


def test_cli_summary_and_trace_of_a_train_run(tmp_path, capsys):
    assert tcli.main(["summary", "--train", "tinyllama-1.1b", "--steps", "2",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "== run digest ==" in out and "stall attribution" in out
    trace = tmp_path / "t.json"
    assert tcli.main(["trace", "--train", "tinyllama-1.1b", "--steps", "2",
                      "--device", "cpu", "--manual-clock",
                      "--out", str(trace)]) == 0
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"step.compute", "channel.send", "shadow.apply"} <= names
    # a scenario name the corpus lacks exits as the JAX CLI does
    with pytest.raises(SystemExit, match="unknown scenario"):
        tcli.main(["summary", "--scenario", "no-such-scenario",
                   "--device", "cpu"])


def test_cli_trace_of_a_golden_scenario_is_byte_identical(tmp_path):
    """``trace --scenario <golden> --manual-clock``: the same bytes every
    run, with send -> fabric -> shadow-apply spans for every step (the JAX
    CLI's acceptance check)."""
    outs = []
    for i in range(2):
        out = tmp_path / f"t{i}.json"
        assert tcli.main(["trace", "--scenario", "packetized-rail-clean",
                          "--device", "cpu", "--manual-clock",
                          "--out", str(out),
                          "--metrics-out", str(tmp_path / "m.json")]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    evs = [e for e in json.loads(outs[0])["traceEvents"] if e["ph"] == "X"]

    def steps_of(prefix):
        return {e.get("args", {}).get("step") for e in evs
                if e["name"].startswith(prefix)}
    steps = set(range(1, 6))
    assert steps <= steps_of("channel.send")
    assert steps <= steps_of("allgather step")
    assert steps <= steps_of("shadow.apply")
    snap = json.loads((tmp_path / "m.json").read_text())
    assert snap["metrics"]["checkpoints_total"]["samples"][0]["value"] == 5


def test_cli_summary_of_a_sampled_seed(capsys):
    assert tcli.main(["summary", "--seed", "7", "--level", "channel",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "== sampled-7 ==" in out and out.count("PASS") == 1
    assert "stall attribution" in out


# -- the fabric's counters and spans ----------------------------------------

def _fabric_sends(mod_ch, mod_obs, layout, flats_of):
    """Three sends through a packetized channel (step 2's capture lost)
    under a ManualClock session: the trace export, the published
    snapshot and its digest."""
    chan = mod_ch.PacketizedChannel(n_shadow_nodes=2, replication_factor=2,
                                    failures_at={2: "capture"})
    chan.open(layout)
    with mod_obs.enabled_session(clock=mod_obs.ManualClock(0.0)) as ob:
        for step in (1, 2, 3):
            chan.send(mod_ch.StepEvent(step=step, flats=flats_of(step),
                                       lr=1e-3))
        trace = json.dumps(ob.tracer.export(), sort_keys=True)
    reg = mod_obs.MetricsRegistry()
    pub = tpub if mod_obs is tobs else jpub
    snap = pub.collect_run(reg, channel=chan)
    return trace, snap, pub.render_digest(snap), reg.to_prometheus()


def test_fabric_counters_spans_and_digest_as_repro_obs():
    from repro.core import channel as jch
    from repro.core.buckets import layout_for_tree as j_layout
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    jl = j_layout(params, cap_bytes=4096)
    tl = layout_for_tree({k: torch.from_numpy(v) for k, v in params.items()},
                         cap_bytes=4096)

    def flats(step):
        r = np.random.default_rng(step)
        return {b.bucket_id: r.standard_normal(b.size).astype(np.float32)
                for b in jl.buckets}
    want = _fabric_sends(jch, jobs, jl, flats)
    got = _fabric_sends(tch, tobs, tl, lambda s: {
        b: torch.from_numpy(f) for b, f in flats(s).items()})
    assert got == want
    trace, snap, digest, prom = got
    m = snap["metrics"]
    assert m["channel_sends_total"]["samples"][0]["value"] == 3
    assert m["channel_gated_total"]["samples"][0]["value"] == 1
    assert "fabric_time_seconds_total" in m and "frames " in digest
    assert '"fabric (simulated time)"' in trace


def test_cli_summary_over_the_fabric(capsys):
    assert tcli.main(["summary", "--train", "tinyllama-1.1b", "--steps", "2",
                      "--device", "cpu", "--channel", "packetized"]) == 0
    out = capsys.readouterr().out
    for row in ("frames", "bytes on wire", "fabric time", "pfc pause time"):
        assert row in out
