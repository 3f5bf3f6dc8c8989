"""The port's chaos harness (channel level) against the JAX package's.

Every channel-level golden scenario runs through both packages' runners on
the same numpy gradient stream, and must pass every invariant on the port
(with ``device="cpu"``: the kernels' plain versions) and match the
reference's run: per-step records (deliveries, gated, skipped and partial
steps, resyncs, recoveries, lost buckets), every delivery's fabric result
and the fabric totals field for field, the stall stages booked, the
elastic events, and the final trainer and shadow states to rtol 1e-5 /
atol 1e-6 (the port's cross-package tolerance, as in
tests/test_torch_shadow.py: AdamW's ``b1 ** step`` is taken on the host in
the port). Scenarios, the corpus and bundles are the reference's, byte for
byte; a bundle written by either package replays on the other with the
same verdict and failing step.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.harness as J
from repro.harness.__main__ import main as jax_harness_main

import repro_torch.harness as T
from repro_torch.harness.__main__ import main as harness_main

torch.set_num_threads(2)   # leave cores to the other test workers

CHANNEL = sorted(n for n, s in T.GOLDEN.items() if s.level == "channel")
# sampled channel-level scenarios: a fixed list, so the count never wanders
SAMPLED_SEEDS = (0, 3, 7, 11, 19, 23, 42, 101, 2024, 31337)
RTOL, ATOL = 1e-5, 1e-6
BUDGET = str(Path(__file__).resolve().parent.parent / "benchmarks"
             / "golden_budget.json")


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _trees_close(a: dict, b: dict, what: str):
    assert a["step"] == b["step"], what
    for part in ("params", "mu", "nu"):
        assert set(a[part]) == set(b[part]), (what, part)
        for k in a[part]:
            np.testing.assert_allclose(_np(a[part][k]), _np(b[part][k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {part}[{k}]")


def _records(result) -> list:
    out = []
    for r in result.trace.records:
        out.append(dict(
            step=r.step, gated=r.gated, applied=r.applied,
            partial_applied=r.partial_applied, resync=r.resync,
            restored_step=r.restored_step, plane_restore=r.plane_restore,
            elastic=r.elastic, first_seen=r.first_seen,
            shadow_step=r.shadow_step, shadow_missing=r.shadow_missing,
            dead_nodes=tuple(r.dead_nodes),
            sends=[s.step for s in r.sends],
            polls=[(p.step, p.complete, p.missing_captures, p.node_complete,
                    None if p.fabric is None
                    else dataclasses.asdict(p.fabric)) for p in r.polls]))
    return out


def _totals(result):
    inner = result.trace.channel.inner
    inner = getattr(inner, "inner", inner)          # compressed[...]
    totals = getattr(inner, "totals", None)
    return None if totals is None else dataclasses.asdict(totals)


def _lag_wait_is_timing(sc) -> bool:
    """Whether the trainer's wait on a bounded-lag async applier depends
    on thread timing: it does unless the scenario throttles the applier
    with nothing that settles the backlog mid-run (the condition under
    which the apply-lag-bound invariant requires a wait). Among the golden
    and sampled scenarios here: ``slow-apply-with-link-burst`` and sampled
    seed 23."""
    if not (sc.shadow_async and sc.max_lag_steps is not None):
        return False
    return not (sc.apply_delay_s > 0 and sc.steps > sc.max_lag_steps
                and not sc.schedule.fabric
                and not sc.schedule.train_fail_steps)


# an applier this slow outlasts max_lag_steps + 1 of the trainer's
# channel-level steps (milliseconds each) however loaded the machine, so
# the trainer waits on the bound in both packages
SETTLED_APPLY_DELAY_S = 0.5


def _settled(sc):
    return dataclasses.replace(
        sc, apply_delay_s=max(sc.apply_delay_s, SETTLED_APPLY_DELAY_S))


def _compare(tr, jr, stages=True):
    assert _records(tr) == _records(jr)
    assert _totals(tr) == _totals(jr)
    tck, jck = tr.trace.checkpointer, jr.trace.checkpointer
    if stages:
        assert set(tck.stall_stages) == set(jck.stall_stages)
    assert (tck.n_checkpoints, tck.skipped_captures) == \
        (jck.n_checkpoints, jck.skipped_captures)
    assert tck.skipped_steps == jck.skipped_steps
    assert tck.resyncs == jck.resyncs
    assert tck.partial_steps == jck.partial_steps
    assert tr.trace.elastic_events == jr.trace.elastic_events
    assert tr.trace.plane_losses == jr.trace.plane_losses
    assert tr.trace.wedge == jr.trace.wedge
    assert tr.trace.shadow_partition == jr.trace.shadow_partition
    assert sorted(tr.trace.states) == sorted(jr.trace.states)
    _trees_close(tr.trace.final, jr.trace.final, "final trainer state")
    if jr.trace.final_shadow is not None:
        _trees_close(tr.trace.final_shadow, jr.trace.final_shadow,
                     "final shadow")


def _compare_runs(tsc, jsc):
    """Both packages pass ``tsc``/``jsc`` (one scenario) and their runs
    match. Where the trainer's lag wait is a race, the stall stages
    (``apply-lag`` booked or not) are compared on a second pair of runs
    with a throttled applier, on which both packages wait."""
    tr = T.run_scenario(tsc, device="cpu")
    assert tr.passed, (tsc.to_json(), tr.violations)
    jr = J.run_scenario(jsc)
    assert jr.passed, (tsc.to_json(), jr.violations)
    if not _lag_wait_is_timing(tsc):
        _compare(tr, jr)
        return
    _compare(tr, jr, stages=False)
    tr = T.run_scenario(_settled(tsc), device="cpu")
    jr = J.run_scenario(_settled(jsc))
    assert tr.passed and jr.passed, (tr.violations, jr.violations)
    assert tr.trace.shadow_stats.lag_waits > 0
    assert jr.trace.shadow_stats.lag_waits > 0
    _compare(tr, jr)


@pytest.mark.parametrize("name", CHANNEL)
def test_golden_channel_scenario_matches_jax(name):
    """The port passes every invariant, as the reference does, and its run
    is the reference's run."""
    _compare_runs(T.GOLDEN[name], J.GOLDEN[name])


def test_corpus_and_scenarios_are_the_reference_byte_for_byte():
    assert list(T.GOLDEN) == list(J.GOLDEN)
    assert len(T.GOLDEN) == 47 and len(CHANNEL) == 42
    for name in T.GOLDEN:
        assert T.GOLDEN[name].to_json() == J.GOLDEN[name].to_json(), name
    for seed in range(200):
        for level in (None, "channel", "full"):
            a = T.sample_scenario(seed, level=level).to_json()
            assert a == J.sample_scenario(seed, level=level).to_json(), seed
            assert T.Scenario.from_json(a).to_json() == a
    assert sorted(T.REGISTRY) == sorted(J.REGISTRY)
    assert len(T.REGISTRY) == 16


@pytest.mark.parametrize("seed", SAMPLED_SEEDS)
def test_sampled_scenario_passes_on_both_packages(seed):
    _compare_runs(T.sample_scenario(seed, level="channel"),
                  J.sample_scenario(seed, level="channel"))


def _forced_violation(pkg):
    """Bit-identity forced onto a compressed stream (whose shadow
    intentionally diverges): violates at step 1 on both packages."""
    return pkg.Scenario(name="forced-bit-identity-on-compressed", seed=5,
                        steps=3, channel=pkg.ChannelSpec(kind="compressed"),
                        invariants=("shadow-bit-identity",))


def _verdict(result):
    return (result.passed, result.failing_step,
            [(v.invariant, v.step) for v in result.violations])


def test_bundles_replay_across_packages(tmp_path):
    port = T.run_scenario(_forced_violation(T), device="cpu",
                          bundle_dir=tmp_path / "port")
    ref = J.run_scenario(_forced_violation(J), bundle_dir=tmp_path / "jax")
    assert not port.passed and port.failing_step == 1
    assert _verdict(port) == _verdict(ref)
    d = json.loads(port.bundle_path.read_text())
    assert set(d) == {"seed", "scenario", "failing_step", "violations",
                      "trace_tail"}
    assert d["scenario"] == json.loads(ref.bundle_path.read_text())[
        "scenario"]
    # each package replays its own bundle bit for bit ...
    _, same = T.replay_bundle(port.bundle_path, device="cpu")
    assert same
    # ... and the other's with the same verdict and failing step
    on_jax, _ = J.replay_bundle(port.bundle_path)
    on_port, _ = T.replay_bundle(ref.bundle_path, device="cpu")
    assert _verdict(on_jax) == _verdict(port)
    assert _verdict(on_port) == _verdict(ref)


def test_sampled_run_replays_bit_identically():
    seed = T.repro_seed() + 333
    a = T.run_scenario(T.sample_scenario(seed, level="channel"),
                       device="cpu").bundle()
    b = T.run_scenario(T.sample_scenario(seed, level="channel"),
                       device="cpu").bundle()
    assert a == b


def test_validation_rejects_what_the_reference_rejects():
    bad = [dict(level="nope"), dict(seed=-1),
           dict(schedule=T.FailureSchedule(wedge_node=0)),
           dict(channel=T.ChannelSpec(sharded=True)),
           dict(schedule=T.FailureSchedule(train_fail_steps=(9,)))]
    for kw in bad:
        with pytest.raises(ValueError):
            T.Scenario(name="bad", **kw).validate()


class _Clock:
    """A stand-in for a CLI's ``time`` module on which every scenario
    takes ``seconds`` (the CLIs read ``time.monotonic()`` before and
    after each scenario)."""

    def __init__(self, seconds: float):
        self.now, self.seconds = 0.0, seconds

    def monotonic(self) -> float:
        self.now += self.seconds
        return self.now


def test_cli_run_with_time_budget(capsys, monkeypatch):
    """``run --device cpu --time-budget`` on a few golden scenarios passes
    the JAX package's CPU baseline file by the wall clock, and exits and
    reports as the reference's CLI does on that file when both read one
    clock on which each scenario takes 0.5 s: within the budget of the
    0.8 s and 0.3 s baselines at tolerance 2, past that of 0.2 s. (The
    reference's own seconds sit at its baselines, about 0.2 s a scenario,
    so its verdict by the wall clock changes with the machine's load.)"""
    import repro.harness.__main__ as jmain
    import repro_torch.harness.__main__ as tmain
    names = ("inprocess-clean", "capture-resync", "elastic-dp8-to-4")
    for name in names:
        args = ["run", "--scenario", name, "--time-budget", BUDGET]
        assert harness_main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("# 1/1 scenarios passed") == len(names)
    assert out.count("-> OK") == len(names)
    rcs = []
    for name in names:
        args = ["run", "--scenario", name, "--time-budget", BUDGET]
        J.run_scenario(J.GOLDEN[name])      # JAX compiles outside the run
        runs = []
        for mod, main, extra in ((tmain, harness_main, ["--device", "cpu"]),
                                 (jmain, jax_harness_main, [])):
            monkeypatch.setattr(mod, "time", _Clock(0.5))
            rc = main(args + extra)
            lines = capsys.readouterr().out.splitlines()
            runs.append((rc, [ln for ln in lines
                              if ln.startswith(("# time-budget", "# 1/1"))]))
        assert runs[0] == runs[1], name
        rcs.append(runs[0][0])
    assert rcs == [0, 1, 0]
    rc = harness_main(["run", "--scenario", "no-such", "--device", "cpu"])
    assert rc == jax_harness_main(["run", "--scenario", "no-such"]) == 2
    # the one scenario the port refuses is named, and fails the run
    assert harness_main(["run", "--scenario", "elastic-fsdp-flip",
                         "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "REFUSED" in out and "item 11" in out
    assert "# 0/1 scenarios passed, 1 REFUSED (not ported)" in out


def test_cli_replay_seed_and_bundle(tmp_path, capsys):
    assert harness_main(["replay", "--seed", "7", "--level", "channel",
                         "--device", "cpu"]) == 0
    res = T.run_scenario(_forced_violation(T), device="cpu",
                         bundle_dir=tmp_path)
    assert harness_main(["replay", "--bundle", str(res.bundle_path),
                         "--device", "cpu"]) == 0
    assert "reproduced bit-identically" in capsys.readouterr().out


def test_ef_bound_on_an_unsent_compressor_fails_as_the_reference():
    """A sampled compressed drill whose last step is a shrink leaves the
    rebuilt channel's compressor unsent (``ef`` is None): the reference's
    CompressedDivergenceBound raises there (ROADMAP queue 3), and the
    port's, which keeps its ``applies``, raises the same."""
    seed = 1025
    sc = T.sample_scenario(seed, level="channel")
    assert sc.channel.kind == "compressed" and sc.optimizer == "sgd"
    assert sc.schedule.train_node_loss[-1].step == sc.steps
    with pytest.raises(TypeError) as port:
        T.run_scenario(sc, device="cpu")
    with pytest.raises(TypeError) as ref:
        J.run_scenario(J.sample_scenario(seed, level="channel"))
    assert str(port.value) == str(ref.value)
