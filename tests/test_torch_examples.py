"""The port's examples (`repro_torch.examples`) on the CPU: each runs through
``main(["--device", "cpu", ...])`` at its JAX counterpart's sizes (train_100m
at a few steps) and must show the facts the JAX example asserts. Where the
reference's output is machine-independent and quick to get, it is compared
too: the cost planner's text, the fabric drills' results, and the greedy
tokens from the reference's own initial weights (carried over by
`repro_torch.convert`).
"""
import re

import numpy as np
import pytest
import torch

import jax

import examples.cost_planner as jplanner
import examples.serve_decode as jserve
import repro.configs as JC
import repro.harness as JH
from repro.dist.sharding import ShardingRules, make_smoke_mesh
from repro.models import registry as jregistry

from repro_torch.convert import to_tensor
from repro_torch.examples import (cost_planner, fabric_failures,
                                  failure_recovery, quickstart, serve_decode,
                                  train_100m)

torch.set_num_threads(2)   # leave cores to the other test workers

CPU = ["--device", "cpu"]


def test_quickstart_checkpoint_is_bitwise_and_keeps_up(capsys):
    facts = quickstart.main(CPU)
    out = capsys.readouterr().out
    assert facts["bit_identical"] and facts["keeps_up"]
    assert facts["checkpoints"] == facts["steps"] == quickstart.STEPS
    assert facts["lag"] == 0
    assert "shadow checkpoint bit-identical to training state: True" in out
    assert "keeps up: True" in out


def test_failure_recovery_lands_on_the_last_full_capture(capsys):
    facts = failure_recovery.main(CPU)
    out = capsys.readouterr().out
    assert facts["passed"] and facts["bit_identical"]
    assert facts["recoveries"] == 2 and facts["recovered_at"] == [5, 10]
    assert facts["gated_captures"] == [11]
    assert facts["losses"][-4:] == facts["ref_losses"][-4:]
    assert "final states identical: True" in out
    assert "invariants: all passed" in out


def test_fabric_failures_gate_and_recover_as_the_reference(capsys):
    facts = fabric_failures.main(CPU)
    capsys.readouterr()
    # the channel-level drills on the reference give the same fabric
    rail = JH.ChannelSpec(kind="packetized", topology="rail-optimized",
                          n_dp_groups=2, ranks_per_group=4)
    for label, failure in fabric_failures.DRILLS.items():
        jf = JH.FabricFailure(step=failure.step, kind=failure.kind,
                              target=failure.target)
        res = JH.run_scenario(JH.Scenario(
            name=f"drill-{label.replace(' ', '-')}", seed=5, steps=3,
            channel=rail, schedule=JH.FailureSchedule(fabric=(jf,))))
        f = next(p.fabric for r in res.trace.records for p in r.polls
                 if p.step == 2)
        assert facts["drills"][label] == {
            "passed": res.passed, "ring_completed": f.ring_completed,
            "reassembled_ok": f.reassembled_ok, "rerouted": f.rerouted,
            "retransmits": f.retransmits,
            "missing_captures": f.missing_captures}, label
    assert facts["drills"]["shadow cut"]["reassembled_ok"] is False
    lost = fabric_failures.LOST
    assert facts["recovered_at"] == [lost - 1] and facts["gated"] == [lost]
    assert facts["bit_identical"] and facts["passed"]


def test_cost_planner_prints_the_references_figures(capsys):
    facts = cost_planner.main(CPU)
    port = capsys.readouterr().out
    jplanner.main()
    assert port == capsys.readouterr().out
    assert round(facts["iteration_time_s"], 2) == 4.58
    assert facts["plan"].feasible


def test_serve_decode_greedy_tokens_are_the_references(capsys):
    rules = ShardingRules(make_smoke_mesh())
    for arch in serve_decode.ARCHS:
        jserve.run(arch)
        want = re.search(r"decoded (\[[^\]]*\])",
                         capsys.readouterr().out).group(1)
        cfg = JC.get(arch).reduced()
        params = jregistry.init_params(jax.random.PRNGKey(0), cfg, rules)
        got = serve_decode.run(
            arch, torch.device("cpu"),
            params={k: to_tensor(np.asarray(v)) for k, v in params.items()})
        capsys.readouterr()
        assert str(got["tokens"][:6]) == want, arch
        assert len(got["tokens"]) == serve_decode.GEN
        assert got["cache_length"] == serve_decode.PROMPT + \
            serve_decode.GEN - 1
    facts = serve_decode.main(CPU)
    assert list(facts) == list(serve_decode.ARCHS)


def test_train_100m_config_is_the_references():
    """The JAX example's config, as its ``main`` builds it."""
    import dataclasses
    cfg = train_100m.config()
    want = dataclasses.replace(
        JC.get("gpt2-1.5b"), name="gpt2-100m", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
        vocab_size=16384, microbatches=1, attn_q_chunk=128)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.param_count() == want.param_count()


def test_train_100m_recovers_and_learns(monkeypatch, capsys):
    """The example's flow at a narrow cut of its config (a CPU takes
    seconds a step at its 138M parameters): 60 steps, a failure at 30."""
    import dataclasses
    small = dataclasses.replace(train_100m.config(), num_layers=2,
                                d_model=64, num_heads=2, num_kv_heads=2,
                                head_dim=32, d_ff=128, vocab_size=256)
    monkeypatch.setattr(train_100m, "config", lambda: small)
    facts = train_100m.main(CPU + ["--steps", "60", "--fail-at", "30",
                                   "--batch", "4", "--seq", "32"])
    out = capsys.readouterr().out
    assert facts["params_M"] == round(small.param_count() / 1e6, 1)
    assert facts["shadow_bit_identical"] and facts["recoveries"] == 1
    assert facts["checkpoints"] == facts["steps_run"] == 60
    assert facts["recovered_at"] == [29]
    assert facts["losses"][-1] < facts["losses"][0]
    assert '"shadow_bit_identical": true' in out


def test_examples_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod in (quickstart, failure_recovery, fabric_failures, cost_planner,
                serve_decode, train_100m):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main([])
