"""The port's chaos harness at full level against the JAX package's.

The five full-level golden scenarios go through the port's
`train` and the reference's, from the same initial weights (the
reference's ``init_params`` for the scenario's seed, carried over by
`repro_torch.convert`) at the reference's ``.reduced()`` config with f32
compute on both sides. The port must pass every invariant (inside the
port: bitwise), give the reference's recoveries, replayed steps,
gated/resync record and elastic events (``elastic-fsdp-flip`` restores
onto FSDP-flipped sharding rules on both), and its losses must follow the
reference's to rtol 1e-4, the tolerance of tests/test_torch_system.py::
test_loss_trajectory_matches_jax_train (the two frameworks sum in other
orders).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import repro.configs as C
import repro.harness as J
from repro.dist.sharding import ShardingRules, make_smoke_mesh
from repro.train.step import make_train_state as j_make_state

import repro_torch.harness as T
import repro_torch.harness.runner as T_runner
from repro_torch import configs as TC
from repro_torch.convert import state_from_numpy

torch.set_num_threads(2)   # leave cores to the other test workers

FULL = [n for n, s in T.GOLDEN.items() if s.level == "full"]


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.fixture
def same_init(monkeypatch):
    """Both packages at f32 compute, the port starting from the JAX
    package's initial state for the scenario's seed."""
    j_get = C.get
    monkeypatch.setattr(C, "get", lambda name: _f32(j_get(name)))

    def from_jax(cfg, seed, device):
        jcfg = C.get(cfg.name.removesuffix("-smoke")).reduced()
        s = j_make_state(jax.random.PRNGKey(seed), jcfg,
                         ShardingRules(make_smoke_mesh()))
        return state_from_numpy(
            *({k: np.asarray(v) for k, v in tree.items()}
              for tree in (s.params, s.mu, s.nu)), 0, device=device)
    monkeypatch.setattr(T_runner, "make_train_state", from_jax)
    return _f32(TC.get("tinyllama-1.1b").reduced())


def _record(r):
    return (r.step, r.gated, r.applied, r.resync, r.restored_step,
            r.first_seen, r.shadow_step, r.elastic)


@pytest.mark.parametrize("name", FULL)
def test_full_scenario_matches_jax(name, same_init):
    tr = T.run_scenario(T.GOLDEN[name], device="cpu", cfg=same_init)
    assert tr.passed, (name, tr.violations)
    jr = J.run_scenario(J.GOLDEN[name])
    assert jr.passed, (name, jr.violations)
    ts, js = tr.trace.stats, jr.trace.stats
    assert (ts.steps, ts.failures, ts.recoveries, ts.recovered_at) == \
        (js.steps, js.failures, js.recoveries, js.recovered_at)
    assert [_record(r) for r in tr.trace.records] == \
        [_record(r) for r in jr.trace.records]
    assert tr.trace.elastic_events == jr.trace.elastic_events
    np.testing.assert_allclose(ts.losses, js.losses, rtol=1e-4)
    np.testing.assert_allclose(tr.trace.ref_losses, jr.trace.ref_losses,
                               rtol=1e-4)
    ck = tr.trace.checkpointer
    assert ck.n_checkpoints == jr.trace.checkpointer.n_checkpoints
    assert set(ck.stall_stages) == set(jr.trace.checkpointer.stall_stages)


def test_full_scenarios_at_the_reduced_bf16_default():
    """Without ``cfg`` the full level runs the reference's ``.reduced()``
    config as it is (bf16 compute) and passes every invariant."""
    for name in ("full-packetized-gated-recovery",
                 "full-packetized-rail-clean"):
        res = T.run_scenario(T.GOLDEN[name], device="cpu")
        assert res.passed, (name, res.violations)
        assert len(res.trace.ref_losses) == T.GOLDEN[name].steps
