"""The copy-persist checkpointers over ranks, and Checkmate's resync over
ranks, on four gloo ranks on the CPU.

Over ranks global rank 0 hosts the checkpointer, and its ``state_fn``
gathers the whole state from every rank's slices (`RankStateGather`). The
port runs every case in one world of four ranks
(``tests/_torch_ckpt_ranks_workers.py::ckpt_ranks``): the five baselines
on a (2, 2) mesh, granite under FSDP on (4, 1), arctic expert-parallel on
(2, 2), an elastic shrink (4, 1) -> (2, 1), Checkmate through a
`PacketizedChannel` that leaves step 3's capture incomplete on an alive
owner, and the training CLI. Inside the port, checkpoints are held
bitwise against the trainer's whole state, and final slices bitwise
against an unfailed run's.

Meanwhile the reference's ``train()`` runs on its (2, 2) mesh of four
forced host devices (``tests/_torch_gspmd.py``), from the port's initial
params, with ``SyncCheckpointer`` and a failure at step 4, and with the
gated channel and a failure at step 5 (after the resync, so the restore
reads the resynced shadow). Tolerances are tests/test_torch_dp_train.py's
for the GSPMD step: losses to rtol 1e-4 / atol 1e-6, states to rtol 1e-5
/ atol 1e-6, with AdamW at eps 1e-4 in both packages
(``_torch_tp_workers.EPS`` says why). Counts (``recovered_at``,
``resyncs``, ``skipped_steps``) are equal.
"""
import json

import numpy as np
import pytest
import torch

from _torch_ckpt_ranks_workers import (BASELINES, BATCH, CLI_ARGV,
                                       GATE_FAIL, GATE_HOLE, OPT, SEQ, STEPS,
                                       cfg_of, lr_fn)
from _torch_gspmd import start_script
from _torch_spawn import spawn

from repro_torch.core.checkpoint import CheckFreqCheckpointer
from repro_torch.core.recovery import FailurePlan
from repro_torch.launch import train as ttrain
from repro_torch.models import registry
from repro_torch.train.loop import train

torch.set_num_threads(2)   # leave cores to the other test workers

WORLD = 4
LOSS = dict(rtol=1e-4, atol=1e-6)
STATE = dict(rtol=1e-5, atol=1e-6)
TREES = ("params", "mu", "nu")
PROFILE_STEPS = CheckFreqCheckpointer().profile_steps

REFERENCE = """
import sys
import numpy as np, jax
from repro.dist import compat
import repro.configs as C
from repro.core.channel import PacketizedChannel
from repro.core.checkpoint import SyncCheckpointer
from repro.core.recovery import FailurePlan, state_from_checkpoint
from repro.dist.sharding import ShardingRules
from repro.net.simulator import FailureSpec
from repro.optim import OptimizerConfig
from repro.train.loop import train

init = np.load(sys.argv[1])
cfg = C.get("tinyllama-1.1b").reduced(compute_dtype="float32",
                                      microbatches=2)
m = compat.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(compat.AxisType.Auto,) * 2)
rules = ShardingRules(m, fsdp=cfg.fsdp)
OPT = OptimizerConfig(lr=%r, eps=%r, grad_clip=%r)


def start():
    p = {k: init[k] for k in init.files}
    z = {k: np.zeros_like(v) for k, v in p.items()}
    return state_from_checkpoint({"params": p, "mu": z, "nu": dict(z),
                                  "step": 0}, cfg, rules)


out = {}
runs = {"sync": dict(checkpointer=SyncCheckpointer(),
                     failure_plan=FailurePlan((4,))),
        "gate": dict(channel=PacketizedChannel(
                         sharded=True, n_shadow_nodes=2,
                         failures_at={%d: [FailureSpec(0.0, "shadow_nic",
                                                       "s0")]}),
                     failure_plan=FailurePlan((%d,)))}
with m:
    for tag, kw in runs.items():
        state, stats = train(cfg, rules, steps=%d, batch=%d, seq=%d, opt=OPT,
                             lr_fn=lambda s: 1e-3, state=start(), seed=0,
                             **kw)
        out[f"{tag}/losses"] = np.asarray(stats.losses)
        out[f"{tag}/recovered_at"] = np.asarray(stats.recovered_at)
        ck = stats.checkpointer
        if tag == "gate":
            out["gate/resyncs"] = np.asarray(ck.resyncs)
            out["gate/skipped_steps"] = np.asarray(ck.skipped_steps)
        for tree in ("params", "mu", "nu"):
            for k, v in getattr(state, tree).items():
                out[f"{tag}/{tree}/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
""" % (OPT.lr, OPT.eps, OPT.grad_clip, GATE_HOLE, GATE_FAIL, STEPS, BATCH,
       SEQ)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two runs (in a subprocess) beside the port's world
    of four ranks: {"ref": the reference's dump, "ranks": what each rank
    saw, "cli": rank 0's CLI report and stall stages}."""
    d = tmp_path_factory.mktemp("ckpt_ranks")
    init = registry.init_params(cfg_of("tinyllama-1.1b"), 0, "cpu")
    np.savez(d / "init.npz", **{k: v.numpy() for k, v in init.items()})
    ref = start_script(REFERENCE, str(d / "init.npz"), str(d / "ref.npz"))
    try:
        spawn("_torch_ckpt_ranks_workers", "ckpt_ranks", WORLD, d, str(d),
              timeout=300)
        _, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    return {"ref": dict(np.load(d / "ref.npz")),
            "ranks": [torch.load(d / f"rank{r}.pt", weights_only=False)
                      for r in range(WORLD)],
            "cli": (json.loads((d / "cli" / "report.json").read_text()),
                    json.loads((d / "cli" / "stall_stages.json")
                               .read_text()))}


@pytest.fixture(scope="module")
def one_rank():
    """Each baseline on one rank: the same run, today's train()."""
    out = {}
    for name, cls in BASELINES.items():
        ck = cls()
        train(cfg_of("tinyllama-1.1b"), steps=STEPS, batch=BATCH, seq=SEQ,
              opt=OPT, lr_fn=lr_fn, device="cpu", checkpointer=ck,
              failure_plan=FailurePlan((4,)), seed=0)
        out[name] = ck
    return out


def _equal(a: dict, b: dict, what: str):
    assert a["step"] == b["step"], what
    for tree in TREES:
        assert a[tree].keys() == b[tree].keys(), (what, tree)
        for k, t in a[tree].items():
            assert torch.equal(t, b[tree][k]), (what, tree, k)


def _restores_bitwise(rec: dict, n: int, what: str):
    """Rank 0's ``n`` restores each hand back the trainer's whole state at
    the checkpoint's step, bit for bit."""
    assert len(rec["restored"]) == n, what
    for ckpt in rec["restored"]:
        _equal(ckpt, rec["trainer"][ckpt["step"]], f"{what} restore")


def _slices_as_unfailed(ranks: list, tag: str, unfailed: str):
    for r, out in enumerate(ranks):
        for tree in TREES:
            for k, t in out[tag]["local"][tree].items():
                assert torch.equal(t, out[unfailed]["local"][tree][k]), \
                    (tag, r, tree, k)


def _checkpoint_steps(name: str, tuned_freq) -> list:
    """The indices, among the executed steps 1, 2, 3, 4, 5 (the failure
    at 4 strikes before step 4 runs and restores step 3), at which the
    baseline checkpointed: every one at freq 1; CheckFreq in its
    profiling steps and then at each multiple of the interval it tuned."""
    if name != "checkfreq":
        return list(range(STEPS))
    return [i for i in range(STEPS)
            if i < PROFILE_STEPS or (i + 1) % tuned_freq == 0]


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_over_ranks_restores_bitwise(runs, one_rank, name):
    """(2, 2), each baseline at freq 1 (CheckFreq tuning itself), a
    failure at step 4: the restored checkpoint is the trainer's whole
    state at its step, the final slices an unfailed run's, rank 0's stall
    ledger and checkpoint count those of the one-rank run, and every rank
    stalls at every checkpoint step."""
    ranks = runs["ranks"]
    rec = ranks[0][f"dense/{name}"]
    _restores_bitwise(rec, 1, name)
    assert rec["restored"][0]["step"] == 3 and rec["recovered_at"] == [3]
    _slices_as_unfailed(ranks, f"dense/{name}", "dense/none")
    one = one_rank[name]
    assert rec["stall_stages"] == list(one.stall_stages) == ["copy-persist"]
    # CheckFreq tunes its interval from measured times: each run's count
    # is the one its own interval gives (every step's at freq 1)
    steps = _checkpoint_steps(name, rec["tuned_freq"])
    assert rec["n_checkpoints"] == len(steps)
    assert one.n_checkpoints == len(_checkpoint_steps(
        name, getattr(one, "tuned_freq", None)))
    for r, out in enumerate(ranks):
        stalls = out[f"dense/{name}"]["stall_times"]
        assert len(stalls) == STEPS
        assert all(stalls[i] > 0.0 for i in steps), (r, stalls)


@pytest.mark.parametrize("tag,unfailed", [("fsdp/sync", "fsdp/none"),
                                          ("ep/async", "ep/none")])
def test_fsdp_and_expert_parallel_restore_bitwise(runs, tag, unfailed):
    """granite under FSDP on (4, 1) with Sync (``wemb`` slices over the dp
    ranks) and arctic on (2, 2) with Async (its experts' slices over
    ``model``): the same bitwise checks."""
    ranks = runs["ranks"]
    rec = ranks[0][tag]
    _restores_bitwise(rec, 1, tag)
    assert rec["recovered_at"] == [3] and rec["n_checkpoints"] == STEPS
    _slices_as_unfailed(ranks, tag, unfailed)


def test_elastic_shrink_gathers_over_the_new_mesh(runs):
    """(4, 1) -> (2, 1) at the failure at 3 with Sync: step 2's checkpoint
    (gathered over four ranks) lands on the survivors, ranks 2 and 3
    leave, and step 4's checkpoint, gathered over the two survivors,
    is restored at the failure at 5; the last checkpoint is the trainer's
    final whole state."""
    ranks = runs["ranks"]
    rec = ranks[0]["elastic"]
    _restores_bitwise(rec, 2, "elastic")
    assert [c["step"] for c in rec["restored"]] == [2, 4]
    assert rec["latest"]["step"] == 6
    _equal(rec["latest"], rec["final"], "elastic last checkpoint")
    for r, out in enumerate(ranks):
        assert out["elastic"]["left"] == (r >= 2), r
        if r < 2:
            assert out["elastic"]["recovered_at"] == [2, 4]
            assert len(out["elastic"]["stall_times"]) == 6
            assert all(s > 0.0 for s in out["elastic"]["stall_times"])


def test_gated_capture_resyncs_over_ranks(runs):
    """The fault: a hole on an alive owner at step 3 desynchronises the
    shadow, and rank 0's next step carries the gathered state, so the
    shadow resyncs at step 4 (as the reference's does) and the failure at
    5 restores from it; the consolidated checkpoint at the end is the
    trainer's whole state bit for bit."""
    rec, ref = runs["ranks"][0]["gate"], runs["ref"]
    assert rec["resyncs"] == ref["gate/resyncs"].tolist() == [GATE_HOLE + 1]
    assert rec["skipped_steps"] == ref["gate/skipped_steps"].tolist() \
        == [GATE_HOLE]
    assert rec["recovered_at"] == ref["gate/recovered_at"].tolist() \
        == [GATE_HOLE + 1]
    _equal(rec["consolidated"], rec["final"], "gate consolidated")


@pytest.mark.parametrize("tag,ref_tag", [("dense/sync", "sync"),
                                         ("gate", "gate")])
def test_matches_reference_train(runs, tag, ref_tag):
    """The port's Sync run and its gated-capture Checkmate run against the
    reference's train() on its (2, 2) mesh: losses (replayed steps
    included), ``recovered_at`` and the final params, mu and nu."""
    rec, ref = runs["ranks"][0][tag], runs["ref"]
    want = ref[f"{ref_tag}/losses"]
    assert len(rec["losses"]) == len(want)
    np.testing.assert_allclose(rec["losses"], want, **LOSS)
    assert rec["recovered_at"] == ref[f"{ref_tag}/recovered_at"].tolist()
    for tree in TREES:
        for k, t in rec["final"][tree].items():
            np.testing.assert_allclose(t.numpy(), ref[f"{ref_tag}/{tree}/{k}"],
                                       err_msg=f"{tree}/{k}", **STATE)


def test_cli_over_ranks_takes_a_baseline(runs):
    """``--mesh single --checkpointer sync --fail-at 3`` over four ranks:
    rank 0 reports one recovery, a ``copy-persist`` stall and the keys
    and checkpoint count of the one-rank CLI; the other ranks report
    nothing (``train_cli`` asserts it)."""
    got, stages = runs["cli"]
    want = ttrain.run(CLI_ARGV).report
    assert set(got) == set(want)
    assert got["recoveries"] == want["recoveries"] == 1
    assert got["checkpoints"] == want["checkpoints"]
    assert list(stages) == ["copy-persist"] and stages["copy-persist"] > 0


def test_one_rank_gather_is_checkpoint_from_state(runs):
    """On a one-rank mesh (phase 4b's check on the card) the gather after
    a step is `checkpoint_from_state` bit for bit, with one pack a
    tree."""
    assert runs["ranks"][0]["one_rank_gather"] == {"bitwise": True,
                                                   "packs": 3}
