"""Rank workers of the copy-persist checkpointers over ranks
(tests/test_torch_ckpt_ranks.py; spawned by ``tests/_torch_spawn.py``, so
no JAX here: spawn imports this module).

``ckpt_ranks`` runs every case of that test in one world of four gloo
ranks and writes what each rank saw to ``rank<r>.pt``. Each run records,
on rank 0, every checkpoint ``restore()`` handed back and the trainer's
whole state at each step it reached (gathered at the step hook, where
every rank is), so the test can hold the one against the other bit for
bit; and on every rank its stalls and final slices.
"""
import os

import torch
import torch.distributed as dist

from _torch_dp_workers import train_cli
from repro_torch import configs as TC
from repro_torch.core.channel import PacketizedChannel
from repro_torch.core.checkpoint import (AsyncCheckpointer,
                                         CheckFreqCheckpointer,
                                         GeminiLikeCheckpointer,
                                         NoCheckpointer,
                                         ShardedAsyncCheckpointer,
                                         SyncCheckpointer)
from repro_torch.core.recovery import FailurePlan, checkpoint_from_state
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.dist.sharding import Mesh, ShardingRules
from repro_torch.net.simulator import FailureSpec
from repro_torch.kernels import ops
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.loop import RankStateGather, train
from repro_torch.train.step import (build_train_step, make_train_state,
                                    state_sharding)

# eps 1e-4 as in tests/_torch_tp_workers.py: the (2, 2) runs are held
# against the reference's GSPMD train() over several steps
OPT = OptimizerConfig(lr=1e-3, eps=1e-4, grad_clip=0.5)
BATCH, SEQ, STEPS = 16, 16, 5
BASELINES = {"sync": SyncCheckpointer, "async": AsyncCheckpointer,
             "torch_dcp": ShardedAsyncCheckpointer,
             "gemini": GeminiLikeCheckpointer,
             "checkfreq": CheckFreqCheckpointer}
# the fault: owner 0's NIC cut at step 3 (owner alive), so step 3's
# capture is incomplete and the shadow must resync at step 4; the failure
# at 5 restores from the resynced shadow
GATE_HOLE, GATE_FAIL = 3, 5
# the training CLI over the four ranks, with a baseline
CLI_ARGV = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "8",
            "--seq", "16", "--checkpointer", "sync", "--fail-at", "3"]


def lr_fn(step):
    return 1e-3


def cfg_of(arch: str, **over):
    return TC.get(arch).reduced(compute_dtype="float32", microbatches=2,
                                **over)


def gate_channel():
    return PacketizedChannel(sharded=True, n_shadow_nodes=2, failures_at={
        GATE_HOLE: [FailureSpec(0.0, "shadow_nic", "s0")]})


def _whole(cfg, rules, state) -> dict:
    p, m, v = state_sharding(cfg, rules).full(state.params, state.mu,
                                              state.nu)
    return {"params": p, "mu": m, "nu": v, "step": int(state.step)}


def run(cfg, rules_at, out, tag, checkpointer=None, channel=None,
        fail=(), steps=STEPS, elastic_rules=None):
    """train(rules=) with ``checkpointer`` (a class, built on rank 0) or
    ``channel``. ``rules_at(recoveries)`` are the rules in force after
    that many recoveries (the step hook gathers the trainer's state over
    them)."""
    rank0 = dist.get_rank() == 0
    ck = checkpointer() if rank0 and checkpointer is not None else None
    restored, trainer = [], {}
    if ck is not None:
        restore = ck.restore

        def recording():
            got = restore()
            restored.append(got)
            return got
        ck.restore = recording

    def hook(step, state, stats):
        whole = _whole(cfg, rules_at(stats.recoveries), state)
        if rank0:
            trainer.setdefault(step, whole)

    state, stats = train(cfg, steps=steps, batch=BATCH, seq=SEQ, opt=OPT,
                         lr_fn=lr_fn, device="cpu", rules=rules_at(0),
                         checkpointer=ck,
                         channel=channel() if channel is not None else None,
                         failure_plan=FailurePlan(tuple(fail)), seed=0,
                         step_hook=hook, elastic_rules=elastic_rules)
    rec = {"losses": stats.losses, "recovered_at": stats.recovered_at,
           "stall_times": stats.stall_times, "left": state is None}
    if state is not None:
        rec["local"] = {"params": state.params, "mu": state.mu,
                        "nu": state.nu}
        final = _whole(cfg, rules_at(stats.recoveries), state)
    if rank0:
        ck = stats.checkpointer
        rec |= {"restored": restored, "trainer": trainer, "final": final,
                "stall_stages": list(ck.stall_stages),
                "n_checkpoints": ck.n_checkpoints,
                "tuned_freq": getattr(ck, "tuned_freq", None)}
        if checkpointer is not None:     # the last checkpoint, unrecorded
            rec["latest"] = type(ck).restore(ck)
        if channel is not None:
            rec |= {"resyncs": ck.resyncs, "skipped_steps": ck.skipped_steps,
                    "consolidated": ck.shadow.consolidate()}
            ck.shadow.shutdown()
    out[tag] = rec


def one_rank_gather(cfg, rules) -> dict:
    """`RankStateGather` on a one-rank mesh after a step (chip_smoke.py's
    phase 4b check): whether it is bitwise `checkpoint_from_state`, and
    its pack calls."""
    state = make_train_state(cfg, 0, "cpu")
    state, _, _ = build_train_step(cfg, OPT, lr_fn, rules)(
        state, device_batch(SyntheticStream(cfg, BATCH, SEQ, seed=0)
                            .batch_at(0), "cpu", rules, cfg.microbatches))
    calls = []
    pack = ops.pack_bucket
    ops.pack_bucket = lambda *a: calls.append(a) or pack(*a)
    try:
        got = RankStateGather(state_sharding(cfg, rules),
                              torch.device("cpu"))(state)
    finally:
        ops.pack_bucket = pack
    want = checkpoint_from_state(state)
    equal = got["step"] == want["step"] and all(
        got[t].keys() == want[t].keys()
        and all(torch.equal(x, got[t][k]) for k, x in want[t].items())
        for t in ("params", "mu", "nu"))
    return {"bitwise": equal, "packs": len(calls)}


def ckpt_ranks(rank, out_dir):
    out = {}
    # a one-rank mesh in the four-rank world (ranks 1..3 outside it)
    m11 = Mesh.over_ranks((1, 1), ("data", "model"), ranks=[0],
                          device="cpu")
    if rank == 0:
        out["one_rank_gather"] = one_rank_gather(
            cfg_of("tinyllama-1.1b"), ShardingRules(m11))
    m22 = Mesh.over_ranks((2, 2), ("data", "model"), device="cpu")
    m41 = Mesh.over_ranks((4, 1), ("data", "model"), device="cpu")
    # the survivors' mesh of the elastic case: building it is collective
    m21 = Mesh.over_ranks((2, 1), ("data", "model"), ranks=[0, 1],
                          device="cpu")
    dense = cfg_of("tinyllama-1.1b")
    r22 = ShardingRules(m22)

    # (a) the five baselines on (2, 2), a failure at step 4, beside an
    # unfailed run; and the fault (e): Checkmate through the gated channel
    run(dense, lambda n: r22, out, "dense/none", NoCheckpointer)
    for name, cls in BASELINES.items():
        run(dense, lambda n: r22, out, f"dense/{name}", cls, fail=(4,))
    run(dense, lambda n: r22, out, "gate", channel=gate_channel,
        fail=(GATE_FAIL,))

    # (b) granite under FSDP on (4, 1)
    granite = cfg_of("granite-34b")
    f41 = ShardingRules(m41, fsdp=True)
    run(granite, lambda n: f41, out, "fsdp/none", NoCheckpointer)
    run(granite, lambda n: f41, out, "fsdp/sync", SyncCheckpointer,
        fail=(4,))

    # (c) arctic expert-parallel on (2, 2)
    arctic = cfg_of("arctic-480b")
    e22 = ShardingRules(m22, fsdp=arctic.fsdp)
    run(arctic, lambda n: e22, out, "ep/none", NoCheckpointer)
    run(arctic, lambda n: e22, out, "ep/async", AsyncCheckpointer,
        fail=(4,))

    # (d) the elastic shrink (4, 1) -> (2, 1) at the failure at 3, and a
    # second failure at 5 restored over the survivors' mesh
    r41, r21 = ShardingRules(m41), ShardingRules(m21)
    run(dense, lambda n: r41 if n == 0 else r21, out, "elastic",
        SyncCheckpointer, fail=(3, 5), steps=6, elastic_rules=r21)

    # (g) the CLI over the four ranks
    cli_dir = os.path.join(out_dir, "cli")
    os.makedirs(cli_dir, exist_ok=True)
    train_cli(rank, cli_dir, CLI_ARGV)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
