"""Rank workers of the port's multi-rank CPU tests (spawned by
``tests/_torch_spawn.py``; no JAX here: spawn imports this module).

``dp_train`` runs, on four gloo ranks, everything tests/test_torch_dp_train.py
holds against the reference's dump and writes what each rank saw to
``rank<r>.pt``. The drills (``elastic_across_meshes``, ``fsdp_to_dp``) are
tests/test_elastic.py's, on gloo ranks, with its checks and bounds;
``two_ranks`` is the 2-rank ``train(rules=)`` and ``recover(new_rules=)``
of tests/test_torch_elastic.py.
"""
import copy
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as TC
from repro_torch.convert import to_tensor
from repro_torch.core.buckets import build_buckets
from repro_torch.core.channel import InProcessChannel, StepEvent
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.costmodel import ElasticMeshBudget, plan_elastic_mesh
from repro_torch.core.elastic import rules_from_plan
from repro_torch.core.recovery import FailurePlan, recover
from repro_torch.core.shadow import ShadowCluster
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.dist.sharding import Mesh, ShardingRules
from repro_torch.models import registry
from repro_torch.optim.functional import OptimizerConfig, TrainState, \
    init_state
from repro_torch.optim.sharded import constrain_zero1, gather_zero1
from repro_torch.train.loop import RankCapture, train
from repro_torch.train.step import (build_train_step, make_train_state,
                                    state_sharding)

# the configs and optimizer both packages run. The clip binds (the
# reference's grad norms are about 6.6). AdamW's update g / (|g| + eps) is
# ill-conditioned where |g| is near eps: a small gradient element is a sum
# of larger terms that cancel, so the two frameworks' sums of it differ
# by up to about 6e-8 (1% of an element of 6e-6, within the gradient
# tolerance), and the param moves up to lr * clip scale * 6e-8 / eps apart
# in one step: 1.5e-5 at the default eps 1e-8, past the state tolerance.
# At eps 1e-5 that bound is 5e-7.
OPT = OptimizerConfig(lr=1e-3, eps=1e-5, grad_clip=0.5)
BATCH, SEQ = 16, 16


def lr_fn(step):
    return 1e-3


def dense_cfg():
    return TC.get("tinyllama-1.1b").reduced(compute_dtype="float32",
                                            microbatches=2)


def moe_cfg():
    # capacity factor 0.5: capacity binds in every group, at G = 4 and 1;
    # 2 microbatches: each group is a rank's rows of one microbatch
    return TC.get("arctic-480b").reduced(compute_dtype="float32",
                                         capacity_factor=0.5,
                                         microbatches=2)


def initial_state(ref, tag: str, cfg) -> TrainState:
    """The reference's initial params (full), zero moments."""
    return init_state({k: to_tensor(ref[f"{tag}/init/{k}"])
                       for k in registry.param_specs(cfg)})


def local_state(cfg, rules, full: TrainState) -> TrainState:
    p, m, v = state_sharding(cfg, rules).local(full.params, full.mu,
                                               full.nu)
    return TrainState(params=p, mu=m, nu=v, step=full.step)


def full_state(cfg, rules, state: TrainState) -> dict:
    p, m, v = state_sharding(cfg, rules).full(state.params, state.mu,
                                              state.nu)
    return {"params": p, "mu": m, "nu": v, "step": state.step}


def _run_steps(cfg, rules, state, steps, out, tag, batch=BATCH, opt=OPT):
    """``steps`` of the step over ``rules``: losses, the gathered reduced
    gradients, and the local and full state after them."""
    step = build_train_step(cfg, opt, lr_fn, rules)
    sh = step.sharding
    stream = SyntheticStream(cfg, batch, SEQ, seed=0)
    for t in range(steps):
        state, met, owned = step(state, device_batch(
            stream.batch_at(t), "cpu", rules, cfg.microbatches))
        out[f"{tag}/loss/{t}"] = float(met["loss"])
        out[f"{tag}/gnorm/{t}"] = float(met["grad_norm"])
        out[f"{tag}/grad/{t}"] = {k: sh.state[k].gather(g)
                                  for k, g in owned.items()}
    out[f"{tag}/local"] = {"params": state.params, "mu": state.mu,
                           "nu": state.nu}
    out[f"{tag}/full"] = full = full_state(cfg, rules, state)
    # the moments are the ZeRO-1 slices constrain_zero1 cuts, and
    # gather_zero1 is the way back
    specs = registry.param_specs(cfg)
    for tree in ("mu", "nu"):
        model = registry.tensor_parallel(cfg)
        cut = constrain_zero1(full[tree], specs, rules, model=model)
        back = gather_zero1(getattr(state, tree), specs, rules, model=model)
        for k, t in getattr(state, tree).items():
            assert torch.equal(cut[k], t) and cut[k].is_contiguous(), k
            assert torch.equal(back[k], full[tree][k]), k


def _captured_run(cfg, rules, state, steps, out, tag, batch=BATCH,
                  keep_shadow=False, opt=OPT):
    """``steps`` of the step with a `RankCapture` into a 2-node shadow on
    global rank 0: each rank's marks of each step, and on rank 0 the
    trainer's full state beside the shadow's consolidated checkpoint and
    the shadow's checkpoint count. With ``keep_shadow`` each rank's local
    state is kept too, and the shadow is returned (None off rank 0)
    instead of shut down."""
    step = build_train_step(cfg, opt, lr_fn, rules)
    sh = step.sharding
    layout = build_buckets([(k, sh.shapes[k], "float32")
                            for k in state.params])
    full = full_state(cfg, rules, state)
    ck = None
    if dist.get_rank() == 0:
        shadow = ShadowCluster(layout, opt, n_nodes=2, device="cpu")
        shadow.bootstrap(full["params"], full["mu"], full["nu"], 0)
        ck = CheckmateCheckpointer(shadow, channel=InProcessChannel())
    cap = RankCapture(sh, layout, torch.device("cpu"))
    stream = SyntheticStream(cfg, batch, SEQ, seed=0)
    for t in range(steps):
        state, met, owned = step(state, device_batch(
            stream.batch_at(t), "cpu", rules, cfg.microbatches))
        flats = cap(owned)
        out[f"{tag}/marks/{t}"] = list(cap.marks)
        out[f"{tag}/received/{t}"] = cap.received
        if ck is not None:
            ck.on_step(StepEvent(step=t + 1, flats=flats, lr=met["lr"],
                                 grad_scale=met["grad_scale"]))
    full = full_state(cfg, rules, state)
    if keep_shadow:
        out[f"{tag}/local"] = {"params": state.params, "mu": state.mu,
                               "nu": state.nu}
    if ck is not None:
        out[f"{tag}/trainer"] = full
        out[f"{tag}/shadow"] = ck.shadow.consolidate()
        out[f"{tag}/n_checkpoints"] = ck.n_checkpoints
        if keep_shadow:
            return ck.shadow
        ck.shadow.shutdown()
    return None


def _looped_run(cfg, rules, out, tag, batch=BATCH, opt=OPT):
    """train(rules=) with a failure at step 2 into a 2-node async shadow
    on rank 0: losses, recoveries, and on rank 0 the trainer's full state
    beside the shadow's checkpoint."""
    state, stats = train(cfg, steps=3, batch=batch, seq=SEQ, opt=opt,
                         lr_fn=lr_fn, device="cpu", rules=rules,
                         channel=InProcessChannel(), shadow_async=True,
                         failure_plan=FailurePlan((2,)), seed=0)
    out[f"{tag}/losses"] = stats.losses
    out[f"{tag}/recovered_at"] = stats.recovered_at
    full = full_state(cfg, rules, state)
    if dist.get_rank() == 0:
        out[f"{tag}/trainer"] = full
        out[f"{tag}/n_checkpoints"] = stats.checkpointer.n_checkpoints
        out[f"{tag}/shadow"] = stats.checkpointer.shadow.consolidate()
        stats.checkpointer.shadow.shutdown()


def dp_train(rank, ref_path, out_dir):
    ref = np.load(ref_path)
    out = {}
    dense, moe = dense_cfg(), moe_cfg()
    m41 = Mesh.over_ranks((4, 1), ("data", "model"), device="cpu")
    m22 = Mesh.over_ranks((2, 2), ("data", "model"), device="cpu")
    m221 = Mesh.over_ranks((2, 2, 1), ("pod", "data", "model"),
                           device="cpu")
    r41, r22 = ShardingRules(m41), ShardingRules(m22)
    fsdp41 = ShardingRules(m41, fsdp=True)
    start = initial_state(ref, "dense", dense)

    _run_steps(dense, r41, local_state(dense, r41, start), 3, out, "dense")
    _run_steps(dense, fsdp41, local_state(dense, fsdp41, start), 3, out,
               "fsdp")
    _run_steps(moe, r41, local_state(moe, r41, initial_state(
        ref, "moe", moe)), 2, out, "moe")
    _captured_run(dense, r41, local_state(dense, r41, start), 2, out,
                  "capture/4x1")
    _captured_run(dense, r22, local_state(dense, r22, start), 2, out,
                  "capture/2x2")
    # a family whose layers are whole over model: only model index 0 sends
    _captured_run(moe, r22, local_state(moe, r22, initial_state(
        ref, "moe", moe)), 2, out, "capture/moe2x2")
    _looped_run(dense, r41, out, "loop/4x1")
    _looped_run(dense, fsdp41, out, "loop/fsdp")

    # local() of the reference's cases on each mesh, with this rank's
    # coordinates
    x = torch.from_numpy(ref["x"])
    for name, mesh in (("4x1", m41), ("2x2", m22), ("2x2x1", m221)):
        out[f"coords/{name}"] = dict(mesh.coords)
        for fsdp in (0, 1):
            r = ShardingRules(mesh, fsdp=bool(fsdp))
            for i, logical in enumerate(SHARDING_CASES):
                sh = r.sharding(*logical, dims=x.shape)
                out[f"local/{name}/{fsdp}/{i}"] = sh.local(x).clone()
                out[f"spec/{name}/{fsdp}/{i}"] = repr(tuple(sh.spec))
                assert torch.equal(sh.gather(sh.local(x)), x)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


SHARDING_CASES = [("batch", "heads", None), ("heads", "wemb", None),
                  ("wemb", "ff", None)]

# three ranks: no dim of the reduced model (64, 256, 2, 16, ...) splits in
# three, so every leaf is replicated: all-reduced whole, and captured from
# dp rank 0 alone; a batch of 12 in 2 microbatches gives each rank 2 rows
THREE_BATCH = 12


def three_ranks(rank, out_dir):
    out = {}
    dense = dense_cfg()
    rules = ShardingRules(Mesh.over_ranks((3, 1), ("data", "model"),
                                          device="cpu"))
    start = init_state(registry.init_params(dense, 0, "cpu"))
    out["init"] = start.params
    _run_steps(dense, rules, local_state(dense, rules, start), 3, out,
               "dense", THREE_BATCH)
    _captured_run(dense, rules, local_state(dense, rules, start), 2, out,
                  "capture/3x1", THREE_BATCH)
    _looped_run(dense, rules, out, "loop/3x1", THREE_BATCH)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# -- the reference's multi-rank elastic drills (tests/test_elastic.py) -------

def _capture_steps(cfg, opt, rules, state, stream, steps):
    """``steps`` of the step over ``rules``, each capture through a
    `RankCapture` into a 2-node shadow on global rank 0 (the
    first-class checkpointer path). Returns (state, checkpointer on rank
    0 else None, the step function)."""
    step_fn = build_train_step(cfg, opt, lr_fn, rules)
    sh = step_fn.sharding
    layout = build_buckets([(k, sh.shapes[k], "float32")
                            for k in state.params])
    full = full_state(cfg, rules, state)
    ck = None
    if dist.get_rank() == 0:
        shadow = ShadowCluster(layout, opt, n_nodes=2, device="cpu")
        shadow.bootstrap(full["params"], full["mu"], full["nu"], 0)
        ck = CheckmateCheckpointer(shadow, channel=InProcessChannel())
    cap = RankCapture(sh, layout, torch.device("cpu"))
    for t in range(steps):
        state, m, g = step_fn(state, device_batch(
            stream.batch_at(t), "cpu", rules, cfg.microbatches))
        flats = cap(g)
        if ck is not None:
            ck.on_step(StepEvent(step=t + 1, lr=m["lr"], flats=flats,
                                 grad_scale=m["grad_scale"]))
    return state, ck, step_fn


def _params_close(got: dict, want: dict):
    # SPMD-vs-replay agreement, the reference's bound (<= 1 ULP f32)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def elastic_across_meshes(rank):
    """DP 4 x TP 2 -> lose ranks 4..7 -> replan DP 2 x TP 2 on the
    survivors, restore through `recover(new_rules=...)`, keep training.
    The lost ranks take part in the continuation on (4, 2) (the loss the
    shrunken mesh's step is held to) and in building the survivors' mesh
    before they leave."""
    cfg = TC.get("tinyllama-1.1b").reduced()
    opt = OptimizerConfig(lr=1e-3)
    budget = ElasticMeshBudget(model_parallel=2)

    # phase 1: the healthy world, 8 ranks as (4 data, 2 model)
    plan_a = plan_elastic_mesh(8, budget)
    assert plan_a.mesh_shape == (4, 2) and not plan_a.dropped
    rules_a = rules_from_plan(plan_a, device="cpu")
    state = make_train_state(cfg, 0, "cpu", rules_a)
    stream = SyntheticStream(cfg, 8, 32, seed=0)
    state, ck, step_a = _capture_steps(cfg, opt, rules_a, state, stream, 3)
    if ck is not None:
        assert ck.n_checkpoints == 3
    pre = copy.deepcopy(state)

    # the reference: continue on the original mesh with the same batch
    _, m_a, _ = step_a(state, device_batch(stream.batch_at(3), "cpu",
                                           rules_a, cfg.microbatches))
    loss_a = float(m_a["loss"])

    # phase 2: ranks 4..7 lost -> replan on the survivors; every rank
    # builds the survivors' mesh, then the lost ones leave
    plan_b = plan_elastic_mesh(range(4), budget)
    assert plan_b.dp == 2 and plan_b.mesh_shape == (2, 2)
    rules_b = rules_from_plan(plan_b, device="cpu")
    if not rules_b.mesh.is_member:
        assert rank >= 4
        return
    state_b, resume = recover(ck.shadow if ck is not None else None,
                              new_rules=rules_b, cfg=cfg)
    assert resume == 3 and state_b.step == 3
    _params_close(state_b.params, pre.params)
    step_b = build_train_step(cfg, opt, lr_fn, rules_b)
    state_b, m_b, _ = step_b(state_b, device_batch(
        stream.batch_at(3), "cpu", rules_b, cfg.microbatches))
    # continuing on a different mesh changes bf16 reduction orders, so the
    # comparison is loss-level, with the reference's bound
    assert abs(loss_a - float(m_b["loss"])) < 5e-3, (loss_a, m_b["loss"])
    assert state_b.step == 4
    if ck is not None:
        ck.shadow.shutdown()


def fsdp_to_dp(rank):
    """An FSDP-sharded run on 4 ranks restores onto a smaller pure-DP
    (replicated) mesh of 2: the planner flips the split, the
    consolidated tree lands exactly, and the next step runs."""
    cfg = TC.get("tinyllama-1.1b").reduced()
    opt = OptimizerConfig(lr=1e-3)
    plan_a = plan_elastic_mesh(4, ElasticMeshBudget(), fsdp=True)
    assert plan_a.fsdp and plan_a.dp == 4
    rules_a = rules_from_plan(plan_a, device="cpu")
    state = make_train_state(cfg, 1, "cpu", rules_a)
    stream = SyntheticStream(cfg, 8, 32, seed=1)
    state, ck, _ = _capture_steps(cfg, opt, rules_a, state, stream, 2)
    sh = state_sharding(cfg, rules_a)
    assert any(sh.params[k].n == 4 for k in state.params)   # FSDP cuts
    pre = full_state(cfg, rules_a, state)

    # the shrunken world drops FSDP: 2 survivors, fully replicated
    plan_b = plan_elastic_mesh(2, ElasticMeshBudget())
    assert not plan_b.fsdp and plan_b.dp == 2
    rules_b = rules_from_plan(plan_b, device="cpu")
    if not rules_b.mesh.is_member:
        return
    state_b, resume = recover(ck.shadow if ck is not None else None,
                              new_rules=rules_b, cfg=cfg)
    assert resume == 2
    _params_close(state_b.params, pre["params"])
    step_b = build_train_step(cfg, opt, lr_fn, rules_b)
    state_b, _, _ = step_b(state_b, device_batch(
        stream.batch_at(2), "cpu", rules_b, cfg.microbatches))
    assert state_b.step == 3
    if ck is not None:
        ck.shadow.shutdown()


def two_ranks(rank):
    """train(rules=) on a (2, 1) mesh with a failure at step 2, then
    recover(new_rules=) onto the same mesh: each rank's state is its
    trainer's slices bit for bit, at the last step."""
    cfg = TC.get("tinyllama-1.1b").reduced(compute_dtype="float32")
    rules = ShardingRules(Mesh.over_ranks((2, 1), ("data", "model"),
                                          device="cpu"))
    state, stats = train(cfg, steps=3, batch=4, seq=16, device="cpu",
                         rules=rules, channel=InProcessChannel(),
                         failure_plan=FailurePlan((2,)), seed=0)
    assert stats.steps == 3 and stats.recoveries == 1
    assert stats.recovered_at == [1] and len(stats.losses) == 3
    shadow = stats.checkpointer.shadow if rank == 0 else None
    back, resume = recover(shadow, new_rules=rules, cfg=cfg)
    assert resume == 3 and back.step == 3
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(state, tree).items():
            assert torch.equal(getattr(back, tree)[k], t), (tree, k)
    if shadow is not None:
        shadow.shutdown()


def serve_rows(rank, out_dir, args):
    """The serving CLI's generation over a (4, 1) mesh: this rank's rows,
    the tokens gathered over the dp ranks, at f32."""
    from argparse import Namespace

    from repro_torch.launch.serve import generate
    mesh = Mesh.over_ranks((4, 1), ("data", "model"), device="cpu")
    cfg = TC.get("tinyllama-1.1b").reduced(compute_dtype="float32")
    out, _, _ = generate(cfg, Namespace(**args), torch.device("cpu"),
                         ShardingRules(mesh))
    np.save(os.path.join(out_dir, f"serve{rank}.npy"), out)


def train_cli(rank, out_dir, argv):
    """The training CLI's ``--mesh single`` path over four gloo ranks: the
    production mesh stood in for by a (4, 1) one over the same group."""
    import json

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launch_train
    launch_mesh.make_production_mesh = lambda multi_pod=False, device=None: \
        Mesh.over_ranks((4, 1), ("data", "model"), device=device)
    r = launch_train.run(argv + ["--mesh", "single"])
    if rank == 0:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(r.report, f)
    else:
        assert r.report is None and r.checkpointer is None
