"""Rank workers of the port's tensor-parallel CPU tests (spawned by
``tests/_torch_spawn.py``; no JAX here: spawn imports this module).

``tp_train`` runs, on four gloo ranks, everything
tests/test_torch_tp_train.py holds against the reference's dump on a
(2, 2) ("data", "model") mesh and writes what each rank saw to
``rank<r>.pt``. ``functions`` and ``vocab`` hold the Functions of
`repro_torch.dist.tensor_parallel` and its vocab-parallel embedding and
loss on two ranks against the same computation done whole.
"""
import os

import numpy as np
import torch

from _torch_dp_workers import (SEQ, _captured_run, _looped_run,
                               _run_steps, full_state, initial_state,
                               local_state, lr_fn)

from repro_torch import configs as TC
from repro_torch.core.costmodel import ElasticMeshBudget, plan_elastic_mesh
from repro_torch.core.elastic import rules_from_plan
from repro_torch.core.recovery import recover
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.sharding import Mesh, ShardingRules
from repro_torch.models import layers as L
from repro_torch.optim.functional import OptimizerConfig, TrainState
from repro_torch.train.step import build_train_step, state_sharding

# tag -> (arch, overrides of .reduced()): every cut on whole heads; wk and
# wv cut inside their one kv head (gathered); 3 heads over 2 ranks (the
# sequence-sharded attention, wq cut at 1.5 heads); a vocab of 255 (the
# vocab whole on every rank); granite's gelu2 MLP under its FSDP; the vlm
CASES = {"dense": ("tinyllama-1.1b", {}),
         "kv1": ("tinyllama-1.1b", {"num_kv_heads": 1}),
         "seq": ("tinyllama-1.1b", {"num_heads": 3, "num_kv_heads": 1}),
         "vocab": ("tinyllama-1.1b", {"vocab_size": 255}),
         "granite": ("granite-34b", {}),
         "vlm": ("llava-next-mistral-7b", {})}
STEPS = 3
# AdamW's update g / (sqrt(v) + eps) moves a param by up to lr * clip *
# dg / eps where two frameworks' sums of a gradient element differ by dg
# (tests/_torch_dp_workers.py explains the bound). Tensor parallelism sums
# each product in two partial halves and an all-reduce, an order neither
# the one-rank port nor XLA uses, and at eps 1e-5 the params after two
# steps already differ by 1.6e-6 between the port's (2, 2) and one-rank
# runs, which leaves the third step's cancelling gradient elements 1.8
# times the gradient tolerance apart. At eps 1e-4 that bound is ten times
# smaller, and the comparison measures the layers rather than AdamW's
# conditioning.
EPS = 1e-4
OPT = OptimizerConfig(lr=1e-3, eps=EPS, grad_clip=0.5)


def case_cfg(tag: str, cases=CASES):
    arch, over = cases[tag]
    return TC.get(arch).reduced(compute_dtype="float32", microbatches=2,
                                **over)


def _equal(a: dict, b: dict, what: str):
    for k, t in a.items():
        assert torch.equal(t, b[k]), (what, k)


def run_cases(ref, cases: dict, mesh, out: dict):
    """``STEPS`` steps of every case on ``mesh`` from the reference's
    initial params, and each leaf's (model, dp) cut counts."""
    for tag in cases:
        cfg = case_cfg(tag, cases)
        rules = ShardingRules(mesh, fsdp=cfg.fsdp)
        start = initial_state(ref, tag, cfg)
        _run_steps(cfg, rules, local_state(cfg, rules, start), STEPS, out,
                   tag, opt=OPT)
        sh = state_sharding(cfg, rules)
        out[f"{tag}/cuts"] = {k: (z.m, z.n) for k, z in sh.params.items()}


def tp_train(rank, ref_path, out_dir):
    ref = np.load(ref_path)
    out = {}
    m22 = Mesh.over_ranks((2, 2), ("data", "model"), device="cpu")
    run_cases(ref, CASES, m22, out)

    # inside the port, on the dense case: the capture and the loop
    dense = case_cfg("dense")
    r22 = ShardingRules(m22)
    start = initial_state(ref, "dense", dense)
    shadow = _captured_run(dense, r22, local_state(dense, r22, start), 2,
                           out, "capture/tp", keep_shadow=True, opt=OPT)
    _looped_run(dense, r22, out, "loop/tp", opt=OPT)
    resume_on_other_meshes(dense, r22, shadow, out, "capture/tp")
    if shadow is not None:
        shadow.shutdown()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def resume_on_other_meshes(cfg, r22, shadow, out: dict, tag: str):
    """The (2, 2) run's checkpoint at step 2 (``shadow`` on rank 0, the
    captured run ``tag``) onto (4, 1) and (1, 4): each rank's recovered
    slices bitwise the trainer's state handed straight over, and one step
    from each bitwise the same."""
    for name, mp in (("4x1", 1), ("1x4", 4)):
        nr = rules_from_plan(plan_elastic_mesh(
            4, ElasticMeshBudget(model_parallel=mp), fsdp=cfg.fsdp),
            device="cpu")
        assert nr.mesh.shape == ({"data": 4, "model": 1} if mp == 1
                                 else {"data": 1, "model": 4})
        state, resume = recover(shadow, new_rules=nr, cfg=cfg)
        assert resume == 2 and state.step == 2
        # the port's own uninterrupted run: the (2, 2) trainer's state at
        # step 2 handed straight to the new mesh (every rank gathers it)
        full = full_state(cfg, r22, _restate(out, tag))
        direct = local_state(cfg, nr, TrainState(
            full["params"], full["mu"], full["nu"], 2))
        for tree in ("params", "mu", "nu"):
            _equal(getattr(state, tree), getattr(direct, tree),
                   f"recovered {name} {tree}")
        step = build_train_step(cfg, OPT, lr_fn, nr)
        batch = device_batch(SyntheticStream(cfg, 16, SEQ, seed=0)
                             .batch_at(2), "cpu", nr, cfg.microbatches)
        state, met, _ = step(state, batch)
        direct, met_d, _ = step(direct, dict(batch))
        for tree in ("params", "mu", "nu"):
            _equal(getattr(state, tree), getattr(direct, tree),
                   f"resumed {name} {tree}")
        assert float(met["loss"]) == float(met_d["loss"])
        out[f"resume/{name}/loss"] = float(met["loss"])
        out[f"resume/{name}/local"] = {k: tuple(t.shape)
                                       for k, t in state.params.items()}


def _restate(out: dict, tag: str) -> TrainState:
    """This rank's local state at the end of the captured run ``tag``."""
    loc = out[f"{tag}/local"]
    return TrainState(loc["params"], loc["mu"], loc["nu"], 2)


# -- the Functions and the vocab-parallel layers on two ranks ------------------

def functions(rank, out_dir):
    """copy_to_model, reduce_from_model, gather_from_model and gather_rows
    on two ranks, forward and backward, against what each computes on the
    whole."""
    mesh = Mesh.over_ranks((1, 2), ("data", "model"), device="cpu")
    tp = TP.ModelParallel(mesh, ())
    assert (tp.size, tp.rank) == (2, rank)
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(3, 4, generator=gen) for _ in range(2)]
    gs = [torch.randn(3, 8, generator=gen) for _ in range(2)]
    x = xs[rank].clone().requires_grad_(True)
    # copy: identity forward, the gradients summed
    y = TP.copy_to_model(x, tp)
    assert torch.equal(y, xs[rank])
    (g,) = torch.autograd.grad(y, x, gs[rank][:, :4])
    assert torch.allclose(g, gs[0][:, :4] + gs[1][:, :4])
    # reduce: the sum forward, the gradient as it is
    y = TP.reduce_from_model(x, tp)
    assert torch.allclose(y, xs[0] + xs[1])
    (g,) = torch.autograd.grad(y, x, gs[rank][:, :4])
    assert torch.equal(g, gs[rank][:, :4])
    # gather along dim 1: the slices joined, the gradient reduce-scattered
    y = TP.gather_from_model(x, -1, tp)
    assert torch.equal(y, torch.cat(xs, dim=1))
    (g,) = torch.autograd.grad(y, x, gs[rank])
    assert torch.allclose(g, (gs[0] + gs[1])[:, 4 * rank:4 * rank + 4])
    # rows: joined forward, this rank's rows of the whole gradient back
    y = TP.gather_rows(x, 1, tp)
    assert torch.equal(y, torch.cat(xs, dim=1))
    (g,) = torch.autograd.grad(y, x, gs[0])
    assert torch.equal(g, gs[0][:, 4 * rank:4 * rank + 4])
    torch.save({"ok": True}, os.path.join(out_dir, f"rank{rank}.pt"))


def vocab(rank, out_dir, labels_low: bool):
    """The vocab-parallel embedding, logits and cross entropy on two ranks
    (each holding half the vocab) against the whole ones, forward and
    the gradients of the embedding rows, the unembedding columns and the
    hidden states. ``labels_low``: every label and token in rank 0's
    half, so rank 1's range is never hit."""
    mesh = Mesh.over_ranks((1, 2), ("data", "model"), device="cpu")
    tp = TP.ModelParallel(mesh, ("embed", "unembed"))
    gen = torch.Generator().manual_seed(1)
    v, d = 10, 6
    embed = torch.randn(v, d, generator=gen)
    unembed = torch.randn(d, v, generator=gen)
    hi = v // 2 if labels_low else v
    tokens = torch.randint(0, hi, (3, 5), generator=gen)
    labels = torch.randint(0, hi, (3, 5), generator=gen)
    h = torch.randn(3, 5, d, generator=gen)

    def run(e, u, x, t):
        x = x.requires_grad_(True)
        emb = L.embed_tokens(e, tokens, torch.float32, t)
        logits = L.lm_logits(x + emb, u, t)
        loss = L.xent_loss(logits, labels, t)
        return loss, torch.autograd.grad(loss, (e, u, x))
    whole = run(embed.clone().requires_grad_(True),
                unembed.clone().requires_grad_(True), h.clone(), None)
    lo, n = rank * v // 2, v // 2
    part = run(embed[lo:lo + n].clone().requires_grad_(True),
               unembed[:, lo:lo + n].clone().requires_grad_(True), h.clone(),
               tp)
    assert torch.allclose(part[0], whole[0], rtol=1e-6, atol=1e-6)
    ge, gu, gx = part[1]
    assert torch.allclose(ge, whole[1][0][lo:lo + n], rtol=1e-5, atol=1e-6)
    assert torch.allclose(gu, whole[1][1][:, lo:lo + n], rtol=1e-5,
                          atol=1e-6)
    # the hidden state's gradient is the whole one once copy_to_model has
    # summed the ranks' parts
    assert torch.allclose(gx, whole[1][2], rtol=1e-5, atol=1e-6)
    if labels_low and rank == 1:
        assert not ge.any()
    torch.save({"loss": float(part[0]), "whole": float(whole[0])},
               os.path.join(out_dir, f"rank{rank}.pt"))
