"""The tensor-parallel pieces of the port on the CPU, each on its own.

- two-dim `NamedSharding` cuts (a dim over ``model`` and one over the dp
  axes) against the reference's specs, on stand-in meshes;
- the Functions of `repro_torch.dist.tensor_parallel` as the identity at
  ``model`` extent 1, and the step there bitwise the step without rules;
- the Functions and the vocab-parallel embedding and loss on two gloo
  ranks against the same computation done whole (`_torch_spawn`);
- the flash wrapper's ``q_offset`` (its plain version) against the
  reference's ``_flash_fwd_core`` and against the matching rows of the
  whole attention, and the backward against the reference's ``_flash_bwd``;
- ``flash_work``'s pair count with an offset;
- the dry run's tensor-parallel tinyllama train step on a fake (1, 16)
  mesh against its replicated trace (a subprocess: a fake world is a
  default process group).

Tolerances: flash at f32 to rtol 1e-5 / atol 1e-6, as
tests/test_torch_kernels.py.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.dist.sharding import ShardingRules as JRules
from repro.models import registry as JR
from repro.models.layers import _flash_fwd_core, flash_attention_jnp
from repro.optim.sharded import zero1_spec as j_zero1_spec

from _torch_spawn import spawn

from repro_torch import configs as TC
from repro_torch.convert import to_tensor
from repro_torch.data.synthetic import SyntheticStream, device_batch, \
    local_rows
from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import causal_pairs, flash_work
from repro_torch.kernels.ref import causal_mask
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.optim.functional import OptimizerConfig, init_state
from repro_torch.optim.sharded import StateSharding
from repro_torch.train.step import build_train_step

import repro.configs as C

torch.set_num_threads(2)   # leave cores to the other test workers

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
F32 = dict(rtol=1e-5, atol=1e-6)


class _FakeRank:
    """Rank ``rank`` of a stand-in mesh, row-major, with an
    ``all_gather`` that returns the slices in ``peers`` of the ranks that
    differ from it only along the gathered axes."""

    def __init__(self, shape, rank):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (int(c) for c in
                                                 np.unravel_index(
                                                     rank, tuple(
                                                         shape.values())))))
        self.peers = {}

    def extent(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def coordinate(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def all_gather(self, t, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = tuple(self.shape.values())
        out = []
        for r in range(self.size):
            c = dict(zip(self.axis_names, np.unravel_index(r, dims)))
            if all(c[a] == self.coords[a] for a in self.axis_names
                   if a not in axes):
                out.append((tuple(int(c[a]) for a in axes), self.peers[r]))
        return [t for _, t in sorted(out, key=lambda e: e[0])]


def _shard_shape(shape, spec, mesh_shape):
    """The per-device shape a JAX spec gives ``shape`` on a mesh."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for n, p in zip(shape, parts):
        axes = () if p is None else ((p,) if isinstance(p, str) else p)
        out.append(n // int(np.prod([mesh_shape[a] for a in axes])))
    return tuple(out)


@pytest.mark.parametrize("mesh", [{"data": 4, "model": 2},
                                  {"data": 16, "model": 16},
                                  {"pod": 2, "data": 16, "model": 16}])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-34b",
                                  "llava-next-mistral-7b", "gpt2-1.5b"])
def test_two_dim_cuts_match_the_references_specs(arch, mesh):
    """Every leaf's param and ZeRO-1 state local shapes on rank 0 of the
    tensor-parallel layout equal the per-device shapes of the reference's
    specs (its param spec, and ``zero1_spec`` over it): one dim cut over
    ``model`` and, independently, one over the dp axes (FSDP's wemb for
    granite)."""
    cfg = TC.get(arch)
    jspecs = JR.param_specs(C.get(arch))
    m = _FakeRank(mesh, 0)
    rules = ShardingRules(m, fsdp=cfg.fsdp)
    jr = JRules(m, fsdp=cfg.fsdp)
    sh = StateSharding(registry.param_specs(cfg), rules, model=True)
    twice = 0
    for k, ps in jspecs.items():
        pspec = jr.spec(*ps.logical, dims=ps.shape)
        zspec = j_zero1_spec(ps.shape, pspec, m)
        assert sh.params[k].local_shape(ps.shape) == \
            _shard_shape(ps.shape, pspec, mesh), k
        assert sh.state[k].local_shape(ps.shape) == \
            _shard_shape(ps.shape, zspec, mesh), k
        twice += sh.state[k].m > 1 and sh.state[k].n > 1
    assert twice > 0


def test_two_dim_cuts_tile_every_leaf_once():
    """On a (2, 2) stand-in mesh every rank's two-dim slices of each
    reduced tinyllama leaf cover it exactly once, ``gather`` (one
    all-gather over both axes) rebuilds it, and ``dp_local`` of the
    model slice is the two-dim slice."""
    cfg = TC.get("tinyllama-1.1b").reduced()
    specs = registry.param_specs(cfg)
    ranks = [_FakeRank({"data": 2, "model": 2}, r) for r in range(4)]
    shs = [StateSharding(specs, ShardingRules(m), model=True) for m in ranks]
    for k, ps in specs.items():
        x = torch.arange(math.prod(ps.shape), dtype=torch.float32).reshape(
            ps.shape)
        count = torch.zeros(ps.shape)
        for sh in shs:
            mark = torch.zeros(ps.shape)
            sh.state[k].local(mark).fill_(1.0)
            count += mark
        for m in ranks:
            m.peers = {p.rank: shs[p.rank].state[k].local(x) for p in ranks}
        for m, sh in zip(ranks, shs):
            z = sh.state[k]
            assert torch.equal(z.gather(z.local(x)), x), k
            model_local = sh.params[k].local(x)
            assert torch.equal(z.dp_local(model_local), z.local(x)), k
        # every element of a leaf cut over both is held by exactly one
        # rank; a dim held whole is held by every rank along it
        held = 4 // (shs[0].state[k].m * shs[0].state[k].n)
        assert torch.equal(count, torch.full(ps.shape, float(held))), k


def test_functions_are_the_identity_at_model_extent_one():
    """On a one-rank mesh (no process group at all, so a collective would
    raise) each Function returns its input and passes its gradient as it
    is, ``context`` is None, and the step under the smoke mesh's rules is
    bitwise the step without rules."""
    mesh = make_smoke_mesh("cpu")
    tp = TP.ModelParallel(mesh, ("wq", "embed"))
    assert tp.size == 1 and tp.rank == 0
    x = torch.randn(3, 4, requires_grad=True)
    for fn in (lambda t: TP.copy_to_model(t, tp),
               lambda t: TP.reduce_from_model(t, tp),
               lambda t: TP.gather_from_model(t, -1, tp),
               lambda t: TP.gather_rows(t, 1, tp),
               lambda t: TP.whole(t, "wq", -1, tp),
               lambda t: TP.whole(t, "wk", -1, tp)):
        y = fn(x)
        assert y is x
    cfg = TC.get("tinyllama-1.1b").reduced(compute_dtype="float32")
    rules = ShardingRules(mesh)
    assert TP.context(rules, registry.param_specs(cfg)) is None
    assert TP.context(None, registry.param_specs(cfg)) is None
    init = registry.init_params(cfg, 0, "cpu")
    a = init_state({k: t.clone() for k, t in init.items()})
    b = init_state({k: t.clone() for k, t in init.items()})
    with_rules = build_train_step(cfg, OptimizerConfig(), lambda s: 1e-3,
                                  rules)
    without = build_train_step(cfg, OptimizerConfig(), lambda s: 1e-3)
    stream = SyntheticStream(cfg, 4, 16, seed=0)
    for t in range(2):
        batch = device_batch(stream.batch_at(t), "cpu")
        a, ma, ga = with_rules(a, batch)
        b, mb, gb = without(b, batch)
        assert torch.equal(ma["loss"], mb["loss"])
        for k in ga:
            assert torch.equal(ga[k], gb[k]), k
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k])


def test_functions_on_two_ranks(tmp_path):
    """copy_to_model, reduce_from_model, gather_from_model and gather_rows
    forward and backward on two gloo ranks (``_torch_tp_workers``)."""
    spawn("_torch_tp_workers", "functions", 2, tmp_path, str(tmp_path))
    for r in range(2):
        assert torch.load(tmp_path / f"rank{r}.pt")["ok"]


@pytest.mark.parametrize("labels_low", [False, True])
def test_vocab_parallel_loss_matches_xent_loss(tmp_path, labels_low):
    """The vocab split by hand over two ranks: the vocab-parallel
    embedding, logits and loss against ``embed_tokens``, ``lm_logits``
    and ``xent_loss`` on the whole vocab, and their gradients against the
    whole ones' slices; with every token and label in rank 0's half, rank
    1's rows get no gradient."""
    spawn("_torch_tp_workers", "vocab", 2, tmp_path, str(tmp_path),
          labels_low)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["loss"] == pytest.approx(got[0]["whole"], rel=1e-6)


def test_local_rows_are_the_same_on_every_model_rank():
    """Every model rank of one dp index takes the same batch rows (the
    reference shards the batch over the dp axes only), on a (2, 2) and a
    (1, 4) stand-in mesh."""
    for shape in ({"data": 2, "model": 2}, {"data": 1, "model": 4}):
        ranks = [_FakeRank(shape, r) for r in range(4)]
        rows = {}
        for m in ranks:
            got = list(local_rows(16, ShardingRules(m), 2))
            rows.setdefault(m.coords["data"], []).append(got)
        for dp, per_model in rows.items():
            assert len(per_model) == shape["model"]
            assert all(r == per_model[0] for r in per_model), (shape, dp)
        assert sorted(sum((v[0] for v in rows.values()), [])) == \
            list(range(16))


# -- flash with a q_offset ---------------------------------------------------

def _qkv(rng, b, sq, skv, h, kv, d):
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sq,skv,off", [(8, 16, 8), (8, 16, 4), (8, 16, 0),
                                        (5, 12, 7), (16, 16, 0)])
def test_flash_q_offset_matches_the_references_core(sq, skv, off):
    """o and lse of the wrapper's plain version at ``q_offset`` against
    the reference's ``_flash_fwd_core(q, k, v, True, q_offset)``, and o
    against the rows ``off .. off + sq`` of the whole attention (the
    sequence-sharded attention's rows)."""
    rng = np.random.default_rng(sq * 100 + off)
    q, k, v = _qkv(rng, 2, sq, skv, 4, 4, 16)
    o, lse = ops.flash_attention(to_tensor(q), to_tensor(k), to_tensor(v),
                                 True, off)
    jo, jlse = _flash_fwd_core(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), True, off)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **F32)
    if off + sq <= skv:
        qf = rng.standard_normal((2, skv, 4, 16)).astype(np.float32) * 0.5
        qf[:, off:off + sq] = q
        of, _ = ops.flash_attention(to_tensor(qf), to_tensor(k),
                                    to_tensor(v), True)
        np.testing.assert_allclose(o.numpy(), of[:, off:off + sq].numpy(),
                                   **F32)


@pytest.mark.parametrize("kv", [4, 2, 1])
def test_flash_backward_with_q_offset_matches_the_reference(kv):
    """The gradients of ``FlashAttention`` at ``q_offset`` (the plain
    recompute-from-lse backward, `flash_attention_bwd`) against
    ``jax.vjp`` of the reference's ``flash_attention_jnp`` with the same
    offset, on kv expanded to the heads as the reference takes it (GQA's
    kv gradients summed over each group)."""
    rng = np.random.default_rng(kv)
    b, sq, skv, h, d, off = 2, 6, 16, 4, 8, 10
    q, k, v = _qkv(rng, b, sq, skv, h, kv, d)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    tq, tk, tv = (to_tensor(x).requires_grad_(True) for x in (q, k, v))
    o = L.FlashAttention.apply(tq, tk, tv, True, off)
    dq, dk, dv = torch.autograd.grad(o, (tq, tk, tv), to_tensor(do))
    ke, ve = (np.repeat(x, h // kv, axis=2) for x in (k, v))
    jo, vjp = jax.vjp(lambda a, bb, c: flash_attention_jnp(a, bb, c, True,
                                                          off),
                      jnp.asarray(q), jnp.asarray(ke), jnp.asarray(ve))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **F32)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), **F32)
    for got, want in ((dk, jdk), (dv, jdv)):
        want = np.asarray(want).reshape(b, skv, kv, h // kv, d).sum(3)
        np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("sq,skv,off", [(8, 16, 8), (8, 16, 3), (16, 8, 0),
                                        (8, 8, 0), (4, 16, 20), (7, 5, 2),
                                        (256, 4096, 3840)])
def test_flash_work_counts_the_pairs_the_offset_mask_keeps(sq, skv, off):
    """``causal_pairs`` equals the pairs ``causal_mask`` keeps at the
    offset, and ``flash_work`` prices 4 b h d FLOPs a pair."""
    keep = int(causal_mask(sq, skv, "cpu", off).sum())
    assert causal_pairs(sq, skv, off) == keep
    q = torch.empty((2, sq, 4, 16), device="meta")
    k = torch.empty((2, skv, 2, 16), device="meta")
    assert flash_work(q, k, True, off)[0] == 4.0 * 2 * 4 * 16 * keep
    if off == 0:
        assert flash_work(q, k, True)[0] == flash_work(q, k, True, 0)[0]


def test_flash_refuses_a_negative_offset():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, q, q, True, -1)


# -- the dry run's tensor-parallel trace --------------------------------------

DRYRUN = """
import json, sys
import repro_torch.configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.sharding import Mesh, ShardingRules
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import registry
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.step import abstract_train_state, build_train_step

import dataclasses
cfg = dataclasses.replace(C.get("tinyllama-1.1b"), num_layers=2)
shape = ShapeConfig("train_4k", 4096, 16, "train")
out = {}
with fake_world(16):
    mesh = Mesh.over_ranks((1, 16), ("data", "model"), device="cpu")
    rules = ShardingRules(mesh)
    for label in ("tp", "replicated"):
        if label == "replicated":
            registry.TENSOR_PARALLEL = frozenset()
        step = build_train_step(cfg, OptimizerConfig(), lambda s: 1e-3, rules)
        r = analyze_step(step, abstract_train_state(cfg, rules),
                         registry.input_specs(cfg, shape, rules))
        out[label] = {"flops": r["flops_per_device"],
                      "bytes": r["memory"]["argument_bytes"]
                      + r["memory"]["temp_bytes"],
                      "collectives": sorted(r["per_collective"]),
                      "flash": r["kernels"]["flash_attention"]["flops"]}
json.dump(out, open(sys.argv[1], "w"))
"""


def test_dryrun_tensor_parallel_step_cuts_the_work(tmp_path):
    """tinyllama-1.1b at full width (2 layers), a train_4k cell of 16 x
    4096 on rank 0 of a fake (1, 16) mesh: the tensor-parallel step's
    FLOPs at most 1/8 of the same step traced with every layer whole
    (the products, the attention core and the logits cut 16 ways), its
    flash work a sixteenth, its predicted bytes lower, and its
    collectives the model group's all-reduce and all-gather."""
    path = str(tmp_path / "dr.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(DRYRUN),
                          path], capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path) as f:
        got = json.load(f)
    tp, rep = got["tp"], got["replicated"]
    assert tp["flops"] <= rep["flops"] / 8, (tp, rep)
    assert tp["flash"] * 16 == pytest.approx(rep["flash"], rel=1e-9)
    assert tp["bytes"] < rep["bytes"]
    assert "allreduce_" in tp["collectives"]
    assert rep["collectives"] == []
