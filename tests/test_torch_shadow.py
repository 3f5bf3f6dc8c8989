"""The port's shadow cluster against the JAX package's, fed the same
delivery stream, and against the port's own trainer update.

Tolerance between the packages: rtol 1e-5 / atol 1e-6 on params and
moments after the stream (the JAX package computes ``b1 ** step`` on its
device, the port once on the host), for AdamW, Adam and SGD alike, and the
same on one leaf or flat update. Inside the port the cluster must be
bitwise equal to ``apply_updates``: both run the same update with the
same f32 scalars; the per-leaf path (``flat=False``) and bounded-lag
batched replay must be bitwise equal to the flat, sequential cluster.
Bucket ownership, lost buckets and the stats fields must equal the JAX
package's.
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

import repro.core.channel as jch
import repro.core.shadow as jsh
from repro.core.buckets import layout_for_tree as j_layout
from repro.optim import OptimizerConfig as JOpt
from repro.optim import functional as jfn

from repro_torch.convert import to_numpy
from repro_torch.core import channel as tch
from repro_torch.core import shadow as tsh
from repro_torch.core.buckets import layout_for_tree as t_layout
from repro_torch.optim import functional as tfn
from repro_torch.optim.functional import (OptimizerConfig, TrainState,
                                          apply_updates)

torch.set_num_threads(2)   # leave cores to the other test workers

SHAPES = {"a_embed": (64, 16), "b_norm": (16,), "c_w": (3, 16, 24),
          "d_out": (24, 64)}
CAP = 4096                      # several buckets, one dedicated
LRS = [1e-3, 2e-3, 5e-4, 1e-3]
SCALES = [1.0, 0.5, 1.0, 0.8]


def _stream(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in LRS]
    return params, grads


def _zeros(params):
    return {k: np.zeros_like(v) for k, v in params.items()}


def _run_jax(params, grads, n_nodes, async_mode, name="adamw"):
    layout = j_layout(params, cap_bytes=CAP)
    cl = jsh.ShadowCluster(layout, JOpt(name=name), n_nodes=n_nodes,
                           async_mode=async_mode)
    cl.bootstrap(params, _zeros(params), _zeros(params), 0)
    ch = jch.InProcessChannel()
    ch.open(layout)
    for i, (g, lr, sc) in enumerate(zip(grads, LRS, SCALES)):
        ch.send(jch.StepEvent(step=i + 1, grads=g, lr=lr, grad_scale=sc))
        for d in ch.poll():
            cl.on_delivery(d)
    out = cl.consolidate(timeout=30)
    cl.shutdown()
    return out


def _run_port(params, grads, n_nodes, async_mode, name="adamw"):
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    layout = t_layout(tparams, cap_bytes=CAP)
    cl = tsh.ShadowCluster(layout, OptimizerConfig(name=name),
                           n_nodes=n_nodes, async_mode=async_mode,
                           device="cpu")
    cl.bootstrap(tparams, _zeros(params), _zeros(params), 0)
    ch = tch.InProcessChannel()
    ch.open(layout)
    for i, (g, lr, sc) in enumerate(zip(grads, LRS, SCALES)):
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        ch.send(tch.StepEvent(step=i + 1, grads=tg, lr=lr, grad_scale=sc))
        for d in ch.poll():
            cl.on_delivery(d)
    out = cl.consolidate(timeout=30)
    stats = cl.stats()
    cl.shutdown()
    return out, stats, layout


@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("n_nodes", [1, 2])
def test_port_cluster_matches_jax_cluster(n_nodes, async_mode):
    params, grads = _stream()
    want = _run_jax(params, grads, n_nodes, async_mode)
    got, stats, layout = _run_port(params, grads, n_nodes, async_mode)
    assert len(layout.buckets) > 2
    assert got["step"] == want["step"] == len(LRS)
    assert stats.lag == 0 and stats.steps_applied == len(LRS)
    for tree in ("params", "mu", "nu"):
        assert set(got[tree]) == set(want[tree])
        for k in want[tree]:
            np.testing.assert_allclose(to_numpy(got[tree][k]),
                                       np.asarray(want[tree][k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{tree}[{k}]")


@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("n_nodes", [1, 2])
def test_port_cluster_bitwise_equals_apply_updates(n_nodes, async_mode):
    params, grads = _stream(1)
    got, _, _ = _run_port(params, grads, n_nodes, async_mode)
    state = TrainState(
        params={k: torch.from_numpy(v.copy()) for k, v in params.items()},
        mu={k: torch.zeros(s) for k, s in SHAPES.items()},
        nu={k: torch.zeros(s) for k, s in SHAPES.items()}, step=0)
    opt = OptimizerConfig()
    for g, lr, sc in zip(grads, LRS, SCALES):
        apply_updates(state, {k: torch.from_numpy(v) for k, v in g.items()},
                      opt, lr, sc)
    assert got["step"] == state.step
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(state, tree).items():
            assert torch.equal(got[tree][k], t), f"{tree}[{k}]"


def test_gated_delivery_is_refused():
    params, _ = _stream()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    layout = t_layout(tparams, cap_bytes=CAP)
    cl = tsh.ShadowCluster(layout, OptimizerConfig(), device="cpu")
    cl.bootstrap(tparams, _zeros(params), _zeros(params), 0)
    with pytest.raises(ValueError):
        cl.on_delivery(tch.Delivery(1, 1e-3, 1.0, complete=False))


def test_failed_async_apply_loses_exactly_that_nodes_buckets():
    """A worker whose apply raises loses its node; consolidation names the
    node's buckets and hands back the survivors' partition."""
    params, grads = _stream()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    layout = t_layout(tparams, cap_bytes=CAP)
    cl = tsh.ShadowCluster(layout, OptimizerConfig(), n_nodes=2,
                           async_mode=True, device="cpu")
    cl.bootstrap(tparams, _zeros(params), _zeros(params), 0)
    ch = tch.InProcessChannel()
    ch.open(layout)
    lost = cl.nodes[1]
    bid = lost.bucket_ids[0]
    ch.send(tch.StepEvent(step=1, grads={k: torch.from_numpy(v) for k, v
                                         in grads[0].items()}, lr=1e-3))
    (d,) = ch.poll()
    d.flats[bid] = d.flats[bid][:-1]           # a torn bucket: apply raises
    cl.on_delivery(d)
    with pytest.raises(tsh.ShadowNodeLoss) as exc:
        cl.consolidate(timeout=30)
    assert exc.value.dead_nodes == [1]
    assert exc.value.missing_buckets == {1: tuple(lost.bucket_ids)}
    assert exc.value.partial["step"] == 1
    cl.bootstrap(tparams, _zeros(params), _zeros(params), 0)   # revives
    assert cl.consolidate(timeout=30)["step"] == 0
    cl.shutdown()


def test_async_cluster_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    layout = t_layout({"x": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsh.ShadowCluster(layout, OptimizerConfig())


# -- the shadow remainder: flat=False, bounded lag, kill_node, stats --------

def _deliver(cl, layout, grads, lrs=LRS, scales=SCALES):
    ch = tch.InProcessChannel()
    ch.open(layout)
    for i, (g, lr, sc) in enumerate(zip(grads, lrs, scales)):
        ch.send(tch.StepEvent(step=i + 1, grads={
            k: torch.from_numpy(v) for k, v in g.items()}, lr=lr,
            grad_scale=sc))
        for d in ch.poll():
            cl.on_delivery(d)
    out = cl.consolidate(timeout=30)
    cl.shutdown()
    return out


def _cluster(params, **kw):
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    layout = t_layout(tparams, cap_bytes=CAP)
    cl = tsh.ShadowCluster(layout, OptimizerConfig(), device="cpu", **kw)
    cl.bootstrap(tparams, _zeros(params), _zeros(params), 0)
    return cl, layout


def _bitwise(a, b):
    assert a["step"] == b["step"]
    for tree in ("params", "mu", "nu"):
        assert set(a[tree]) == set(b[tree])
        for k in a[tree]:
            assert torch.equal(a[tree][k], b[tree][k]), f"{tree}[{k}]"


@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("n_nodes", [1, 2])
def test_per_leaf_shadow_bitwise_equals_flat(n_nodes, async_mode):
    """flat=False (one AdamW launch per leaf after an unpack) against the
    flat path: bitwise."""
    params, grads = _stream(2)
    want = _deliver(*_cluster(params, n_nodes=n_nodes), grads)
    cl, layout = _cluster(params, n_nodes=n_nodes, async_mode=async_mode,
                          flat=False)
    assert all(not n._pf and n.params for n in cl.nodes if n.bucket_ids)
    _bitwise(_deliver(cl, layout, grads), want)


def _throttle(monkeypatch, seconds):
    real = tsh.ShadowNode._apply

    def slow(self, *args):
        time.sleep(seconds)
        return real(self, *args)
    monkeypatch.setattr(tsh.ShadowNode, "_apply", slow)


@pytest.mark.parametrize("lag", [1, 2, 3])
def test_batched_replay_bitwise_equals_sequential_within_the_bound(
        lag, monkeypatch):
    params, _ = _stream(3)
    rng = np.random.default_rng(3)
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(8)]
    lrs, scales = [1e-3] * 8, [1.0, 0.5] * 4
    want = _deliver(*_cluster(params, n_nodes=2), grads, lrs, scales)
    _throttle(monkeypatch, 0.02)           # the applier falls behind
    cl, layout = _cluster(params, n_nodes=2, async_mode=True,
                          max_lag_steps=lag)
    got = _deliver(cl, layout, grads, lrs, scales)
    st = cl.stats()
    _bitwise(got, want)
    assert st.max_queue_depth <= lag and st.max_batch <= lag
    assert st.lag_waits > 0 and st.lag_wait_s > 0
    if lag > 2:     # one in flight and lag - 1 queued: drained together
        assert st.batched_applies > 0 and st.max_batch > 1
    assert st.lag == 0 and st.steps_applied == 8


def test_max_lag_steps_is_checked_like_jax():
    params, _ = _stream()
    for kw in (dict(max_lag_steps=0, async_mode=True),
               dict(max_lag_steps=2, async_mode=False)):
        with pytest.raises(ValueError):
            _cluster(params, **kw)
        with pytest.raises(ValueError):
            jsh.ShadowCluster(j_layout(params, cap_bytes=CAP), JOpt(), **kw)


@pytest.mark.parametrize("async_mode", [False, True])
def test_kill_node_loses_the_same_buckets_as_jax(async_mode):
    params, grads = _stream(4)
    jl = j_layout(params, cap_bytes=CAP)
    jcl = jsh.ShadowCluster(jl, JOpt(), n_nodes=3, async_mode=async_mode)
    jcl.bootstrap(params, _zeros(params), _zeros(params), 0)
    cl, layout = _cluster(params, n_nodes=3, async_mode=async_mode)
    ch = tch.InProcessChannel()
    ch.open(layout)
    ch.send(tch.StepEvent(step=1, lr=1e-3, grads={
        k: torch.from_numpy(v) for k, v in grads[0].items()}))
    (d,) = ch.poll()
    cl.on_delivery(d)
    for c in (jcl, cl):
        c.kill_node(1)
        c.kill_node(1)                      # idempotent
        with pytest.raises(ValueError):
            c.kill_node(3)
    with pytest.raises(jsh.ShadowNodeLoss) as jexc:
        jcl.consolidate(timeout=30)
    with pytest.raises(tsh.ShadowNodeLoss) as texc:
        cl.consolidate(timeout=30)
    assert texc.value.dead_nodes == jexc.value.dead_nodes == [1]
    assert texc.value.missing_buckets == jexc.value.missing_buckets
    assert texc.value.missing_buckets[1]
    assert set(texc.value.partial["params"]) == \
        set(jexc.value.partial["params"])
    cl.bootstrap(*[{k: torch.from_numpy(v) for k, v in t.items()}
                   for t in (params, _zeros(params), _zeros(params))], 0)
    assert cl.consolidate(timeout=30)["step"] == 0      # revived
    cl.shutdown()
    jcl.shutdown()


def test_shadow_stats_fields_match_jax():
    import dataclasses
    assert [f.name for f in dataclasses.fields(tsh.ShadowStats)] == \
        [f.name for f in dataclasses.fields(jsh.ShadowStats)]


def test_lag_bound_and_a_node_death_under_thread_stress(monkeypatch):
    """More shadow workers than cores, a tiny switch interval, a slow
    applier against a lag bound of 2, and a node killed mid-stream: the
    survivors end bitwise at the sequential cluster's state, the bound
    holds, and consolidation names exactly the dead node's buckets."""
    params, _ = _stream(5)
    rng = np.random.default_rng(5)
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(12)]
    lrs, scales = [1e-3] * 12, [1.0] * 12
    want = _deliver(*_cluster(params, n_nodes=2), grads, lrs, scales)
    _throttle(monkeypatch, 0.002)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        cl, layout = _cluster(params, n_nodes=(os.cpu_count() or 1) + 1,
                              async_mode=True, max_lag_steps=2)
        victim = next(n for n in cl.nodes if n.bucket_ids and n.node_id)
        workers = list(cl._workers)
        ch = tch.InProcessChannel()
        ch.open(layout)
        for i, g in enumerate(grads):
            ch.send(tch.StepEvent(step=i + 1, lr=lrs[i], grad_scale=1.0,
                                  grads={k: torch.from_numpy(v)
                                         for k, v in g.items()}))
            for d in ch.poll():
                cl.on_delivery(d)
            if i == 5:
                cl.kill_node(victim.node_id)
        with pytest.raises(tsh.ShadowNodeLoss) as exc:
            cl.consolidate(timeout=30)
        st = cl.stats()
        cl.shutdown()
    finally:
        sys.setswitchinterval(old)
    for t in workers:
        t.join(timeout=30)
        assert not t.is_alive()
    assert exc.value.dead_nodes == [victim.node_id]
    assert exc.value.missing_buckets == {victim.node_id:
                                         tuple(victim.bucket_ids)}
    partial = exc.value.partial
    assert partial["step"] == 12
    assert st.max_queue_depth <= 2 and st.max_batch <= 2
    lost = {s.name for b in layout.buckets if b.bucket_id in
            victim.bucket_ids for s in b.slots}
    for tree in ("params", "mu", "nu"):
        assert set(partial[tree]) == set(want[tree]) - lost
        for k, t in partial[tree].items():
            assert torch.equal(t, want[tree][k]), f"{tree}[{k}]"


# -- Adam and SGD --------------------------------------------------------------

@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_leaf_and_flat_updates_match_jax(name, flat):
    rng = np.random.default_rng(9)
    p, g, m = (rng.standard_normal(300).astype(np.float32) for _ in range(3))
    v = np.abs(rng.standard_normal(300)).astype(np.float32)
    jopt, topt = JOpt(name=name, momentum=0.8), \
        OptimizerConfig(name=name, momentum=0.8)
    for step, lr, scale in ((1, 1e-3, 1.0), (7, 3e-4, 0.625)):
        if flat:
            want = jfn.UPDATE_FNS_FLAT[name](p, g, m, v, np.float32(step),
                                             jopt, lr, scale)
            got = tfn.UPDATE_FNS_FLAT[name](*map(torch.from_numpy,
                                                 (p, g, m, v)),
                                            step, topt, lr, scale)
        else:
            want = jfn.UPDATE_FNS[name](p, g * np.float32(scale), m, v,
                                        np.float32(step), jopt, lr)
            got = tfn.UPDATE_FNS[name](*map(torch.from_numpy, (
                p, g * np.float32(scale), m, v)), step, topt, lr)
        for a, b, what in zip(got, want, "pmv"):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {what}")


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="lion"):
        OptimizerConfig(name="lion")


@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_adam_sgd_cluster_matches_jax_and_is_bitwise_the_trainer(
        name, async_mode):
    """The shadow's flat update (per bucket) against JAX to the stated
    tolerance, and bitwise the port's trainer update (per leaf)."""
    params, grads = _stream(6)
    want = _run_jax(params, grads, 2, async_mode, name)
    got, _, _ = _run_port(params, grads, 2, async_mode, name)
    state = TrainState(
        params={k: torch.from_numpy(v.copy()) for k, v in params.items()},
        mu={k: torch.zeros(s) for k, s in SHAPES.items()},
        nu={k: torch.zeros(s) for k, s in SHAPES.items()}, step=0)
    opt = OptimizerConfig(name=name)
    for g, lr, sc in zip(grads, LRS, SCALES):
        apply_updates(state, {k: torch.from_numpy(v) for k, v in g.items()},
                      opt, lr, sc)
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(state, tree).items():
            assert torch.equal(got[tree][k], t), f"{tree}[{k}]"
            np.testing.assert_allclose(to_numpy(t), np.asarray(want[tree][k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{tree}[{k}]")
    if name == "sgd":
        assert all(not t.any() for t in state.nu.values())


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_adam_sgd_per_leaf_shadow_bitwise_equals_flat(name):
    params, grads = _stream(7)
    want = _deliver(*_cluster(params, n_nodes=2), grads)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    layout = t_layout(tparams, cap_bytes=CAP)
    outs = []
    for flat in (True, False):
        cl = tsh.ShadowCluster(layout, OptimizerConfig(name=name),
                               n_nodes=2, device="cpu", flat=flat)
        cl.bootstrap(tparams, _zeros(params), _zeros(params), 0)
        outs.append(_deliver(cl, layout, grads))
    _bitwise(*outs)
    assert not torch.equal(outs[0]["params"]["a_embed"],
                           want["params"]["a_embed"])


# -- assignment, apply window, lagging buckets, lost-bucket counter -------------

def test_assignment_and_apply_times_window():
    params, grads = _stream(8)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    layout = t_layout(tparams, cap_bytes=CAP)
    owners = {b.bucket_id: (b.bucket_id + 1) % 3 for b in layout.buckets}
    cl = tsh.ShadowCluster(layout, OptimizerConfig(), n_nodes=3,
                           device="cpu", assignment=owners,
                           apply_times_maxlen=2)
    jcl = jsh.ShadowCluster(j_layout(params, cap_bytes=CAP), JOpt(),
                            n_nodes=3, assignment=owners)
    assert cl.assignment == owners
    assert [n.bucket_ids for n in cl.nodes] == \
        [n.bucket_ids for n in jcl.nodes]
    cl.bootstrap(tparams, _zeros(params), _zeros(params), 0)
    _bitwise(_deliver(cl, layout, grads),
             _deliver(*_cluster(params, n_nodes=2), grads))
    for n in cl.nodes:
        assert n.apply_count == len(LRS) and len(n.apply_times) == 2
        assert n.apply_times.maxlen == 2
    assert tsh.APPLY_TIMES_MAXLEN == jsh.APPLY_TIMES_MAXLEN
    jcl.shutdown()


def test_consolidation_timeout_names_lagging_buckets(monkeypatch):
    params, grads = _stream(9)
    _throttle(monkeypatch, 0.5)
    cl, layout = _cluster(params, n_nodes=2, async_mode=True)
    ch = tch.InProcessChannel()
    ch.open(layout)
    ch.send(tch.StepEvent(step=1, lr=1e-3, grads={
        k: torch.from_numpy(v) for k, v in grads[0].items()}))
    (d,) = ch.poll()
    cl.on_delivery(d)
    with pytest.raises(tsh.ConsolidationTimeout) as exc:
        cl.consolidate(timeout=0.01)
    e = exc.value
    assert e.lagging_nodes == [0, 1]
    assert e.lagging_buckets == {n.node_id: tuple(n.bucket_ids)
                                 for n in cl.nodes}
    assert "lagging buckets: " in str(e)
    assert cl.consolidate(timeout=30)["step"] == 1
    cl.shutdown()


def test_lost_buckets_are_counted_at_consolidate():
    from repro_torch import obs
    params, _ = _stream()
    cl, _ = _cluster(params, n_nodes=3)
    with obs.enabled_session() as ob:
        cl.kill_node(2)
        with pytest.raises(tsh.ShadowNodeLoss) as exc:
            cl.consolidate()
    assert not exc.value.total and exc.value.durable_hint is None
    assert ob.metrics.counter(
        "shadow_consolidate_missing_buckets_total").value() == \
        len(cl.nodes[2].bucket_ids) > 0
    cl.shutdown()


def test_plan_shadow_nodes_measures_one_apply():
    params, _ = _stream()
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    layout = t_layout(tparams, cap_bytes=CAP)
    n, t = tsh.plan_shadow_nodes(layout, OptimizerConfig(), 1e9, tparams,
                                 device="cpu")
    assert n == 1 and t > 0
    n, t = tsh.plan_shadow_nodes(layout, OptimizerConfig(name="sgd"), 1e-12,
                                 tparams, max_nodes=5, device="cpu")
    assert n == 5 and t > 0
