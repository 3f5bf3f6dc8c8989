"""The port's shadow cluster against the JAX package's, fed the same
delivery stream, and against the port's own trainer update.

Tolerance between the packages: rtol 1e-5 / atol 1e-6 on params and
moments after the stream (the JAX package computes ``b1 ** step`` on its
device, the port once on the host). Inside the port the cluster must be
bitwise equal to ``apply_updates``: both run the same AdamW with the same
f32 scalars; the per-leaf path (``flat=False``) and bounded-lag batched
replay must be bitwise equal to the flat, sequential cluster. Bucket
ownership, lost buckets and the stats fields must equal the JAX package's.
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

from repro_torch.convert import to_numpy
from repro_torch.core import channel as tch
from repro_torch.core import shadow as tsh
from repro_torch.core.buckets import layout_for_tree as t_layout
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


def _run_jax(params, grads, n_nodes, async_mode):
    layout = j_layout(params, cap_bytes=CAP)
    cl = jsh.ShadowCluster(layout, JOpt(), n_nodes=n_nodes,
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


def _run_port(params, grads, n_nodes, async_mode):
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    layout = t_layout(tparams, cap_bytes=CAP)
    cl = tsh.ShadowCluster(layout, OptimizerConfig(), n_nodes=n_nodes,
                           async_mode=async_mode, device="cpu")
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
