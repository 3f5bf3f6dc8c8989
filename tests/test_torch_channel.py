"""The port's `PacketizedChannel` and the sharded per-owner gate against the
JAX package's, on the CPU.

Tolerance 0 between the packages where bytes and the fabric are compared:
both channels are fed the same numpy flats (or leaf trees) made from a
seed, and must deliver identical bytes with the same `FabricResult`,
``complete``, ``missing_captures``, ``node_complete`` and
``missing_buckets``, over the same wire geometry. Inside the port the
shadow's checkpoint over the fabric must be bitwise the in-process one's
and the trainer's. Losses against the JAX ``train`` over its own
`PacketizedChannel`: rtol 1e-4 at f32 compute, the tolerance of
``tests/test_torch_system.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import repro.configs as C
import repro.core.channel as jch
import repro.core.checkpoint as jck
import repro.core.shadow as jsh
import repro.net.simulator as jsim
from repro.core.buckets import layout_for_tree as j_layout
from repro.dist.sharding import ShardingRules, make_smoke_mesh
from repro.optim import OptimizerConfig as JOpt
from repro.train.loop import train as jtrain
from repro.train.step import make_train_state as j_make_state

import repro_torch.core.channel as tch
import repro_torch.core.checkpoint as tck
import repro_torch.core.shadow as tsh
import repro_torch.net.simulator as tsim
from repro_torch import configs as TC
from repro_torch.convert import state_from_numpy
from repro_torch.core.buckets import layout_for_tree as t_layout
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.shadow import ShadowCluster, ShadowNodeLoss
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.loop import train

torch.set_num_threads(2)   # leave cores to the other test workers

asdict = dataclasses.asdict


def _tree(n_leaves, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {f"leaf{k}": rng.standard_normal((6 + 2 * k, 5 + k)).astype(dtype)
            for k in range(n_leaves)}


def _layouts(params, cap):
    return (j_layout(params, cap_bytes=cap),
            t_layout({k: torch.from_numpy(v) for k, v in params.items()},
                     cap_bytes=cap))


def _pair(jl, tl, **kw):
    """The JAX and the port channel with the same arguments, opened."""
    fail = kw.pop("failures_at", None)
    out = []
    for mod, sim, lay in ((jch, jsim, jl), (tch, tsim, tl)):
        fa = None
        if fail is not None:
            fa = {s: (f if f == "capture" else
                      [sim.FailureSpec(*a) for a in f])
                  for s, f in fail.items()}
        ch = mod.PacketizedChannel(failures_at=fa, **kw)
        ch.open(lay)
        out.append(ch)
    return out


def _send(jc, tc, step, flats=None, grads=None):
    """One step through both channels; the two deliveries."""
    tf = None if flats is None else {b: torch.from_numpy(f.copy())
                                     for b, f in flats.items()}
    tg = None if grads is None else {k: torch.from_numpy(v.copy())
                                     for k, v in grads.items()}
    jc.send(jch.StepEvent(step=step, flats=flats, grads=grads, lr=1e-3,
                          grad_scale=0.5))
    assert tc.send(tch.StepEvent(step=step, flats=tf, grads=tg, lr=1e-3,
                                 grad_scale=0.5)) == 0.0
    assert tc.last_send_parts == {"send": 0.0}
    (jd,), (td,) = jc.poll(), tc.poll()
    return jd, td


def _same(jd, td, jc, tc):
    """Identical deliveries, verdicts, fabric results and wire geometry."""
    assert (td.step, td.lr, td.grad_scale) == (jd.step, jd.lr, jd.grad_scale)
    assert td.complete == jd.complete
    assert td.missing_captures == jd.missing_captures
    assert td.node_complete == jd.node_complete
    assert td.missing_buckets == jd.missing_buckets
    assert td.wire_bytes == jd.wire_bytes
    assert asdict(td.fabric) == asdict(jd.fabric)
    assert (td.flats is None) == (jd.flats is None)
    if td.flats is not None:
        assert set(td.flats) == set(jd.flats)
        for b, t in td.flats.items():
            j = np.asarray(jd.flats[b])
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
            assert t.numpy().tobytes() == j.tobytes(), b
    assert (tc._per, tc._total) == (jc._per, jc._total)
    assert ([(n, s, o) for _, n, s, o in tc._metas]
            == [(n, s, o) for _, n, s, o in jc._metas])
    assert (tc._route_starts, tc._route_owners, tc._bucket_spans) == \
        (jc._route_starts, jc._route_owners, jc._bucket_spans)
    assert asdict(tc.totals) == asdict(jc.totals)


def _flats(layout, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {b.bucket_id: rng.standard_normal(b.size).astype(dtype)
            for b in layout.buckets}


# -- (d) the channel against the JAX channel --------------------------------

@pytest.mark.parametrize("topo,groups,rpg", [
    ("single", 1, 4), ("rail-optimized", 2, 4), ("leaf-spine", 1, 3),
    ("strided", 2, 2)])
def test_unsharded_deliveries_equal_jax(topo, groups, rpg):
    params = _tree(4, seed=1)
    jl, tl = _layouts(params, cap=1024)
    jc, tc = _pair(jl, tl, topology=topo, n_dp_groups=groups,
                   ranks_per_group=rpg, ranks_per_leaf=4)
    for step in (1, 2):
        jd, td = _send(jc, tc, step, flats=_flats(jl, step))
        assert td.complete and td.node_complete is None
        _same(jd, td, jc, tc)


def test_leaf_tree_send_packs_as_jax():
    params = _tree(5, seed=2)
    jl, tl = _layouts(params, cap=2048)
    jc, tc = _pair(jl, tl, n_shadow_nodes=3, replication_factor=2,
                   n_channels=2, fast=True)
    jd, td = _send(jc, tc, 1, grads=_tree(5, seed=3))
    _same(jd, td, jc, tc)
    for b in tl.buckets:                      # the leaves, in bucket order
        for s in b.slots:
            got = td.grads[s.name]
            assert torch.equal(got, torch.from_numpy(_tree(5, 3)[s.name]))


def test_capture_failure_gates_that_step_once():
    params = _tree(3)
    jl, tl = _layouts(params, cap=1024)
    jc, tc = _pair(jl, tl, failures_at={2: "capture"})
    for step in (1, 2, 3):
        jd, td = _send(jc, tc, step, flats=_flats(jl, step))
        _same(jd, td, jc, tc)
        assert td.complete == (step != 2)
    assert td.missing_captures == 0 and tc.totals.gated == 1


def test_link_failure_spec_equals_jax():
    params = _tree(4)
    jl, tl = _layouts(params, cap=512)
    jc, tc = _pair(jl, tl, topology="leaf-spine", n_dp_groups=2,
                   ranks_per_leaf=2, failures_at={1: [(2e-7, "link",
                                                       ("leaf0",
                                                        "spine0"))]})
    jd, td = _send(jc, tc, 1, flats=_flats(jl, 1))
    _same(jd, td, jc, tc)
    assert td.fabric.rerouted > 0


@pytest.mark.parametrize("fast", [False, True])
def test_sharded_kill_and_revive_equal_jax(fast):
    params = _tree(6, seed=4)
    jl, tl = _layouts(params, cap=256)
    jc, tc = _pair(jl, tl, sharded=True, n_shadow_nodes=3, fast=fast)
    owners = tc._owners
    mine = tuple(sorted(b for b, n in owners.items() if n == 1))
    assert mine and set(owners.values()) == {0, 1, 2}
    jd, td = _send(jc, tc, 1, flats=_flats(jl, 1))
    _same(jd, td, jc, tc)
    assert td.complete and all(td.node_complete.values())
    for c in (jc, tc):
        c.kill_shadow_node(1)
    for step in (2, 3):              # deaths persist until revive_all
        jd, td = _send(jc, tc, step, flats=_flats(jl, step))
        _same(jd, td, jc, tc)
        assert not td.complete
        assert td.node_complete == {0: True, 1: False, 2: True}
        assert td.missing_buckets == {0: (), 1: mine, 2: ()}
        assert set(td.flats) == set(owners) - set(mine)
    for c in (jc, tc):
        c.revive_all()
    jd, td = _send(jc, tc, 4, flats=_flats(jl, 4))
    _same(jd, td, jc, tc)
    assert td.complete and set(td.flats) == set(owners)
    with pytest.raises(ValueError, match="out of range"):
        tc.kill_shadow_node(3)


def test_sharded_capture_failure_equals_jax():
    params = _tree(4, seed=5)
    jl, tl = _layouts(params, cap=512)
    jc, tc = _pair(jl, tl, sharded=True, n_shadow_nodes=2,
                   topology="single", failures_at={1: "capture"})
    jd, td = _send(jc, tc, 1, flats=_flats(jl, 1))
    _same(jd, td, jc, tc)
    assert td.flats is None and not any(td.node_complete.values())


@pytest.mark.parametrize("layout_dt,wire_dt", [(np.float16, np.float32),
                                               (np.float32, np.float16)])
def test_wire_dtype_change_equals_jax(layout_dt, wire_dt):
    """A payload of another dtype than the layout's (a compressed
    channel's f32 stand-in over a narrower layout) re-derives the wire
    geometry — and with it the frames — as the JAX channel does."""
    params = _tree(5, seed=6, dtype=layout_dt)
    jl, tl = _layouts(params, cap=300)
    jc, tc = _pair(jl, tl, sharded=True, n_shadow_nodes=2)
    before = tc._total
    jd, td = _send(jc, tc, 1, flats=_flats(jl, 1, wire_dt))
    _same(jd, td, jc, tc)
    assert tc._total != before
    assert all(t.dtype == getattr(torch, np.dtype(wire_dt).name)
               for t in td.flats.values())
    jd, td = _send(jc, tc, 2, flats=_flats(jl, 2, layout_dt))
    _same(jd, td, jc, tc)
    assert tc._total == before


def test_tracing_lays_fabric_spans_in_virtual_time():
    from repro_torch import obs
    params = _tree(3)
    _, tl = _layouts(params, cap=1024)
    tc = tch.PacketizedChannel()
    tc.open(tl)
    with obs.enabled_session(clock=obs.ManualClock(0.0)) as ob:
        for step in (1, 2):
            tc.send(tch.StepEvent(step=step, flats={
                b: torch.from_numpy(f) for b, f in _flats(tl, step).items()}))
        evs = ob.tracer.events()
    names = {e["name"] for e in evs}
    assert {"channel.send", "bucket.pack", "fabric.simulate",
            "allgather step1", "allgather step2"} <= names
    ag = [e for e in evs if e["name"].startswith("allgather")]
    assert all(e["pid"] == 2 for e in ag)
    d = tc.poll()[0].fabric.duration_s
    assert ag[1]["ts"] == round(d * 1e6, 3)    # step 2 starts after step 1
    assert any(e["pid"] == 2 and e["name"].startswith("g0c") for e in evs)


# -- (f) the sharded per-owner gate -----------------------------------------

SHAPES = {"a": (64, 16), "b": (16,), "c": (3, 16, 24), "d": (24, 40)}


def _gate_run(mod_ck, mod_ch, mod_sh, mod_sim, to, state_of, kill_at=None,
              hole_at=None):
    """Drive a Checkmate checkpointer over a sharded 3-owner fabric for 6
    steps; step 5 carries ``state_fn``. ``kill_at``: step before which
    owner 1 dies; ``hole_at``: a step whose fabric cuts owner 0's NIC
    (owner alive)."""
    rng = np.random.default_rng(0)
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()}
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    tree = to(params)
    layout = (j_layout(params, cap_bytes=4096) if to is dict
              else t_layout(tree, cap_bytes=4096))
    kw = {} if to is dict else {"device": "cpu"}
    shadow = mod_sh.ShadowCluster(
        layout, JOpt() if to is dict else OptimizerConfig(), n_nodes=3, **kw)
    shadow.bootstrap(tree, to(zeros), to(zeros), 0)
    fa = ({hole_at: [mod_sim.FailureSpec(0.0, "shadow_nic", "s0")]}
          if hole_at else None)
    chan = mod_ch.PacketizedChannel(sharded=True, n_shadow_nodes=3,
                                    failures_at=fa)
    ck = mod_ck.CheckmateCheckpointer(shadow, channel=chan)
    out = {}
    for step in range(1, 7):
        if step == kill_at:
            shadow.kill_node(1)
            chan.kill_shadow_node(1)
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
        stall = ck.on_step(mod_ch.StepEvent(
            step=step, grads=to(g), lr=1e-3, grad_scale=1.0,
            state_fn=(lambda s=step: state_of(s)) if step == 5 else None))
        out[step] = (stall, shadow.stats().steps_applied,
                     sorted(shadow.dead_nodes), set(chan.dead_shadow_nodes))
        if step == 4 and kill_at:
            with pytest.raises(mod_sh.ShadowNodeLoss) as e:
                shadow.consolidate()
            out["loss"] = (e.value.dead_nodes, e.value.missing_buckets,
                           sorted(e.value.partial["params"]),
                           e.value.partial["step"])
    out["ck"] = (ck.skipped_steps, ck.partial_steps, ck.resyncs,
                 ck.n_checkpoints, ck.skipped_captures)
    out["final"] = shadow.consolidate()
    return out, shadow, layout


def _snap(to):
    def state_of(step):
        rng = np.random.default_rng(100 + step)
        p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in SHAPES.items()}
        return {"params": to(p), "mu": to(p), "nu": to(p), "step": step}
    return state_of


def _torch_tree(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


@pytest.mark.parametrize("case", ["dead-owner", "live-hole"])
def test_sharded_gate_equals_jax(case):
    kw = {"dead-owner": dict(kill_at=3), "live-hole": dict(hole_at=3)}[case]
    j, _, _ = _gate_run(jck, jch, jsh, jsim, dict, _snap(dict), **kw)
    t, shadow, layout = _gate_run(tck, tch, tsh, tsim, _torch_tree,
                                  _snap(_torch_tree), **kw)
    for step in range(1, 7):
        assert t[step][1:] == j[step][1:], step
        if step == 5:                          # the resync
            assert t[step][0] > 0.0
    assert t["ck"] == j["ck"]
    skipped, partial, resyncs, n_ck, n_skip = t["ck"]
    assert resyncs == [5]
    if case == "dead-owner":
        # the survivors replayed steps 3 and 4 (partial), owner 1 is lost
        assert skipped == partial == [3, 4] and n_skip == 2
        dead, missing, leaves, at = t["loss"]
        assert (dead, at) == ([1], 4) and t["loss"] == j["loss"]
        assert missing == {1: tuple(shadow.nodes[1].bucket_ids)}
        assert set(leaves) == {s.name for b in layout.buckets
                               if b.bucket_id not in missing[1]
                               for s in b.slots}
    else:
        # a live owner's hole at 3 freezes everyone at step 2 until 5
        assert skipped == [3, 4] and partial == [] and n_skip == 2
        assert [t[s][1] for s in (2, 3, 4)] == [2, 2, 2]
    assert t["final"]["step"] == 6 and t[6][2:] == ([], set())
    for tree in ("params", "mu", "nu"):
        for k, v in t["final"][tree].items():
            np.testing.assert_allclose(v.numpy(), j["final"][tree][k],
                                       rtol=1e-5, atol=1e-6)


def test_dead_owner_survivors_stay_bitwise_current():
    """With owner 1 dead, owners 0 and 2 keep applying: their leaves equal
    an in-process cluster's bit for bit; the cluster names exactly owner
    1's buckets."""
    rng = np.random.default_rng(3)
    params = _torch_tree({k: (rng.standard_normal(s) * 0.1)
                          .astype(np.float32) for k, s in SHAPES.items()})
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    layout = t_layout(params, cap_bytes=2048)
    ref = ShadowCluster(layout, OptimizerConfig(), n_nodes=3, device="cpu")
    got = ShadowCluster(layout, OptimizerConfig(), n_nodes=3, device="cpu",
                        async_mode=True, max_lag_steps=2)
    for cl in (ref, got):
        cl.bootstrap(params, zeros, zeros, 0)
    chan = tch.PacketizedChannel(sharded=True, n_shadow_nodes=3)
    ck = CheckmateCheckpointer(got, channel=chan)
    inproc = tch.InProcessChannel()
    inproc.open(layout)
    got.kill_node(1)
    chan.kill_shadow_node(1)
    for step in (1, 2, 3):
        g = {k: torch.randn(v.shape) for k, v in params.items()}
        assert ck.on_step(tch.StepEvent(step=step, grads=g, lr=1e-3)) == 0.0
        inproc.send(tch.StepEvent(step=step, grads=g, lr=1e-3))
        ref.on_delivery(inproc.poll()[0])
    assert ck.partial_steps == ck.skipped_steps == [1, 2, 3]
    assert ck.n_checkpoints == 0 and ck.stall_total == 0.0
    with pytest.raises(ShadowNodeLoss) as e:
        got.consolidate(timeout=30)
    assert e.value.missing_buckets == {1: tuple(got.nodes[1].bucket_ids)}
    want = ref.consolidate()
    assert e.value.partial["step"] == 3
    for tree in ("params", "mu", "nu"):
        assert set(e.value.partial[tree]) < set(want[tree])
        for k, v in e.value.partial[tree].items():
            assert torch.equal(v, want[tree][k])
    with pytest.raises(ValueError, match="incomplete for nodes \\[1\\]"):
        chan.send(tch.StepEvent(step=4, grads=g, lr=1e-3))
        got.on_delivery(chan.poll()[0], nodes={0, 1, 2})
    got.shutdown()


# -- (e) training over the fabric --------------------------------------------

def _trees_equal(a: dict, b) -> bool:
    return all(torch.equal(a[t][k], getattr(b, t)[k])
               for t in ("params", "mu", "nu") for k in getattr(b, t))


@pytest.mark.parametrize("shadow_async", [False, True])
def test_packetized_training_checkpoint_is_bitwise(shadow_async):
    cfg = TC.get("tinyllama-1.1b").reduced(microbatches=2)
    ckpts = {}
    for name, chan in (("inprocess", tch.InProcessChannel()),
                       ("packetized", tch.PacketizedChannel(
                           topology="rail-optimized"))):
        state, stats = train(cfg, steps=4, batch=4, seq=32, channel=chan,
                             shadow_async=shadow_async, device="cpu")
        shadow = stats.checkpointer.shadow
        ckpts[name] = shadow.consolidate(timeout=30)
        shadow.shutdown()
        assert ckpts[name]["step"] == 4 and _trees_equal(ckpts[name], state)
        assert stats.checkpointer.n_checkpoints == 4
    assert chan.totals.sends == 4 and chan.totals.gated == 0
    assert chan.totals.fabric_time_s > 0.0
    for tree in ("params", "mu", "nu"):
        for k, v in ckpts["inprocess"][tree].items():
            assert torch.equal(ckpts["packetized"][tree][k], v)


def test_packetized_losses_match_jax_train():
    over = dict(compute_dtype="float32")
    jcfg = C.get("tinyllama-1.1b").reduced(**over)
    rules = ShardingRules(make_smoke_mesh())
    jstate = j_make_state(jax.random.PRNGKey(0), jcfg, rules)
    tstate = state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()},
        {k: np.asarray(v) for k, v in jstate.mu.items()},
        {k: np.asarray(v) for k, v in jstate.nu.items()}, 0, device="cpu")
    _, jstats = jtrain(jcfg, rules, steps=3, batch=4, seq=32, opt=JOpt(),
                       state=jstate, channel=jch.PacketizedChannel())
    tstate, tstats = train(TC.get("tinyllama-1.1b").reduced(**over),
                           steps=3, batch=4, seq=32, opt=OptimizerConfig(),
                           state=tstate, device="cpu",
                           channel=tch.PacketizedChannel())
    np.testing.assert_allclose(tstats.losses, jstats.losses, rtol=1e-4)
    jt = jstats.checkpointer.channel.totals
    tt = tstats.checkpointer.channel.totals
    assert asdict(tt) == asdict(jt)             # same geometry, same fabric
    ckpt = tstats.checkpointer.shadow.consolidate()
    assert ckpt["step"] == 3 and _trees_equal(ckpt, tstate)


def test_rx_buffer_is_released_with_its_delivery():
    """The simulator's hooks close over it and the rx buffer; unless the
    channel unhooks them, a reference cycle keeps every step's rx block
    alive until a full garbage collection (4.4 GB a step at full width)."""
    import gc
    import weakref
    params = _tree(3)
    _, tl = _layouts(params, cap=1024)
    tc = tch.PacketizedChannel()
    tc.open(tl)
    gc.disable()
    try:
        tc.send(tch.StepEvent(step=1, flats={
            b: torch.from_numpy(f) for b, f in _flats(tl, 1).items()}))
        (d,) = tc.poll()
        rx = weakref.ref(next(iter(d.flats.values())).untyped_storage())
        del d
        assert rx() is None
    finally:
        gc.enable()
