"""The port's elastic restore: `rebuild_shadow` and
`CheckmateCheckpointer.reconfigure` against the JAX package's, and the
restore onto other sharding rules (`recover(new_rules=)`,
`train(elastic_rules=)`, `mesh_from_plan`) on the one-rank smoke mesh.

Both packages start from the same numpy checkpoint and must derive the same
`BucketLayout` (with and without ``cap_bytes``, or an injected layout), the
same bucket ownership for 2 and 3 nodes, and re-seed the shadow at the
checkpoint's step (inside the port: ``consolidate()`` is the checkpoint bit
for bit). After one more step through the reconfigured checkpointer the
two shadows agree to rtol 1e-5 / atol 1e-6 (the cross-package tolerance
of tests/test_torch_shadow.py). A migrated `DurableShadow` writes the new
base at the resume step with epochs numbered on from the old plane's, the
same manifest on both packages; ``elastic-reshard`` is booked once and
the stall ledger sums to ``stall_total`` bit for bit. A restore onto
FSDP-flipped rules, from the live plane or the tiers, is bitwise the
trainer's state, and the loop's losses are an uninterrupted run's.
"""
import numpy as np
import pytest
import torch

import repro.core.channel as jch
import repro.core.checkpoint as jck
import repro.core.elastic as jel
import repro.core.shadow as jsh
import repro.durability as jdur
from repro.core.buckets import layout_for_tree as j_layout
from repro.optim import OptimizerConfig as JOpt

from repro_torch import obs
from repro_torch.core import channel as tch
from repro_torch.core import checkpoint as tck
from repro_torch.core import elastic as tel
from repro_torch.core import shadow as tsh
from repro_torch import durability as tdur
from repro_torch.core.buckets import layout_for_tree as t_layout
from repro_torch.optim.functional import OptimizerConfig as TOpt

torch.set_num_threads(2)   # leave cores to the other test workers

SHAPES = {"a": (16, 8), "b": (40,), "c": (5, 7, 3), "d": (130,),
          "e": (9, 9)}
RTOL, ATOL = 1e-5, 1e-6


def _np_ckpt(step=3, seed=0):
    rng = np.random.default_rng(seed)

    def tree(f):
        return {k: f(rng.standard_normal(s)).astype(np.float32)
                for k, s in SHAPES.items()}
    return {"params": tree(lambda x: x), "mu": tree(lambda x: 0.1 * x),
            "nu": tree(lambda x: 0.01 * np.abs(x)), "step": step}


def _t(ckpt):
    return {k: ({n: torch.from_numpy(a.copy()) for n, a in v.items()}
                if isinstance(v, dict) else v) for k, v in ckpt.items()}


def _zeros(pkg_tensor: bool):
    z = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    return {k: torch.from_numpy(v) for k, v in z.items()} if pkg_tensor \
        else z


def _layout_key(layout):
    return [(b.bucket_id, b.size,
             [(s.name, s.offset, s.size, str(s.dtype).removeprefix("torch."))
              for s in b.slots]) for b in layout.buckets]


def _old(n_nodes=2, cap=512):
    """The old plane of both packages, seeded with zeros at step 0."""
    j = jsh.ShadowCluster(j_layout(_zeros(False), cap), JOpt(lr=1e-3),
                          n_nodes=n_nodes)
    j.bootstrap(_zeros(False), _zeros(False), _zeros(False), 0)
    t = tsh.ShadowCluster(t_layout(_zeros(True), cap), TOpt(lr=1e-3),
                          n_nodes=n_nodes, device="cpu")
    t.bootstrap(_zeros(True), _zeros(True), _zeros(True), 0)
    return j, t


def _bitwise(a: dict, b: dict):
    assert a["step"] == b["step"]
    for part in ("params", "mu", "nu"):
        assert set(a[part]) == set(b[part])
        for k, x in a[part].items():
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(
                b[part][k])), (part, k)


def _close(port: dict, ref: dict):
    assert port["step"] == ref["step"]
    for part in ("params", "mu", "nu"):
        assert set(port[part]) == set(ref[part])
        for k, x in port[part].items():
            np.testing.assert_allclose(x.numpy(), np.asarray(ref[part][k]),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_nodes", [2, 3])
@pytest.mark.parametrize("cap", [None, 256, 1024])
def test_rebuild_shadow_matches_jax(n_nodes, cap):
    ckpt = _np_ckpt()
    j_old, t_old = _old()
    j = jel.rebuild_shadow(j_old, ckpt, n_nodes=n_nodes, cap_bytes=cap)
    t = tel.rebuild_shadow(t_old, _t(ckpt), n_nodes=n_nodes, cap_bytes=cap,
                           device="cpu")
    assert _layout_key(t.layout) == _layout_key(j.layout)
    assert t.assignment == j.assignment
    assert [n.bucket_ids for n in t.nodes] == [n.bucket_ids for n in j.nodes]
    assert (t.n_nodes, t.async_mode, t.flat) == (n_nodes, False, True)
    got = t.consolidate()
    _bitwise(got, _t(ckpt))            # re-seeded exactly at the step
    _close(got, j.consolidate())


def test_rebuild_keeps_the_old_fleet_async_and_an_injected_layout():
    ckpt = _np_ckpt(step=5)
    t_old = tsh.ShadowCluster(t_layout(_zeros(True), 256), TOpt(),
                              n_nodes=3, async_mode=True, device="cpu")
    t_old.bootstrap(_zeros(True), _zeros(True), _zeros(True), 0)
    layout = t_layout(_zeros(True), 4096)
    t = tel.rebuild_shadow(t_old, _t(ckpt), layout=layout, device="cpu")
    assert t.layout is layout and t.n_nodes == 3 and t.async_mode
    assert not t_old.async_mode          # the old cluster was shut down
    _bitwise(t.consolidate(), _t(ckpt))
    t.shutdown()
    assert tel.ELASTIC_STAGE == jel.ELASTIC_STAGE == "elastic-reshard"
    assert tel.plan_elastic_mesh(6).dp == jel.plan_elastic_mesh(6).dp == 6


def _event(pkg_tensor: bool, step: int):
    rng = np.random.default_rng(100 + step)
    g = {k: (0.01 * rng.standard_normal(s)).astype(np.float32)
         for k, s in SHAPES.items()}
    if pkg_tensor:
        return tch.StepEvent(step=step, lr=1e-3,
                             grads={k: torch.from_numpy(v)
                                    for k, v in g.items()})
    return jch.StepEvent(step=step, lr=1e-3, grads=g)


@pytest.mark.parametrize("new_channel", [True, False])
def test_reconfigure_matches_jax(new_channel):
    ckpt = _np_ckpt(step=3)
    j_old, t_old = _old()
    jc = jck.CheckmateCheckpointer(j_old, channel=jch.InProcessChannel())
    tc = tck.CheckmateCheckpointer(t_old, channel=tch.InProcessChannel())
    for step in (1, 2, 3):
        jc.on_step(_event(False, step))
        tc.on_step(_event(True, step))
    jc._desynced = tc._desynced = True       # reconfigure clears a desync
    tc._dead_desynced = True
    j = jel.rebuild_shadow(j_old, ckpt, n_nodes=3, cap_bytes=256)
    t = tel.rebuild_shadow(t_old, _t(ckpt), n_nodes=3, cap_bytes=256,
                           device="cpu")
    with obs.enabled_session() as ob:
        dt = tc.reconfigure(t, channel=tch.InProcessChannel()
                            if new_channel else None)
        spans = [e for e in ob.tracer.events()
                 if e["name"] == "checkpoint.elastic-reshard"]
    jc.reconfigure(j, channel=jch.InProcessChannel() if new_channel
                   else None)
    assert len(spans) == 1 and spans[0]["args"] == {"n_nodes": 3}
    assert tc.shadow is t and not (tc._desynced or tc._dead_desynced)
    assert tc.stall_stages["elastic-reshard"] == dt > 0.0
    assert list(tc.stall_stages) == list(jc.stall_stages)
    total = 0.0
    for sec in tc.stall_stages.values():
        total += sec
    assert total == tc.stall_total
    # the stream goes on from the re-seeded replica on the new layout
    jc.on_step(_event(False, 4))
    tc.on_step(_event(True, 4))
    assert tc.n_checkpoints == jc.n_checkpoints == 4
    assert list(tc.stall_stages).count("elastic-reshard") == 1
    _close(t.consolidate(), j.consolidate())


def _manifest(tier):
    return sorted((e.epoch, e.node, e.step, e.kind) for e in tier.entries())


def test_durable_shadow_migrates_with_a_base_at_the_resume_step(tmp_path):
    ckpt = _np_ckpt(step=4)
    j_old, t_old = _old()
    jt = jdur.LocalDiskTier(tmp_path / "jax")
    tt = tdur.LocalDiskTier(tmp_path / "port")
    jd = jdur.DurableShadow([jt], jdur.FlushPolicy()).attach(j_old)
    td = tdur.DurableShadow([tt], tdur.FlushPolicy()).attach(t_old)
    # the old plane's base, then two applied steps
    j_old.bootstrap(_zeros(False), _zeros(False), _zeros(False), 0)
    t_old.bootstrap(_zeros(True), _zeros(True), _zeros(True), 0)
    jc = jck.CheckmateCheckpointer(j_old, channel=jch.InProcessChannel())
    tc = tck.CheckmateCheckpointer(t_old, channel=tch.InProcessChannel())
    # drain after each step: a flush worker records the node's step when
    # it snapshots, so an undrained epoch 1 may hold step 2 on one package
    # and step 1 on the other; the test compares the migration, not that
    for step in (1, 2):
        jc.on_step(_event(False, step))
        tc.on_step(_event(True, step))
        jd.drain()
        td.drain()
    before = _manifest(tt)
    j = jel.rebuild_shadow(j_old, ckpt, n_nodes=3, cap_bytes=256)
    t = tel.rebuild_shadow(t_old, _t(ckpt), n_nodes=3, cap_bytes=256,
                           device="cpu")
    assert t.durability is td and t_old.durability is None
    assert td.cluster is t
    td.drain()
    jd.drain()
    after = _manifest(tt)
    assert after == _manifest(jt)
    new = [e for e in after if e not in before]
    assert {(e[1], e[2], e[3]) for e in new} == \
        {(n, 4, "base") for n in range(3)}
    assert min(e[0] for e in new) > max(e[0] for e in before)
    epochs = [e[0] for e in after]
    assert epochs == sorted(epochs)
    assert td.last_complete_step("local-disk") == 4
    restored = tdur.restore_from_tiers([tt], t.layout, n_nodes=3)
    _bitwise(restored, _t(ckpt))
    jd.close()
    td.close()


# -- elastic restore onto new sharding rules ----------------------------------

def _tiny():
    from repro_torch import configs
    return configs.get("tinyllama-1.1b").reduced()


def _state_equal(state, ref, parts=("params", "mu", "nu")):
    for part in parts:
        a, b = getattr(state, part), getattr(ref, part)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)


def test_recover_from_tiers_onto_reconfigured_mesh(tmp_path):
    """Total plane loss + a change of sharding rules in ONE recovery: the
    tiers are read with the OLD capture layout and only the final
    placement follows the new rules — the smoke mesh's FSDP flip (the twin
    of tests/test_elastic.py::test_recover_from_tiers_onto_reconfigured_mesh)."""
    from repro_torch.core.recovery import recover
    from repro_torch.data.synthetic import SyntheticStream, device_batch
    from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
    from repro_torch.train.step import build_train_step, make_train_state

    cfg = _tiny()
    opt = TOpt(lr=1e-3)
    state = make_train_state(cfg, 0, "cpu")
    shadow = tsh.ShadowCluster(t_layout(state.params), opt, n_nodes=2,
                               device="cpu")
    dur = tdur.DurableShadow([tdur.LocalDiskTier(tmp_path)]).attach(shadow)
    shadow.bootstrap(state.params, state.mu, state.nu, 0)
    ck = tck.CheckmateCheckpointer(shadow, channel=tch.InProcessChannel())
    step_fn = build_train_step(cfg, opt, lambda s: 1e-3)
    stream = SyntheticStream(cfg, 4, 16, seed=0)
    try:
        for t in range(3):
            state, m, g = step_fn(state, device_batch(stream.batch_at(t),
                                                      "cpu"))
            ck.on_step(tch.StepEvent(step=t + 1, lr=1e-3, grads=g))
        dur.drain()
        for n in list(shadow.nodes):        # the WHOLE plane dies
            shadow.kill_node(n.node_id)

        rules_b = ShardingRules(make_smoke_mesh("cpu"), fsdp=True)
        state_b, resume = recover(shadow, tiers=dur.tiers, new_rules=rules_b)
        assert resume == 3 and state_b.step == 3
        _state_equal(state_b, state, ("params", "mu"))
        step_b = build_train_step(cfg, opt, lambda s: 1e-3)
        state_b, m2, _ = step_b(state_b, device_batch(stream.batch_at(3),
                                                      "cpu"))
        assert state_b.step == 4 and torch.isfinite(m2["loss"])
    finally:
        shadow.shutdown()


def _rules_over(size, device="cpu"):
    """ShardingRules over a stand-in mesh of ``size`` ranks on ``device``."""
    from repro_torch.dist.sharding import ShardingRules
    return ShardingRules(type("M", (), {
        "size": size, "shape": {"data": size},
        "device": torch.device(device)})())


def test_more_than_one_rank_raises_naming_item_11b(tmp_path):
    """Once a raise naming item 11b, now a run: on two gloo ranks,
    train(rules=) over a (2, 1) mesh with a failure and recover(
    new_rules=) onto it (``tests/_torch_dp_workers.py::two_ranks``: each
    rank's restored state is its trainer's slices bit for bit). Rules on
    another device than the run's still raise."""
    from _torch_spawn import spawn
    from repro_torch.train.loop import train
    spawn("_torch_dp_workers", "two_ranks", 2, tmp_path)
    with pytest.raises(ValueError, match="rules on meta, run on cpu"):
        train(_tiny(), steps=1, batch=2, seq=16, device="cpu",
              rules=_rules_over(1, "meta"))


def _elastic_run(elastic_rules, fail_at, cap=2048):
    """train() at the reduced tinyllama through a CheckmateCheckpointer
    whose plane was bucketed at ``cap`` bytes: an elastic restart re-derives
    the default bucketing, so the capture must follow the new layout."""
    from repro_torch.core.recovery import FailurePlan
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_state
    cfg = _tiny()
    opt = TOpt(lr=1e-3)
    s0 = make_train_state(cfg, 0, "cpu")
    shadow = tsh.ShadowCluster(t_layout(s0.params, cap), opt, n_nodes=2,
                               device="cpu")
    shadow.bootstrap(s0.params, s0.mu, s0.nu, 0)
    ck = tck.CheckmateCheckpointer(shadow, channel=tch.InProcessChannel())
    state, stats = train(cfg, steps=6, batch=4, seq=16, opt=opt,
                         checkpointer=ck, state=s0, device="cpu",
                         failure_plan=FailurePlan(fail_at),
                         elastic_rules=elastic_rules)
    return state, stats, ck, shadow


@pytest.mark.parametrize("how", ["rules", "callable"])
def test_train_elastic_rules_flips_once_and_stays_bitwise(how):
    from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_state
    flipped = ShardingRules(make_smoke_mesh("cpu"), fsdp=True)
    asked = []

    def pick(failed_step):
        asked.append(failed_step)
        return None if failed_step == 3 else flipped

    er, fail_at = ((flipped, (4,)) if how == "rules"
                   else (pick, (3, 5)))
    state, stats, ck, old = _elastic_run(er, fail_at)
    if how == "callable":
        assert asked == [3, 5]          # asked at each failure, until it fires
    assert stats.recoveries == len(fail_at)
    assert stats.recovered_at == [s - 1 for s in fail_at]
    assert list(ck.stall_stages).count("elastic-reshard") == 1
    assert ck.shadow is not old and ck.n_checkpoints == 6
    # the rebuilt plane took the default bucketing, not the old 2 KB one
    assert len(ck.shadow.layout.buckets) < len(old.layout.buckets)
    assert ck.shadow.layout.buckets == t_layout(state.params).buckets
    got = ck.shadow.consolidate()
    assert got["step"] == 6
    for part in ("params", "mu", "nu"):
        for k, v in getattr(state, part).items():
            assert torch.equal(got[part][k], v), (part, k)
    _, ref = train(_tiny(), steps=6, batch=4, seq=16, opt=TOpt(lr=1e-3),
                   state=make_train_state(_tiny(), 0, "cpu"), device="cpu")
    assert stats.losses == ref.losses


def test_mesh_from_plan_needs_the_ranks():
    plan = tel.plan_elastic_mesh(4)
    assert plan.n_ranks == 4
    with pytest.raises(tel.ElasticPlanError,
                       match="plan needs 4 device.s. but only 1 are visible"):
        tel.mesh_from_plan(plan, device="cpu")
    with pytest.raises(tel.ElasticPlanError):
        tel.rules_from_plan(plan, device="cpu")
    one = tel.plan_elastic_mesh(1)
    rules = tel.rules_from_plan(one, device="cpu")
    assert rules.mesh.shape == dict(zip(one.axis_names, one.mesh_shape))
    assert rules.mesh.size == 1 and rules.mesh.device_mesh is None
    assert rules.fsdp == one.fsdp
    assert jel.plan_elastic_mesh(1).mesh_shape == one.mesh_shape
