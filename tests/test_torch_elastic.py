"""The port's mesh-free elastic restore against the JAX package's:
`rebuild_shadow` and `CheckmateCheckpointer.reconfigure`.

Both packages start from the same numpy checkpoint and must derive the same
`BucketLayout` (with and without ``cap_bytes``, or an injected layout), the
same bucket ownership for 2 and 3 nodes, and re-seed the shadow at the
checkpoint's step (inside the port: ``consolidate()`` is the checkpoint bit
for bit). After one more step through the reconfigured checkpointer the
two shadows agree to rtol 1e-5 / atol 1e-6 (the cross-package tolerance
of tests/test_torch_shadow.py). A migrated `DurableShadow` writes the new
base at the resume step with epochs numbered on from the old plane's, the
same manifest on both packages; ``elastic-reshard`` is booked once and
the stall ledger sums to ``stall_total`` bit for bit.
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
