"""The port's durability plane (``repro_torch.durability`` and
``recover(tiers=...)``) against the JAX package's ``repro.durability``.

Between the packages the records, tier files and manifests are held
byte for byte: the same numpy payload serialises to the same bytes, the
same flats through both workers' ``_build_record`` give the same
compressed records, and each package restores a directory the other
wrote, bitwise. Inside the port a raw-policy restore is bitwise the
shadow's ``consolidate()`` (every optimizer, 1 and 3 nodes, sync and
async, random assignments); a compressed restore stays within atol 1e-2
of it (the JAX bound). The rest mirrors ``tests/test_durability.py``
property for property; the loss messages are compared with the JAX text.
"""
import threading

import numpy as np
import pytest
import torch

import repro.core.channel as jch
import repro.core.shadow as jsh
import repro.durability as jdur
from repro.core.buckets import layout_for_tree as j_layout
from repro.optim import OptimizerConfig as JOpt

from repro_torch.core import channel as tch
from repro_torch.core import shadow as tsh
from repro_torch.core.buckets import layout_for_tree as t_layout
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.recovery import recover
from repro_torch.durability import (DurableShadow, FlushPolicy, FlushRecord,
                                    LocalDiskTier, ManifestEntry,
                                    ObjectStoreTier, Tier, TierPutError,
                                    TierRestoreError, TornRecordError,
                                    restore_from_tiers,
                                    restore_shards_from_tiers)
from repro_torch.optim.functional import OptimizerConfig

torch.set_num_threads(2)   # leave cores to the other test workers

CAP = 600                  # several buckets over _tree's six leaves
OPTS = ("adam", "adamw", "sgd")


def _tree(n_leaves=6, seed=0):
    rng = np.random.default_rng(seed)
    return {f"leaf{k}": rng.standard_normal((6 + 2 * k, 5))
            .astype(np.float32) for k in range(n_leaves)}


def _grads(params, step, seed=0):
    rng = np.random.default_rng(1_000_003 * (seed + 1) + step)
    return {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
            for k, v in params.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _drive(root, *, opt_name="adamw", n_nodes=2, async_mode=False,
           every=1, compress=False, rebase=3, steps=5, seed=0,
           object_store=False, fail_steps=(), assignment=None, retain=None,
           grad_fn=_grads):
    """The port's durable shadow over a synthetic stream; returns
    ``(shadow, dur, tiers, layout, states)`` with ``states`` the per-step
    consolidated checkpoints. The caller owns shutdown."""
    params = _tree(seed=seed)
    layout = t_layout(_t(params), cap_bytes=CAP)
    shadow = tsh.ShadowCluster(layout, OptimizerConfig(name=opt_name,
                                                       lr=1e-3),
                               n_nodes=n_nodes, async_mode=async_mode,
                               assignment=assignment, device="cpu")
    tiers = [LocalDiskTier(root, retain_epochs=retain)]
    if object_store:
        tiers.append(ObjectStoreTier())
    tiers[0].fail_steps.update(fail_steps)
    dur = DurableShadow(tiers, FlushPolicy(
        every_steps=every, compress=compress,
        rebase_every=rebase)).attach(shadow)
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    shadow.bootstrap(_t(params), _t(zeros), _t(zeros), 0)
    chan = tch.InProcessChannel()
    chan.open(layout)
    states = {}
    for step in range(1, steps + 1):
        chan.send(tch.StepEvent(step=step, lr=1e-3,
                                grads=_t(grad_fn(params, step, seed))))
        for d in chan.poll():
            shadow.on_delivery(d)
        dur.drain()
        states[step] = shadow.consolidate(timeout=60)
    return shadow, dur, tiers, layout, states


def _drive_jax(root, *, steps=5, n_nodes=2, compress=False, rebase=3):
    params = _tree()
    layout = j_layout(params, cap_bytes=CAP)
    shadow = jsh.ShadowCluster(layout, JOpt(lr=1e-3), n_nodes=n_nodes)
    tiers = [jdur.LocalDiskTier(root)]
    dur = jdur.DurableShadow(tiers, jdur.FlushPolicy(
        compress=compress, rebase_every=rebase)).attach(shadow)
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    shadow.bootstrap(params, zeros, zeros, 0)
    chan = jch.InProcessChannel()
    chan.open(layout)
    for step in range(1, steps + 1):
        chan.send(jch.StepEvent(step=step, grads=_grads(params, step),
                                lr=1e-3))
        for d in chan.poll():
            shadow.on_delivery(d)
        dur.drain()
    return shadow, dur, tiers, layout


def _bitwise(a, b):
    """Two checkpoints (tensors or numpy leaves) equal bit for bit."""
    assert a["step"] == b["step"]
    for part in ("params", "mu", "nu"):
        assert set(a[part]) == set(b[part]), part
        for k in a[part]:
            x, y = (np.asarray(v) for v in (a[part][k], b[part][k]))
            assert x.dtype == y.dtype and np.array_equal(x, y), (part, k)


def _payload_entries(tier):
    return [e for e in sorted(tier.entries(), key=lambda e: (e.epoch, e.node))
            if e.kind in ("base", "delta")]


# -- the record wire format: JAX bytes ----------------------------------------

def _np_payload(kind):
    rng = np.random.default_rng(7)
    if kind == "mark":
        return {}
    if kind == "compressed":
        return {b: {f: (rng.integers(-127, 128, n).astype(np.int8)
                        if len(f) == 1 else
                        rng.random(3).astype(np.float32))
                    for f in ("m", "ms", "p", "ps", "v", "vs")}
                for b, n in ((1, 40), (4, 9))}
    return {b: {f: rng.standard_normal(n).astype(np.float32)
                for f in ("p", "m", "v")} for b, n in ((0, 40), (2, 9))}


def _records(kind):
    rec_kind = {"raw-delta": "delta", "compressed": "delta"}.get(kind, kind)
    payload = _np_payload(kind)
    args = dict(epoch=3, node=1, step=12, kind=rec_kind,
                compressed=kind == "compressed")
    return (jdur.FlushRecord(payload=payload, **args),
            FlushRecord(payload={b: _t(f) for b, f in payload.items()},
                        **args))


def _record():
    return _records("raw-delta")[1]


@pytest.mark.parametrize("kind", ["base", "raw-delta", "mark", "compressed"])
def test_record_bytes_equal_jax_and_read_back_bitwise(kind):
    jrec, trec = _records(kind)
    raw = jrec.to_bytes()
    assert trec.to_bytes() == raw
    assert trec.payload_nbytes == jrec.payload_nbytes
    out = FlushRecord.from_bytes(raw)
    assert (out.epoch, out.node, out.step, out.kind, out.compressed) == \
        (jrec.epoch, jrec.node, jrec.step, jrec.kind, jrec.compressed)
    assert set(out.payload) == set(jrec.payload)
    for bid, fields in jrec.payload.items():
        assert set(out.payload[bid]) == set(fields)
        for f, a in fields.items():
            got = out.payload[bid][f].numpy()
            assert got.dtype == a.dtype and np.array_equal(got, a)
    back = jdur.FlushRecord.from_bytes(out.to_bytes())
    assert back.to_bytes() == raw


def test_bfloat16_params_round_trip():
    p = torch.randn(33).to(torch.bfloat16)
    rec = FlushRecord(epoch=0, node=0, step=1, kind="base",
                      payload={0: {"p": p, "m": torch.randn(33),
                                   "v": torch.rand(33)}})
    out = FlushRecord.from_bytes(rec.to_bytes())
    assert out.payload[0]["p"].dtype == torch.bfloat16
    assert torch.equal(out.payload[0]["p"], p)


def test_every_truncation_is_torn():
    raw = _record().to_bytes()
    for cut in range(len(raw)):
        with pytest.raises(TornRecordError):
            FlushRecord.from_bytes(raw[:cut])


def test_every_payload_bit_flip_and_trailing_byte_is_torn():
    raw = _record().to_bytes()
    start = len(raw) - _record().payload_nbytes
    for i in range(start, len(raw)):
        bad = bytearray(raw)
        bad[i] ^= 1 << (i % 8)
        with pytest.raises(TornRecordError):
            FlushRecord.from_bytes(bytes(bad))
    with pytest.raises(TornRecordError):
        FlushRecord.from_bytes(raw + b"\0")


def test_mark_record_has_no_payload_bytes():
    rec = FlushRecord(epoch=0, node=0, step=4, kind="mark")
    assert rec.payload_nbytes == 0
    out = FlushRecord.from_bytes(rec.to_bytes())
    assert out.kind == "mark" and out.payload == {}
    with pytest.raises(ValueError):
        FlushRecord(epoch=0, node=0, step=4, kind="snapshot")


# -- tiers ---------------------------------------------------------------------

def test_disk_tier_files_and_manifest_equal_jax(tmp_path):
    """The same records through both packages' LocalDiskTier (with
    retention pruning) leave byte-identical blobs and manifests."""
    jt = jdur.LocalDiskTier(tmp_path / "jax", retain_epochs=2)
    tt = LocalDiskTier(tmp_path / "port", retain_epochs=2)
    rng = np.random.default_rng(3)
    for epoch, kind in enumerate(("base", "delta", "mark", "base", "delta",
                                  "delta")):
        for node in (0, 1):
            payload = {} if kind == "mark" else {
                node: {f: rng.standard_normal(17 + node).astype(np.float32)
                       for f in ("p", "m", "v")}}
            args = dict(epoch=epoch, node=node, step=2 * epoch, kind=kind)
            je = jt.put(jdur.FlushRecord(payload=payload, **args))
            te = tt.put(FlushRecord(payload={b: _t(f) for b, f
                                             in payload.items()}, **args))
            assert vars(je) == vars(te)
    jfiles = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert jfiles == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(jfiles) > 2 and tt.gc_records_total == jt.gc_records_total > 0
    for name in jfiles:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    assert tt.disk_bytes() == jt.disk_bytes()


def test_local_disk_tier_put_read_manifest(tmp_path):
    tier = LocalDiskTier(tmp_path)
    rec = _record()
    entry = tier.put(rec)
    assert isinstance(entry, ManifestEntry)
    assert tier.entries() == [entry]
    assert entry.nbytes == len(rec.to_bytes())
    assert tier.read(entry).step == rec.step
    assert isinstance(tier, Tier)
    assert isinstance(ObjectStoreTier(), Tier)


def test_tier_injected_failure(tmp_path):
    tier = LocalDiskTier(tmp_path)
    tier.fail_steps.add(12)
    with pytest.raises(TierPutError):
        tier.put(_record())
    assert tier.entries() == []


def test_concurrent_puts_never_drop_manifest_entries(tmp_path):
    tier = LocalDiskTier(tmp_path)
    n_threads, n_each = 4, 12

    def work(node):
        for i in range(n_each):
            tier.put(FlushRecord(epoch=i, node=node, step=i, kind="mark"))

    ts = [threading.Thread(target=work, args=(n,)) for n in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(tier.entries()) == n_threads * n_each


def test_torn_blob_on_disk_is_rejected(tmp_path):
    tier = LocalDiskTier(tmp_path)
    entry = tier.put(_record())
    path = tmp_path / entry.key
    raw = path.read_bytes()
    path.write_bytes(raw[:len(raw) // 2])
    with pytest.raises(TornRecordError):
        tier.read(entry)
    path.unlink()
    with pytest.raises(TornRecordError):
        tier.read(entry)


# -- between the packages: _build_record and each other's directories ----------

def test_build_record_bytes_equal_jax():
    """Base then three compressed deltas of the same flats through both
    workers' ``_build_record``: byte-identical records (the codec, the
    reconstruction buffer's arithmetic and the serialisation)."""
    params = _tree()
    jl = j_layout(params, cap_bytes=CAP)
    tl = t_layout(_t(params), cap_bytes=CAP)
    jcl = jsh.ShadowCluster(jl, JOpt(), n_nodes=2)
    tcl = tsh.ShadowCluster(tl, OptimizerConfig(), n_nodes=2, device="cpu")
    pol = dict(compress=True, rebase_every=8)
    jd = jdur.DurableShadow([], jdur.FlushPolicy(**pol)).attach(jcl)
    td = DurableShadow([], FlushPolicy(**pol)).attach(tcl)
    try:
        jw, tw = jd.workers[0], td.workers[0]
        rng = np.random.default_rng(5)
        snap = {bid: tuple(rng.standard_normal(jl.buckets[bid].size)
                           .astype(np.float32) for _ in range(3))
                for bid in jcl.nodes[0].bucket_ids}
        assert len(snap) > 1
        for epoch in range(4):
            if epoch:
                snap = {bid: tuple(a + (rng.standard_normal(a.shape) *
                                        10.0 ** -epoch).astype(np.float32)
                                   for a in fields)
                        for bid, fields in snap.items()}
                snap[min(snap)][1][::7] = 1e-40      # subnormal diffs too
            jr = jw._build_record(epoch, 10 + epoch, snap, epoch == 0)
            tr = tw._build_record(epoch, 10 + epoch, {
                bid: tuple(torch.from_numpy(a.copy()) for a in fields)
                for bid, fields in snap.items()}, epoch == 0)
            assert tr.compressed == jr.compressed == (epoch > 0)
            assert tr.to_bytes() == jr.to_bytes(), epoch
    finally:
        jcl.shutdown()
        tcl.shutdown()


@pytest.mark.parametrize("compress", [False, True])
def test_jax_restores_a_directory_the_port_wrote(tmp_path, compress):
    shadow, dur, tiers, layout, states = _drive(tmp_path, compress=compress,
                                                steps=4)
    shadow.shutdown()
    got = jdur.restore_from_tiers([jdur.LocalDiskTier(tmp_path)],
                                  j_layout(_tree(), cap_bytes=CAP),
                                  n_nodes=2)
    mine = restore_from_tiers(tiers, layout, n_nodes=2)
    _bitwise(got, mine)
    if not compress:
        _bitwise(got, states[4])


@pytest.mark.parametrize("compress", [False, True])
def test_port_restores_a_directory_jax_wrote(tmp_path, compress):
    jshadow, _, jtiers, jl = _drive_jax(tmp_path, steps=4,
                                        compress=compress)
    want = jdur.restore_from_tiers(jtiers, jl, n_nodes=2)
    if not compress:
        _bitwise(want, jshadow.consolidate(timeout=60))
    jshadow.shutdown()
    got = restore_from_tiers([LocalDiskTier(tmp_path)],
                             t_layout(_t(_tree()), cap_bytes=CAP), n_nodes=2)
    _bitwise(got, want)
    p, m, v = restore_shards_from_tiers([LocalDiskTier(tmp_path)],
                                        t_layout(_t(_tree()), cap_bytes=CAP),
                                        [1], at_step=4)
    jp, jm, jv = jdur.restore_shards_from_tiers(jtiers, jl, [1], at_step=4)
    for a, b in ((p, jp), (m, jm), (v, jv)):
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k].numpy(), b[k])


# -- flush + restore bit-identity ----------------------------------------------

@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("n_nodes", [1, 3])
@pytest.mark.parametrize("opt_name", OPTS)
def test_restore_bit_identical_to_consolidate(tmp_path, opt_name, n_nodes,
                                              async_mode):
    params = _tree()
    layout = t_layout(_t(params), cap_bytes=CAP)
    seed = OPTS.index(opt_name) * 4 + n_nodes + int(async_mode)
    rng = np.random.default_rng(seed)
    assignment = {b.bucket_id: int(rng.integers(0, n_nodes))
                  for b in layout.buckets}
    shadow, dur, tiers, layout, states = _drive(
        tmp_path, opt_name=opt_name, n_nodes=n_nodes, async_mode=async_mode,
        assignment=assignment, steps=4)
    try:
        assert shadow.assignment == assignment
        assert dur.last_complete_step("local-disk") == 4
        assert not dur.errors
        ckpt = restore_from_tiers(tiers, layout, n_nodes=n_nodes)
        _bitwise(ckpt, states[4])
    finally:
        shadow.shutdown()


def test_flush_cadence_bounds_tier_lag(tmp_path):
    from repro_torch import obs
    with obs.enabled_session() as ob:
        shadow, dur, tiers, layout, states = _drive(tmp_path, every=2,
                                                    steps=5)
    try:
        assert dur.last_complete_step("local-disk") == 4
        assert dur.newest_durable() == ("local-disk", 4)
        _bitwise(restore_from_tiers(tiers, layout, n_nodes=2), states[4])
        m = ob.metrics
        assert m.gauge("durability_tier_lag_steps").value(
            tier="local-disk") == 0
        assert m.counter("durability_flush_bytes").value(
            tier="local-disk") == sum(e.nbytes for e in tiers[0].entries())
        names = {e["name"] for e in ob.tracer.events()}
        assert {"durability.flush", "durability.snapshot",
                "durability.put"} <= names
    finally:
        shadow.shutdown()


def test_tier_failure_falls_back_to_other_tier(tmp_path):
    shadow, dur, tiers, layout, states = _drive(
        tmp_path, object_store=True, fail_steps=(5,), steps=5)
    try:
        assert dur.put_failures > 0
        assert dur.last_complete_step("local-disk") == 4
        assert dur.last_complete_step("object-store") == 5
        assert dur.newest_durable() == ("object-store", 5)
        _bitwise(restore_from_tiers(tiers, layout, n_nodes=2), states[5])
    finally:
        shadow.shutdown()


def test_restore_raises_when_no_tier_serves(tmp_path):
    layout = t_layout(_t(_tree()), cap_bytes=CAP)
    with pytest.raises(TierRestoreError):
        restore_from_tiers([LocalDiskTier(tmp_path)], layout)


def test_compressed_deltas_shrink_and_stay_close(tmp_path):
    shadow, dur, tiers, layout, states = _drive(
        tmp_path, compress=True, rebase=10, steps=4)
    try:
        ents = tiers[0].entries()
        base_total = sum(e.nbytes for e in ents if e.kind == "base")
        epochs = {e.epoch for e in ents if e.kind == "delta"}
        assert epochs
        for ep in epochs:
            delta_total = sum(e.nbytes for e in ents
                              if e.kind == "delta" and e.epoch == ep)
            assert 0 < delta_total < base_total
        ckpt = restore_from_tiers(tiers, layout, n_nodes=2)
        assert ckpt["step"] == 4
        for k, v in ckpt["params"].items():
            assert torch.allclose(v, states[4]["params"][k], rtol=0,
                                  atol=1e-2), k
    finally:
        shadow.shutdown()


@pytest.mark.parametrize("cut_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("async_mode", [False, True])
def test_crash_mid_flush_falls_back_bit_identical(tmp_path, async_mode,
                                                  cut_seed):
    """Cut the newest on-disk record at a random byte: restore falls back
    to the previous epoch, bitwise the shadow at that step."""
    opt_name = OPTS[cut_seed % 3]
    shadow, dur, tiers, layout, states = _drive(
        tmp_path, opt_name=opt_name, async_mode=async_mode, steps=4,
        rebase=100)
    try:
        tier = tiers[0]
        newest = _payload_entries(tier)[-1]
        assert newest.kind == "delta" and newest.step == 4
        path = tier.root / newest.key
        raw = path.read_bytes()
        cut = int(np.random.default_rng(cut_seed).integers(0, len(raw)))
        path.write_bytes(raw[:cut])
        _bitwise(restore_from_tiers(tiers, layout, n_nodes=2), states[3])
    finally:
        shadow.shutdown()


def test_flushing_never_perturbs_channel_error_feedback(tmp_path):
    def run(flush: bool, root):
        params = _tree()
        layout = t_layout(_t(params), cap_bytes=CAP)
        shadow = tsh.ShadowCluster(layout, OptimizerConfig(lr=1e-3),
                                   n_nodes=2, device="cpu")
        if flush:
            DurableShadow([LocalDiskTier(root)],
                          FlushPolicy(compress=True,
                                      rebase_every=3)).attach(shadow)
        zeros = _t({k: np.zeros_like(v) for k, v in params.items()})
        shadow.bootstrap(_t(params), zeros, zeros, 0)
        chan = tch.CompressedChannel(tch.InProcessChannel())
        chan.open(layout)
        for step in range(1, 5):
            chan.send(tch.StepEvent(step=step, lr=1e-3,
                                    grads=_t(_grads(params, step))))
            for d in chan.poll():
                shadow.on_delivery(d)
        if flush:
            shadow.durability.drain()
        ckpt = shadow.consolidate(timeout=60)
        ef = {k: v.clone() for k, v in chan.compressor.ef.items()}
        chan.close()
        shadow.shutdown()
        return ckpt, ef

    ck_a, ef_a = run(False, tmp_path / "a")
    ck_b, ef_b = run(True, tmp_path / "b")
    assert set(ef_a) == set(ef_b)
    for k in ef_a:
        assert torch.equal(ef_a[k], ef_b[k]), k
    _bitwise(ck_a, ck_b)


# -- the loss messages, the JAX text ------------------------------------------

def _loss(cluster, kill):
    for n in kill:
        cluster.kill_node(n)
    with pytest.raises((jsh.ShadowNodeLoss, tsh.ShadowNodeLoss)) as ei:
        cluster.consolidate(timeout=60)
    return ei.value


@pytest.mark.parametrize("kill", [(0,), (0, 1)])
def test_loss_messages_and_hints_equal_jax(tmp_path, kill):
    shadow, dur, tiers, layout, states = _drive(tmp_path / "port", steps=3)
    jshadow, jd, jtiers, jl = _drive_jax(tmp_path / "jax", steps=3)
    try:
        e, je = _loss(shadow, kill), _loss(jshadow, kill)
        assert str(e) == str(je)
        assert (e.total, e.durable_hint, e.dead_nodes, e.missing_buckets) \
            == (je.total, je.durable_hint, je.dead_nodes, je.missing_buckets)
        assert e.durable_hint == ("local-disk", 3)
        assert e.total == (len(kill) == 2)
    finally:
        shadow.shutdown()
        jshadow.shutdown()


def test_total_loss_without_tiers_message_equals_jax():
    params = _tree()
    jl = j_layout(params, cap_bytes=CAP)
    jcl = jsh.ShadowCluster(jl, JOpt(lr=1e-3), n_nodes=2)
    tcl = tsh.ShadowCluster(t_layout(_t(params), cap_bytes=CAP),
                            OptimizerConfig(lr=1e-3), n_nodes=2,
                            device="cpu")
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    jcl.bootstrap(params, zeros, zeros, 0)
    tcl.bootstrap(_t(params), _t(zeros), _t(zeros), 0)
    e, je = _loss(tcl, (0, 1)), _loss(jcl, (0, 1))
    assert e.total and e.durable_hint is None
    assert "unrecoverable" in str(e) and str(e) == str(je)


def test_partial_loss_restores_the_missing_shards(tmp_path):
    shadow, dur, tiers, layout, states = _drive(tmp_path, steps=3)
    try:
        e = _loss(shadow, (0,))
        p, m, v = restore_shards_from_tiers(
            tiers, layout, e.dead_nodes, at_step=int(e.partial["step"]))
        assert set(e.partial["params"]) | set(p) == set(states[3]["params"])
        for k in p:
            assert torch.equal(p[k], states[3]["params"][k])
            assert torch.equal(m[k], states[3]["mu"][k])
            assert torch.equal(v[k], states[3]["nu"][k])
        with pytest.raises(TierRestoreError):
            restore_shards_from_tiers(tiers, layout, [0], at_step=7)
    finally:
        shadow.shutdown()


# -- recover(tiers=...) --------------------------------------------------------

def _state_equal(state, ckpt):
    assert state.step == ckpt["step"]
    for part in ("params", "mu", "nu"):
        got = getattr(state, part)
        assert set(got) == set(ckpt[part])
        for k, t in got.items():
            assert torch.equal(t, ckpt[part][k]), (part, k)


@pytest.mark.parametrize("async_mode", [False, True])
def test_recover_from_partial_then_total_loss(tmp_path, async_mode):
    shadow, dur, tiers, layout, states = _drive(
        tmp_path, async_mode=async_mode, every=2, steps=4)
    try:
        shadow.kill_node(1)
        state, step = recover(shadow, device="cpu", tiers=tiers)
        assert step == 4
        _state_equal(state, states[4])
        shadow.kill_node(0)
        with pytest.raises(tsh.ShadowNodeLoss):
            recover(shadow, device="cpu")
        state, step = recover(shadow, device="cpu", tiers=tiers)
        _state_equal(state, states[4])
    finally:
        shadow.shutdown()


def test_recover_partial_only_where_tiers_cannot_serve(tmp_path):
    shadow, dur, tiers, layout, states = _drive(tmp_path, every=2, steps=3)
    try:
        shadow.kill_node(1)      # survivors at step 3, tiers hold only 2
        with pytest.raises(tsh.ShadowNodeLoss):
            recover(shadow, device="cpu", tiers=tiers)
        state, step = recover(shadow, device="cpu", tiers=tiers,
                              allow_partial=True)
        survivors = {s.name for b in layout.buckets
                     if b.bucket_id in shadow.nodes[0].bucket_ids
                     for s in b.slots}
        assert step == 3 and set(state.params) == survivors
    finally:
        shadow.shutdown()


def test_checkmate_checkpointer_attaches_drains_and_books_no_flush(tmp_path):
    """Training through a CheckmateCheckpointer(durability=...): every step
    durable after finalize, the stall ledger holds no flush stage, and a
    total loss recovers bitwise the trainer's state."""
    from repro_torch import configs
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_state
    cfg = configs.get("tinyllama-1.1b").reduced()
    state0 = make_train_state(cfg, seed=0, device="cpu")
    layout = t_layout(state0.params)
    shadow = tsh.ShadowCluster(layout, OptimizerConfig(), n_nodes=2,
                               async_mode=True, max_lag_steps=2,
                               device="cpu")
    shadow.bootstrap(state0.params, state0.mu, state0.nu, 0)
    tier = LocalDiskTier(tmp_path, retain_epochs=1)
    dur = DurableShadow([tier], FlushPolicy(every_steps=2, rebase_every=2))
    ck = CheckmateCheckpointer(shadow, durability=dur)
    assert shadow.durability is dur and len(dur.workers) == 2
    state, stats = train(cfg, steps=4, batch=2, seq=16, checkpointer=ck,
                         state=state0, device="cpu")
    assert dur.last_complete_step("local-disk") == 4 and not dur.workers
    assert not any(w in stage for stage in ck.stall_stages
                   for w in ("flush", "durability", "tier"))
    for n in (1, 0):
        shadow.kill_node(n)
    got, step = recover(shadow, device="cpu", tiers=[tier])
    assert step == 4
    _state_equal(got, {"params": state.params, "mu": state.mu,
                       "nu": state.nu, "step": 4})
    shadow.shutdown()


def test_snapshot_buffer_is_exact_and_snapshot_drains_dirty(tmp_path):
    shadow, dur, tiers, layout, states = _drive(tmp_path, steps=1)
    try:
        for node in shadow.nodes:
            host = dur.workers[node.node_id].host
            need = sum(layout.buckets[b].size * 12 for b in node.bucket_ids)
            assert need <= host.nbytes < need + 64 * 3 * len(node.bucket_ids)
            assert not node.dirty                  # drained by the flush
        node = shadow.nodes[0]
        snap, step = node.snapshot_dirty()
        assert snap == {} and step == 1
        snap, step = node.snapshot_dirty(force_all=True)
        assert sorted(snap) == node.bucket_ids
        for bid, (p, m, v) in snap.items():
            assert torch.equal(p, node._pf[bid]) and p.data_ptr() != \
                node._pf[bid].data_ptr()
        with pytest.raises(ValueError):
            DurableShadow([]).attach(tsh.ShadowCluster(
                layout, OptimizerConfig(), device="cpu", flat=False))
    finally:
        shadow.shutdown()


def test_a_failing_flush_is_recorded_and_the_worker_goes_on(tmp_path,
                                                            monkeypatch):
    shadow, dur, tiers, layout, states = _drive(tmp_path, steps=1)
    try:
        real = LocalDiskTier.put

        def boom(self, rec):
            if rec.step == 2:
                raise OSError("disk gone")
            return real(self, rec)
        monkeypatch.setattr(LocalDiskTier, "put", boom)
        chan = tch.InProcessChannel()
        chan.open(layout)
        for step in (2, 3):
            chan.send(tch.StepEvent(step=step, lr=1e-3, grads=_t(
                _grads(_tree(), step))))
            for d in chan.poll():
                shadow.on_delivery(d)
            dur.drain()
        assert {(n, ep) for n, ep, _ in dur.errors} == {(0, 2), (1, 2)}
        assert dur.last_complete_step("local-disk") == 3
    finally:
        shadow.shutdown()


# -- retention GC + object-store retry ------------------------------------------

def test_retention_gc_bounds_disk_over_epochs(tmp_path):
    params = _tree()
    layout = t_layout(_t(params), cap_bytes=CAP)
    shadow = tsh.ShadowCluster(layout, OptimizerConfig(lr=1e-3), n_nodes=2,
                               device="cpu")
    tier = LocalDiskTier(tmp_path, retain_epochs=4)
    dur = DurableShadow([tier], FlushPolicy(rebase_every=4)).attach(shadow)
    zeros = _t({k: np.zeros_like(v) for k, v in params.items()})
    shadow.bootstrap(_t(params), zeros, zeros, 0)
    chan = tch.InProcessChannel()
    chan.open(layout)
    try:
        for step in range(1, 21):
            chan.send(tch.StepEvent(step=step, lr=1e-3,
                                    grads=_t(_grads(params, step))))
            for d in chan.poll():
                shadow.on_delivery(d)
            dur.drain()
        ents = tier.entries()
        epochs = sorted({e.epoch for e in ents})
        assert dur.epochs_started == 21
        assert len(epochs) <= 4 + 4
        assert all(e.kind == "base" for e in ents if e.epoch == epochs[0])
        assert tier.gc_records_total > 0
        on_disk = {p.name for p in tmp_path.glob("rec_*.bin")}
        assert on_disk == {e.key for e in ents}
        assert tier.disk_bytes() == sum(e.nbytes for e in ents)
        _bitwise(restore_from_tiers([tier], layout, n_nodes=2),
                 shadow.consolidate(timeout=60))
    finally:
        chan.close()
        shadow.shutdown()


def test_retention_never_cuts_newest_chain():
    tier = ObjectStoreTier(retain_epochs=2)

    def rec(epoch, kind):
        payload = {}
        if kind != "mark":
            payload = {0: {f: torch.randn(8) for f in ("p", "m", "v")}}
        return FlushRecord(epoch=epoch, node=0, step=epoch, kind=kind,
                           compressed=False, payload=payload)

    for epoch, kind in enumerate(("base", "delta", "delta", "delta")):
        tier.put(rec(epoch, kind))
    assert sorted({e.epoch for e in tier.entries()}) == [0, 1, 2, 3]
    assert tier.gc_records_total == 0
    tier.put(rec(4, "base"))
    tier.put(rec(5, "delta"))
    assert sorted({e.epoch for e in tier.entries()}) == [4, 5]
    assert tier.gc_records_total == 4


def test_object_store_put_retries_transient_failures():
    tier = ObjectStoreTier(retry_attempts=3, retry_backoff_s=0.001)
    tier.transient_fail_steps[12] = 2
    entry = tier.put(_record())
    assert tier.retries_total == 2
    assert tier.entries() == [entry]
    assert tier.read(entry).step == 12


def test_retry_in_flush_plane_and_clean_give_up(tmp_path):
    params = _tree()
    layout = t_layout(_t(params), cap_bytes=CAP)
    shadow = tsh.ShadowCluster(layout, OptimizerConfig(lr=1e-3), n_nodes=2,
                               device="cpu")
    ost = ObjectStoreTier(retry_attempts=2)
    ost.transient_fail_steps[1] = 1
    ost.transient_fail_steps[2] = 5
    tiers = [LocalDiskTier(tmp_path), ost]
    dur = DurableShadow(tiers).attach(shadow)
    zeros = _t({k: np.zeros_like(v) for k, v in params.items()})
    shadow.bootstrap(_t(params), zeros, zeros, 0)
    chan = tch.InProcessChannel()
    chan.open(layout)
    try:
        for step in (1, 2, 3):
            chan.send(tch.StepEvent(step=step, lr=1e-3,
                                    grads=_t(_grads(params, step))))
            for d in chan.poll():
                shadow.on_delivery(d)
            dur.drain()
        assert {e.step for e in ost.entries()} == {0, 1, 3}
        assert dur.put_failures == 2
        assert ost.retries_total >= 2
        assert dur.last_complete_step("local-disk") == 3
        assert dur.last_complete_step("object-store") == 3
        assert dur.newest_durable() == ("local-disk", 3)
        assert restore_from_tiers(tiers, layout, n_nodes=2)["step"] == 3
    finally:
        chan.close()
        shadow.shutdown()

