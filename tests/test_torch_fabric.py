"""The port's fabric (``repro_torch.net``, ``core/tagging.py`` and the switch
control plane of ``core/multicast.py``) against the JAX package's, on the
CPU.

Tolerance 0: the fabric moves bytes and Python floats, and the port keeps
every float operation of the reference in the same order, so each
`FabricResult` — timestamps, latencies, PFC pause accounts and event
counts included — must equal the reference's field for field, on the
per-frame engine and on the calendar-queue one (``fast=True``).
"""
import dataclasses
import io
from contextlib import redirect_stdout

import pytest
import torch

import repro.core.multicast as jmc
import repro.core.tagging as jtag
import repro.net as jnet
import repro.net.simulator as jsim
from repro.core.buckets import build_buckets as j_build

import repro_torch.core.multicast as tmc
import repro_torch.core.tagging as ttag
import repro_torch.net as tnet
import repro_torch.net.simulator as tsim
from repro_torch.core.buckets import build_buckets as t_build
from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.channel import wire_geometry

TOPOLOGIES = ("single", "rail", "leaf-spine")
FAILURE_KINDS = (None, "link", "switch", "shadow_nic")
asdict = dataclasses.asdict


def _failure(sim, kind, topo, at_s):
    """A one-shot `FailureSpec` of package ``sim`` for the topology
    (planner names: single -> sw0; rail/leaf-spine -> leaf{i}/spine{i};
    shadow hosts -> s{i})."""
    if kind is None:
        return ()
    if kind == "shadow_nic":
        target = "s0"
    elif kind == "switch":
        target = "sw0" if topo == "single" else "spine0"
    else:         # cut the shadow access link (single) or a leaf uplink
        target = ("s0", "sw0") if topo == "single" else ("leaf0", "spine0")
    return (sim.FailureSpec(at_s=at_s, kind=kind, target=target),)


def _same(fast, failure=None, pfc=None, **cfg):
    """Run ``cfg`` through both packages' `simulate_fabric` and require
    field-for-field equality; returns the port's result."""
    out = []
    for sim, net in ((jsim, jnet), (tsim, tnet)):
        kw = dict(cfg)
        if failure is not None:
            kw["failures"] = _failure(sim, *failure)
        if pfc is not None:
            kw["pfc"] = net.PfcConfig(**pfc)
        out.append(sim.simulate_fabric(fast=fast, **kw))
    ref, port = out
    assert asdict(port) == asdict(ref)
    return port


# -- (a) the simulator, case by case -----------------------------------------

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("rf", [1, 4])
@pytest.mark.parametrize("kind", FAILURE_KINDS)
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_simulate_fabric_equals_jax(topo, kind, rf, fast):
    r = _same(fast, failure=(kind, topo, 5e-6), n_dp_groups=2,
              ranks_per_group=4, grad_bytes_per_group=4 * 65536,
              topology=topo, n_shadow_nodes=2, replication_factor=rf,
              ranks_per_leaf=4, n_spines=2)
    assert r.ring_completed or kind == "switch"
    if kind is None:
        assert r.reassembled_ok and r.drops == 0


@pytest.mark.parametrize("fast", [False, True])
def test_pfc_heavy_equals_jax(fast):
    """Tiny switch buffers force PAUSE/RESUME storms; the per-link pause
    ledger, durations included, must match to the bit."""
    r = _same(fast, n_dp_groups=2, ranks_per_group=6,
              grad_bytes_per_group=6 * 65536, topology="leaf-spine",
              n_shadow_nodes=2, replication_factor=2, ranks_per_leaf=4,
              n_spines=2, pfc=dict(capacity_bytes=32768, xoff_frac=0.5,
                                   xon_frac=0.3))
    assert r.pfc_pauses > 0 and r.pfc_pause_s > 0.0 and r.link_pfc


@pytest.mark.parametrize("fast", [False, True])
def test_lossy_retransmit_equals_jax(fast):
    """PFC off: drops and retransmissions, with the same retry timing."""
    r = _same(fast, n_dp_groups=1, ranks_per_group=8,
              grad_bytes_per_group=8 * (1 << 18), topology="leaf-spine",
              ranks_per_leaf=2, n_spines=1, spine_gbps=100.0, max_retx=200,
              max_time_s=5.0,
              pfc=dict(enabled=False, capacity_bytes=64 * 1024))
    assert r.drops > 0 and r.retransmits > 0
    assert r.ring_completed and not r.reassembled_ok


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("quantum", [1, 4, 16])
def test_coalesced_frames_equal_jax(quantum, fast):
    _same(fast, n_dp_groups=1, ranks_per_group=4,
          grad_bytes_per_group=4 << 18, topology="single", n_shadow_nodes=2,
          replication_factor=3, frame_quantum=quantum)


@pytest.mark.parametrize("fast", [False, True])
def test_multi_channel_equals_jax(fast):
    _same(fast, n_dp_groups=2, ranks_per_group=6,
          grad_bytes_per_group=6 * 30000, topology="rail", n_channels=3,
          n_shadow_nodes=2, ranks_per_leaf=4)


def test_shadow_rails_and_routes_equal_jax():
    """A sharded route over two shadow rails (the packetized channel's
    ``shadow_route``/``shadow_cuts``), on both engines."""
    results = []
    for sim, net in ((jsim, jnet), (tsim, tnet)):
        topo = net.build_topology(2, 4, 3, topology="rail", ranks_per_leaf=4,
                                  shadow_rails=2)
        for fast in (False, True):
            s = sim.FabricSimulator(
                topo, grad_bytes_per_group=4 * 40000,
                shadow_route=lambda off: (off // 50000) % 3,
                shadow_cuts=(50000, 100000, 150000, 200000, 250000, 300000),
                fast=fast)
            results.append(asdict(s.run()))
    assert results[2:] == results[:2]
    assert results[0] == results[1]


@pytest.mark.parametrize("replication", ["1,2", "4"])
def test_sweeps_and_cli_equal_jax(replication):
    kw = dict(n_dp_groups=2, ranks_per_group=4, grad_bytes_per_group=65536,
              n_shadow_nodes=2, ranks_per_leaf=4)
    factors = [int(x) for x in replication.split(",")]
    assert ([asdict(r) for r in tsim.sweep_replication(factors, **kw)]
            == [asdict(r) for r in jsim.sweep_replication(factors, **kw)])
    t = tsim.sweep_topology(TOPOLOGIES, **kw)
    j = jsim.sweep_topology(TOPOLOGIES, **kw)
    assert {k: asdict(v) for k, v in t.items()} == \
        {k: asdict(v) for k, v in j.items()}
    argv = ["--ranks", "8", "--dp-groups", "2", "--grad-kb", "64",
            "--replication", replication, "--kill", "link:leaf0:spine0@3",
            "--ranks-per-leaf", "4", "--fast"]
    outs = []
    for sim in (jsim, tsim):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert sim.main(argv) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("n_ranks,n_nodes,rf",
                         [(2, 1, 1), (4, 2, 1), (8, 4, 1), (4, 1, 16)])
def test_allgather_wrapper_and_legacy_model_equal_jax(n_ranks, n_nodes, rf):
    for name in ("simulate_allgather_replication",
                 "_legacy_simulate_allgather"):
        args = (n_ranks, n_ranks * 64 * 1024)
        kw = dict(n_shadow_nodes=n_nodes, replication_factor=rf)
        assert (asdict(getattr(tsim, name)(*args, **kw))
                == asdict(getattr(jsim, name)(*args, **kw)))


# -- (b) full width, metadata only -------------------------------------------

def test_full_width_tinyllama_step_equals_jax():
    """One full-width tinyllama-1.1b step of gradients (the wire buffer of
    its 11 f32 buckets) through the packetized channel's default fabric: 1
    group x 4 ranks, 2 shadow nodes, rail-optimized, 100 Gb/s, PFC on. No
    payload hooks; the numbers are the ones a card run prints."""
    from repro_torch import configs
    from repro_torch.models import registry
    specs = registry.param_specs(configs.get("tinyllama-1.1b"))
    layout = layout_for_tree({k: torch.empty(sp.shape, device="meta")
                              for k, sp in sorted(specs.items())})
    _, per, total = wire_geometry(
        layout, tuple(torch.float32 for _ in layout.buckets), 1, 4)
    assert per == total == 4 * 1_100_048_384
    for fast in (False, True):
        r = _same(fast, n_dp_groups=1, ranks_per_group=4,
                  grad_bytes_per_group=per, topology="rail",
                  n_shadow_nodes=2)
        assert r.reassembled_ok and r.events == 18432
        assert round(r.duration_s * 1e3, 2) == 265.05


# -- (c) tagging, the control plane, planner, packets, switch, PFC ---------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16, 64])
def test_tagging_equals_jax(n):
    for rnd in range(max(n - 1, 1)):
        for rank in range(n):
            assert ttag.chunk_at(rank, rnd, n) == jtag.chunk_at(rank, rnd, n)
            assert ttag.is_tagged(rank, rnd, n) == jtag.is_tagged(rank, rnd, n)
    assert ttag.tagged_chunks_per_rank(n) == jtag.tagged_chunks_per_rank(n)
    assert ttag.verify_exactly_once(n) and jtag.verify_exactly_once(n)
    assert ttag.incast_per_round(n) == jtag.incast_per_round(n)
    for ch, nodes in ((1, 1), (3, 2), (2, 4)):
        assert ([asdict(e) for e in ttag.tag_schedule(n, ch, nodes)]
                == [asdict(e) for e in jtag.tag_schedule(n, ch, nodes)])
        t = ttag.fabric_tag_schedule(3, n, ch, nodes)
        j = jtag.fabric_tag_schedule(3, n, ch, nodes)
        assert {g: [asdict(e) for e in v] for g, v in t.items()} == \
            {g: [asdict(e) for e in v] for g, v in j.items()}


def test_figure4_example():
    """Paper Fig 4b: 4 GPUs — rank 0 tags C1 in round 0; rank 3 tags C0,
    C3, C2."""
    assert ttag.tagged_chunks_per_rank(4) == {0: [1], 3: [0, 3, 2]}


@pytest.mark.parametrize("groups,rpg,nodes",
                         [(128, 128, 4), (2, 4, 1), (3, 1, 2), (1, 5, 3)])
def test_switch_control_plane_equals_jax(groups, rpg, nodes):
    t = tmc.SwitchControlPlane(groups, rpg, nodes).setup()
    j = jmc.SwitchControlPlane(groups, rpg, nodes).setup()
    assert [asdict(g) for g in t.groups] == [asdict(g) for g in j.groups]
    assert t.match_table == j.match_table
    assert t.shadow_addr == j.shadow_addr
    assert t.multicast_streams == j.multicast_streams
    assert t.extra_switch_ports() == j.extra_switch_ports()
    for dp in range(min(groups, 3)):
        for r in range(dp * rpg, (dp + 1) * rpg):
            a, b = t.lookup(dp, r), j.lookup(dp, r)
            assert (a is None) == (b is None)
            if a is not None:
                assert asdict(a) == asdict(b)
    assert ([asdict(g) for g in tmc.multicast_groups(groups, rpg, nodes)]
            == [asdict(g) for g in jmc.multicast_groups(groups, rpg, nodes)])


def test_llama3_streams():
    """§4.4: 128 DP groups need 256 multicast streams and ports."""
    cp = tmc.SwitchControlPlane(128, 128, 4).setup()
    assert cp.multicast_streams == cp.extra_switch_ports() == 256


@pytest.mark.parametrize("n_nodes", [1, 2, 3, 5])
def test_node_partitions_equal_jax(n_nodes):
    leaves = [(f"l{i}", (s,), "float32")
              for i, s in enumerate([5000, 300, 70000, 12, 9000, 1 << 18])]
    t = t_build(leaves, cap_bytes=1 << 15)
    j = j_build(leaves, cap_bytes=1 << 15)
    ta, ja = tmc.assign_buckets(t, n_nodes), jmc.assign_buckets(j, n_nodes)
    assert ta == ja
    assert (tmc.node_partitions(t, ta, n_nodes)
            == jmc.node_partitions(j, ja, n_nodes))


@pytest.mark.parametrize("inp,grad,iter_s", [
    (dict(n_accelerators=16384, dp_groups=128, ranks_per_group=128),
     405e9 * 2, 4.58),
    (dict(n_accelerators=64, dp_groups=8, ranks_per_group=8,
          accel_per_host=4, pcie_gbps=1.0), 1e12, 0.1),
    (dict(n_accelerators=8, dp_groups=1, ranks_per_group=8), 4.4e9, 0.0),
])
def test_plan_equals_jax(inp, grad, iter_s):
    t = tnet.plan(tnet.PlanInput(**inp), grad, iter_s)
    j = jnet.plan(jnet.PlanInput(**inp), grad, iter_s)
    assert asdict(t) == asdict(j)


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("rails", [1, 3])
def test_build_topology_equals_jax(topo, rails):
    kw = dict(topology=topo, ranks_per_leaf=4, shadow_rails=rails,
              spine_gbps=None, n_spines=3)
    t = tnet.build_topology(3, 5, 4, **kw)
    j = jnet.build_topology(3, 5, 4, **kw)
    assert asdict(t) == asdict(j)


def test_frames_and_switch_equal_jax():
    kw = dict(chunk=2, channel=1, chunk_bytes=3 * tnet.MTU + 100,
              start_seq=7, tagged=True, shadow_seq0=11, shadow_node=1,
              dp_group=1)
    for quantum in (1, 2):
        tf = tnet.frames_for_chunk(7, 4, quantum=quantum, **kw)
        jf = jnet.frames_for_chunk(7, 4, quantum=quantum, **kw)
        assert [asdict(f) for f in tf] == [asdict(f) for f in jf]
    tsw = tnet.SwitchDataPlane(tmc.SwitchControlPlane(2, 4, 2).setup())
    jsw = jnet.SwitchDataPlane(jmc.SwitchControlPlane(2, 4, 2).setup())
    for f, g in zip(tnet.frames_for_chunk(7, 4, **kw),
                    jnet.frames_for_chunk(7, 4, **kw)):
        assert ([asdict(x) for x in tsw.process(f, replication_factor=3)]
                == [asdict(x) for x in jsw.process(g, replication_factor=3)])
    tsw.process_ack()
    jsw.process_ack()
    assert tsw.counters.as_dict() == jsw.counters.as_dict()
    merged = tsw.counters.merge(tsw.counters)
    assert merged.rx_frames == 2 * tsw.counters.rx_frames


def test_pfc_queue_equals_jax():
    """The lossless queue under pressure, offer by offer."""
    queues = [tnet.PfcQueue(capacity_bytes=1 << 20),
              jnet.PfcQueue(capacity_bytes=1 << 20)]
    for q in queues:
        sent = 0
        while sent < 10 << 20:
            if q.offer(4096):
                sent += 4096
            else:
                q.drain(64 * 1024)
    t, j = (asdict(q) for q in queues)
    assert t == j and t["dropped"] == 0 and t["pause_events"] > 0
    assert tnet.PfcQueue().headroom_ok(256 * 1024)
    assert not tnet.PfcQueue().headroom_ok(1 << 20)
    assert tnet.PfcConfig().xoff == jnet.PfcConfig().xoff
