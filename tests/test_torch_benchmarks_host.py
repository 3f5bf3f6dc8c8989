"""The port's host-side and shadow-plane benchmarks (`repro_torch.benchmarks`:
savings, multicast_overhead, fabric_sweep, and the ``--json`` modes of
shadow_timing and durability_timing) against the JAX package's modules on
the CPU.

The cost model and the fabric simulator are machine-independent: their
rows equal the reference's string for string, and every fabric row's
`FabricResult` equals the JAX simulator's field for field. The ``--json``
reports are checked by their records (the arctic-480b fleet plan, the
layouts, the delta-to-state ratio, the raw restore bitwise, the stall
stages), never by their timing gates: no test orders wall times.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import benchmarks.durability_timing as jdur
import benchmarks.fabric_sweep as jfab
import benchmarks.multicast_overhead as jmc
import benchmarks.savings as jsav
import benchmarks.shadow_timing as jshadow
import repro.configs as JC
import repro.net.simulator as jsim
from repro.core.buckets import layout_for_tree as j_layout
from repro.core.costmodel import ShadowBudget, shadow_plan_for_config

from repro_torch.benchmarks import durability_timing as tdur
from repro_torch.benchmarks import fabric_sweep as tfab
from repro_torch.benchmarks import multicast_overhead as tmc
from repro_torch.benchmarks import savings as tsav
from repro_torch.benchmarks import shadow_timing as tshadow

torch.set_num_threads(2)   # leave cores to the other test workers


def _rows(capsys) -> list:
    out = capsys.readouterr().out
    return [tuple(line.split(",", 2)) for line in out.splitlines()
            if line and not line.startswith(("#", "name,"))]


def _fmt(rows) -> list:
    """The rows as the CSV prints them."""
    return [(n, f"{us:.1f}", d) for n, us, d in rows]


def test_savings_rows_are_the_references(capsys):
    jsav.run()
    jrows = _rows(capsys)
    rows = _fmt(tsav.run())
    capsys.readouterr()
    assert len(rows) == len(jrows) == 17
    # every row but the last, whose first field is the run's wall time
    assert rows[:-1] == jrows[:-1]
    assert (rows[-1][0], rows[-1][2]) == (jrows[-1][0], jrows[-1][2])


def test_multicast_overhead_sweep_is_the_references(capsys):
    jmc.run()
    jrows = _rows(capsys)
    rows = _fmt(tmc.run(device="cpu"))
    capsys.readouterr()
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    sweep = [r for r in rows if r[0].startswith("fig10.")]
    assert len(sweep) == 6
    assert sweep == [r for r in jrows if r[0].startswith("fig10.")]
    assert ("fig10.busbw_constant", "0.0", "True") in sweep

    def stages(derived):
        return sorted(p.split("=")[0] for p in derived.split())
    for r, j in zip(rows, jrows):
        if r[0].startswith("channel_send."):
            assert stages(r[2]) == stages(j[2]), r[0]
    assert dict((r[0], r[1]) for r in rows)["channel_send.packetized"] == \
        "0.0"
    assert tmc.SEND_STAGES == jmc.SEND_STAGES


def _jax_fabric_results() -> dict:
    """The reference's FabricResult of every fabric_sweep row, from the JAX
    simulator at the JAX module's workloads."""
    out = {f"fabric.fig10.rf{r.replication_factor}": r
           for r in jsim.sweep_replication((1, 2, 4, 8), **jfab.SCALE)}
    work = tfab.WORK
    for name, r in jsim.sweep_topology(("single", "rail", "leaf-spine"),
                                       **work).items():
        out[f"fabric.topology.{name}"] = r
    mid = jsim.simulate_fabric(**work).duration_s / 2
    out["fabric.fail.spine_kill"] = jsim.simulate_fabric(
        **work, failures=[jsim.FailureSpec(mid, "switch", "spine0")])
    out["fabric.fail.shadow_nic"] = jsim.simulate_fabric(
        **work, failures=[jsim.FailureSpec(mid, "shadow_nic", "s0")])
    return out


def test_fabric_sweep_rows_and_results_are_the_references(capsys):
    jfab.run()
    jrows = _rows(capsys)
    results = {}
    rows = _fmt(tfab.run(results=results))
    capsys.readouterr()
    assert tfab.SCALE == jfab.SCALE
    assert rows == jrows
    assert len(rows) == 9
    ref = _jax_fabric_results()
    assert list(results) == list(ref) == [r[0] for r in rows]
    for name, r in results.items():
        assert dataclasses.asdict(r) == dataclasses.asdict(ref[name]), name
    for name in ("fabric.fig10.rf1", "fabric.fig10.rf8"):
        assert results[name].drops == 0


def test_fabric_json_records_each_row(tmp_path, monkeypatch, capsys):
    """The fast-vs-oracle report at a cut of the Fig 10 scale: every row
    identical to the oracle and its events the JAX simulator's (the
    speedup gate is a wall-time ratio and is not checked here)."""
    small = dict(tfab.SCALE, ranks_per_group=32,
                 grad_bytes_per_group=32 * 2048)
    monkeypatch.setattr(tfab, "SCALE", small)
    _, report = tfab.run_json(str(tmp_path / "f.json"), reps=1)
    capsys.readouterr()
    assert json.loads((tmp_path / "f.json").read_text())["rows"] == \
        report["rows"]
    for row in report["rows"]:
        ref = jsim.simulate_fabric(fast=False, **dict(
            small, replication_factor=row["replication_factor"]))
        assert row["identical"] is True
        assert (row["events"], row["tx_over_rx"]) == \
            (ref.events, ref.tx_over_rx)


def test_shadow_json_plans_the_references_fleet(tmp_path, capsys):
    rc, report = tshadow.run_json(str(tmp_path / "s.json"), steps=3,
                                  device="cpu")
    capsys.readouterr()
    assert json.loads((tmp_path / "s.json").read_text())["sharded"] == \
        report["sharded"]
    budget = ShadowBudget()
    plan = shadow_plan_for_config(JC.get("arctic-480b"), budget=budget)
    got = report["sharded"]["plan"]
    assert got == {"n_nodes": plan.n_nodes, "ram_bound": plan.ram_bound,
                   "nic_bound": plan.nic_bound, "n_buckets": plan.n_buckets,
                   "grad_bytes": plan.grad_bytes,
                   "state_bytes": plan.state_bytes,
                   "bytes_per_node_max": plan.bytes_per_node_max,
                   "gbps_per_node_max": plan.gbps_per_node_max,
                   "usable_ram_per_node": budget.usable_ram}
    assert got["n_nodes"] >= 8
    assert report["sharded"]["timing"]["n_nodes"] == plan.n_nodes
    # the leaf tree and its layouts are the reference's
    jtree = jshadow.gpt2_1_5b_leaf_tree()
    ttree = tshadow.gpt2_1_5b_leaf_tree(device="cpu")
    assert list(ttree) == list(jtree)
    for k in jtree:
        assert np.array_equal(ttree[k].numpy(), jtree[k]), k
    layout = j_layout(jtree)
    assert (report["n_buckets"], report["n_leaves"], report["state_bytes"]) \
        == (len(layout.buckets), sum(len(b.slots) for b in layout.buckets),
            layout.total_bytes)
    assert report["sharded"]["timing"]["n_timing_buckets"] == \
        len(j_layout(jtree, cap_bytes=1 << 20).buckets)
    assert report["flat"]["steps"] == report["legacy"]["steps"] == 3
    ov = report["overlapped"]
    assert ov["bounded"]["max_queue_depth"] <= ov["max_lag_steps"]


def test_shadow_run_reports_every_cell(capsys):
    record = []
    rows = tshadow.run("cpu", record=record)
    capsys.readouterr()
    assert [r[0] for r in rows] == [
        f"fig7.{a}-bench.b{b}" for a in tshadow.ARCHS
        for b in tshadow.BATCHES]
    for r in record:
        assert r["checkpoints"] == r["steps_run"] == tshadow.STEPS
        assert r["min_nodes"] >= 1 and r["mean_apply_s"] > 0


def test_durability_json_records_the_references(tmp_path, capsys):
    steps = 4
    jrc = jdur.run_json(str(tmp_path / "j.json"), steps=steps)
    jrep = json.loads((tmp_path / "j.json").read_text())
    rc, rep = tdur.run_json(str(tmp_path / "t.json"), steps=steps,
                            device="cpu")
    capsys.readouterr()
    assert rc == jrc == 0 and rep["fails"] == []
    assert rep["raw"]["restore_bitwise"] is True
    assert (rep["state_bytes"], rep["n_buckets"]) == \
        (jrep["state_bytes"], jrep["n_buckets"])
    # each record's JSON header carries its payload's CRC-32 in decimal,
    # whose width (9 or 10 digits) follows values that differ between the
    # packages by an ulp: a record's size may differ by a byte, an epoch's
    # (two nodes) by two
    assert rep["compressed"]["base_bytes"] == \
        jrep["compressed"]["base_bytes"]
    for got, want in (
            (rep["compressed"]["delta_epoch_bytes_mean"],
             jrep["compressed"]["delta_epoch_bytes_mean"]),
            (rep["raw"]["epoch_bytes_mean"], jrep["raw"]["epoch_bytes_mean"])):
        assert abs(got - want) <= 2
    assert rep["compressed"]["delta_vs_state"] == pytest.approx(
        jrep["compressed"]["delta_vs_state"], abs=2 / rep["state_bytes"])
    assert 0.2 < rep["compressed"]["delta_vs_state"] < 0.3
    for kind in ("raw", "compressed"):
        assert sorted(rep[kind]["stall_stages"]) == \
            sorted(jrep[kind]["stall_stages"])


def test_durability_rows(capsys):
    rows = tdur.run(device="cpu")
    capsys.readouterr()
    assert [r[0] for r in rows] == ["durability.raw", "durability.int8"]
    for _, _, derived in rows:
        assert "stall_stages=['inline-apply', 'send']" in derived


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (tmc.run, tshadow.run, tshadow.run_json, tdur.run,
               tdur.run_json):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
