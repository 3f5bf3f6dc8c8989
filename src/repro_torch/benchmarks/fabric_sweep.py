"""Fabric-level sweeps on the event-driven simulator, the port of
``benchmarks/fabric_sweep.py``:

* Fig 10 at scale — replication factor vs TX/RX ratio and bus bandwidth at
  512 ranks across 2 DP groups on the rail fabric,
* topology comparison — rail-optimized vs strided leaf/spine vs the
  single-switch idealization for the same workload,
* failure drills — spine kill (reroute) and shadow-NIC kill (capture loss)
  mid-iteration.

Host-only and machine-independent: every row's `FabricResult` equals the
JAX simulator's. ``--json`` times the calendar-queue fast path
(`simulate_fabric(fast=True)`) against the per-frame oracle on the Fig 10
512-rank sweep and writes ``build/BENCH_fabric.json``: min-of-N wall clock
per replication factor and a full `FabricResult` equality check per row;
it exits nonzero if the aggregate speedup is below 3x or any row's
results diverge.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from repro_torch.benchmarks.common import csv_row, out_path
from repro_torch.net.simulator import (FailureSpec, simulate_fabric,
                                       sweep_replication, sweep_topology)

SCALE = dict(n_dp_groups=2, ranks_per_group=256,
             grad_bytes_per_group=256 * 2048, topology="rail",
             n_shadow_nodes=2, ranks_per_leaf=32)
# the topology comparison and failure drills' workload
WORK = dict(n_dp_groups=2, ranks_per_group=64,
            grad_bytes_per_group=64 * 16384, n_shadow_nodes=2,
            ranks_per_leaf=16)


def run(results: dict | None = None) -> list[tuple]:
    """The CSV rows; ``results``, if given, receives each row's
    `FabricResult` under the row's name."""
    rows, out = [], {} if results is None else results
    for r in sweep_replication((1, 2, 4, 8), **SCALE):
        name = f"fabric.fig10.rf{r.replication_factor}"
        out[name] = r
        rows.append(csv_row(name, r.duration_s * 1e6,
                            f"tx_over_rx={r.tx_over_rx:.4f} "
                            f"busbw={r.bus_bandwidth_gbps:.1f}Gbps "
                            f"ok={r.reassembled_ok} drops={r.drops} "
                            f"events={r.events}"))

    for name, r in sweep_topology(("single", "rail", "leaf-spine"),
                                  **WORK).items():
        out[f"fabric.topology.{name}"] = r
        rows.append(csv_row(f"fabric.topology.{name}", r.duration_s * 1e6,
                            f"busbw={r.bus_bandwidth_gbps:.1f}Gbps "
                            f"pauses={r.pfc_pauses} ok={r.reassembled_ok}"))

    base = simulate_fabric(**WORK)
    mid = base.duration_s / 2
    spine = simulate_fabric(**WORK,
                            failures=[FailureSpec(mid, "switch", "spine0")])
    out["fabric.fail.spine_kill"] = spine
    rows.append(csv_row("fabric.fail.spine_kill", spine.duration_s * 1e6,
                        f"rerouted={spine.rerouted} "
                        f"retx={spine.retransmits} "
                        f"ok={spine.reassembled_ok}"))
    snic = simulate_fabric(**WORK,
                           failures=[FailureSpec(mid, "shadow_nic", "s0")])
    out["fabric.fail.shadow_nic"] = snic
    rows.append(csv_row("fabric.fail.shadow_nic", snic.duration_s * 1e6,
                        f"missing={snic.missing_captures} "
                        f"ring_ok={snic.ring_completed} "
                        f"ok={snic.reassembled_ok}"))
    return rows


def _min_time(fn, reps: int):
    """(best wall-clock seconds, last result) over ``reps`` runs."""
    best, result = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        result = fn()
        best = min(best, time.perf_counter() - t0)
    return best, result


def run_json(out: str = "build/BENCH_fabric.json", reps: int = 3,
             min_speedup: float = 3.0) -> tuple[int, dict]:
    """(exit code, report): the report is also written to ``out``."""
    fails, rows = [], []
    for rf in (1, 2, 4, 8):
        cfg = dict(SCALE, replication_factor=rf)
        t_oracle, oracle = _min_time(
            lambda: simulate_fabric(fast=False, **cfg), reps)
        t_fast, fast = _min_time(
            lambda: simulate_fabric(fast=True, **cfg), reps)
        identical = (dataclasses.asdict(oracle) == dataclasses.asdict(fast))
        rows.append({
            "replication_factor": rf,
            "events": oracle.events,
            "tx_over_rx": oracle.tx_over_rx,
            "per_frame_s": t_oracle,
            "fast_s": t_fast,
            "speedup": t_oracle / t_fast,
            "identical": identical,
        })
        if not identical:
            diffs = [k for k, v in dataclasses.asdict(oracle).items()
                     if v != getattr(fast, k)]
            fails.append(f"rf={rf}: fast result diverges from the "
                         f"per-frame oracle on {diffs}")
    per_frame_total = sum(r["per_frame_s"] for r in rows)
    fast_total = sum(r["fast_s"] for r in rows)
    report = {
        "workload": "Fig 10 rail sweep: 512 ranks / 2 DP groups, rf 1-8",
        "scale": dict(SCALE),
        "reps": reps,
        "timing": "min-of-N per engine (shared-CPU noise is one-sided)",
        "rows": rows,
        "per_frame_total_s": per_frame_total,
        "fast_total_s": fast_total,
        "speedup": per_frame_total / fast_total,
        "min_speedup_gate": min_speedup,
    }
    with open(out_path(out), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    if report["speedup"] < min_speedup:
        fails.append(f"fast-path speedup {report['speedup']:.2f}x is below "
                     f"the {min_speedup:.0f}x gate")
    for msg in fails:
        print(f"FAIL: {msg}", file=sys.stderr)
    return (1 if fails else 0), report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", action="store_true",
                    help="fast-vs-oracle Fig 10 benchmark; write "
                         "build/BENCH_fabric.json and gate on >= 3x + "
                         "identity")
    ap.add_argument("--out", default="build/BENCH_fabric.json")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if args.json:
        sys.exit(run_json(args.out, reps=args.reps)[0])
    run()
