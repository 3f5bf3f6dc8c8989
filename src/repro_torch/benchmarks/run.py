"""Benchmark harness on the port — one module per paper table or figure,
the port of ``benchmarks/run.py``.

    python -m repro_torch.benchmarks.run [--only fig2,...] [--smoke] \
        [--device cpu] [--metrics-out PATH]

Runs on the card unless ``--device cpu`` is given (it raises without a
GPU). ``--smoke`` runs the fast, model-free subset (savings,
multicast_overhead with the channel send overhead). Prints
``name,us_per_call,derived`` CSV rows. Mapping to the paper:
  savings            -> Fig 1, Fig 11, §6.7, App. A/B anchors
  stalls             -> Fig 2 (per-iteration stalls per system)
  throughput         -> Fig 6 (throughput x checkpoint count, 4 models)
  shadow_timing      -> Fig 7 (shadow keeps up; min shadow nodes)
  durability_timing  -> tiered flush cost: delta bytes + zero trainer stall
  optimizer_scaling  -> Fig 8 (opt-step scaling across shadow partitions)
  correctness        -> Fig 9 (recovered == uninterrupted)
  multicast_overhead -> Fig 10 (replication factor sweep)
  fabric_sweep       -> Fig 10 at 512 ranks + topology/failure sweeps
  kernels            -> the Hopper kernels vs their plain versions
The roofline table is a script of its own, as the root
``benchmarks/roofline_table.py`` is (the JAX runner has no entry for it):
``python -m repro_torch.benchmarks.roofline_table`` formats the port's
dry run (`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import sys
import time
import traceback

MODULES = [
    ("savings", "repro_torch.benchmarks.savings"),
    ("multicast_overhead", "repro_torch.benchmarks.multicast_overhead"),
    ("fabric_sweep", "repro_torch.benchmarks.fabric_sweep"),
    ("optimizer_scaling", "repro_torch.benchmarks.optimizer_scaling"),
    ("kernels", "repro_torch.benchmarks.kernels"),
    ("stalls", "repro_torch.benchmarks.stalls"),
    ("shadow_timing", "repro_torch.benchmarks.shadow_timing"),
    ("durability_timing", "repro_torch.benchmarks.durability_timing"),
    ("correctness", "repro_torch.benchmarks.correctness"),
    ("throughput", "repro_torch.benchmarks.throughput"),
]


SMOKE = {"savings", "multicast_overhead"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--only", default="")
    ap.add_argument("--smoke", action="store_true",
                    help=f"fast model-free subset: {sorted(SMOKE)}")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--metrics-out", default=None,
                    help="write a repro_torch.obs metrics snapshot of the "
                         "run (default build/BENCH_metrics.json under "
                         "--smoke)")
    args = ap.parse_args(argv)
    from repro_torch.benchmarks.common import out_path
    from repro_torch.device import resolve
    device = resolve(args.device)
    only = {s.strip() for s in args.only.split(",") if s.strip()}
    if args.smoke:
        only = SMOKE if not only else (only & SMOKE)
        if not only:
            ap.error(f"--only selects no smoke module; smoke set: "
                     f"{sorted(SMOKE)}")
        if args.metrics_out is None:
            args.metrics_out = "build/BENCH_metrics.json"

    registry = None
    if args.metrics_out:
        from repro_torch.obs import MetricsRegistry
        registry = MetricsRegistry()

    print("name,us_per_call,derived")
    failures = []
    for name, mod in MODULES:
        if only and name not in only:
            continue
        t0 = time.time()
        print(f"# === {name} ===", flush=True)
        try:
            fn = importlib.import_module(mod).run
            params = inspect.signature(fn).parameters
            kw = {}
            # benchmarks that accept a registry publish their channel /
            # stall accounting into the run-wide metrics snapshot
            if registry is not None and "registry" in params:
                kw["registry"] = registry
            if "device" in params:
                kw["device"] = device
            fn(**kw)
        except Exception as e:                      # keep the harness going
            traceback.print_exc()
            failures.append(name)
            print(f"{name}.FAILED,0,{type(e).__name__}")
        print(f"# {name} done in {time.time() - t0:.1f}s", flush=True)
    if registry is not None:
        registry.write_json(out_path(args.metrics_out))
        print(f"# metrics snapshot -> {args.metrics_out}")
    if failures:
        print(f"# FAILURES: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
