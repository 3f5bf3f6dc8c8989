"""The benchmark's definition, found by name: a cell's entry in
``BENCHMARK.json``, its configuration file, its traffic file
(``bench/traffic/<traffic>.json``), its limits (``bench/limits/<cell>
.json``) and the reader of each per-layer metric
(``bench/metrics/<metric>.py``). Adding a cell, a configuration, a
traffic mix or a metric adds files and entries; no code here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic_name: str
    traffic: dict         # the traffic file
    limits: dict          # the compared numbers' limits
    end_to_end: list      # BENCHMARK.json entries that apply to this cell
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (default: the root's
    ``BENCHMARK.json``); its files are looked up under ``root``."""
    root = Path(root)
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "bench" / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic_name=w["traffic"], traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The module of ``bench/metrics/<metric>.py``: ``read(run)`` returns
    the metric's value, or None where the run has nothing to read."""
    path = Path(root) / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
