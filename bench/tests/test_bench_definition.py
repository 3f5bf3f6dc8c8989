"""The benchmark's definition: every file a cell names loads, a new cell
is found by adding files alone, and ``BENCHMARK.json`` keeps to the
format's limits."""
import json
import re
import shutil

import pytest

from bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_bench_cell_files_load(cell):
    c = spec.load_cell(cell)
    assert c.config["reduced"] == []
    assert c.traffic["batch"] % c.traffic["microbatches"] == 0
    # the batch a chip takes: the published global batch over the width
    assert c.traffic["batch"] * c.traffic["data_parallel"] == \
        c.traffic["global_batch"] and c.traffic["source"]
    assert c.traffic["warmup_steps"] >= 3
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    want = {"loss_gap", "grad_gap", "grad_err", "change_gap"}
    if c.traffic["checkpointer"]["kind"] == "checkmate":
        want.add("shadow_mismatch")
    assert set(c.limits) == want


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_bench_metric_reader_agrees(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = spec.reader(metric)
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["layer"], entry["moves"])
    assert callable(mod.read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_bench_config_is_the_registry_entry_changed(config):
    from bench.harness import model_config
    from bench.reference.inputs import param_layout
    from repro_torch.models import registry
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg_file = json.loads((spec.ROOT / entry["file"]).read_text())
    traffic = spec.load_cell(next(
        w["name"] for w in BENCH["workloads"]
        if w["config"] == config)).traffic
    cfg = model_config(cfg_file, traffic)
    specs = registry.param_specs(cfg)
    assert [(k, tuple(specs[k].shape)) for k in sorted(specs)] == \
        [(k, tuple(s)) for k, s, _ in param_layout(cfg_file["model"])]
    assert entry["source"] == cfg_file["source"].split(" ")[0]


def test_bench_new_cell_is_found_without_an_edit(tmp_path):
    """A cell added as an entry and its files is found; no code
    changes."""
    shutil.copytree(spec.ROOT / "bench", tmp_path / "bench")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "gpt2-1.5b.extra",
                               "config": "gpt2-1.5b", "traffic": "extra",
                               "chips": 1, "why": "a test"})
    traffic = json.loads((spec.ROOT / "bench/traffic/16x1024-none.json")
                         .read_text())
    traffic["batch"] = 8
    (tmp_path / "bench/traffic/extra.json").write_text(json.dumps(traffic))
    (tmp_path / "bench/limits/gpt2-1.5b.extra.json").write_text(
        json.dumps({"loss_gap": 1, "grad_gap": 1, "grad_err": 1,
                    "change_gap": 1}))
    (tmp_path / "bench/metrics/extra_ms.py").write_text(
        'UNIT, LAYER, MOVES = "ms", "x", "tokens_per_s"\n'
        'def read(run):\n    return 1.5\n')
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("gpt2-1.5b.extra", root=tmp_path)
    assert c.traffic["batch"] == 8 and c.config["name"] == "gpt2-1.5b"
    assert "ckpt_stall_ms" not in {m["name"] for m in c.end_to_end}
    assert spec.reader("extra_ms", root=tmp_path).read(None) == 1.5


def test_bench_definition_keeps_the_format():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and len(b["command"]) <= 32
    runs = 2 + 14 * 24            # a full check of 24 cells
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in b[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and len(e["why"]) <= 200
            assert "\n" not in e["why"] and "\t" not in e["why"]
    for e in b["workloads"]:
        assert e["chips"] in (1, 4) and NAME.match(e["traffic"])
    for group in ("end_to_end", "per_layer"):
        for m in b[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["name"] not in names
            names.add(m["name"])
            assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert spec.applies(moved, cell)
    assert len(json.dumps(b)) < 64 * 1024
