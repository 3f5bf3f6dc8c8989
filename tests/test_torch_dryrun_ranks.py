"""The dry run's tensor-parallel train cells traced for two ranks.

Under the sequence-sharded attention (heads that do not divide the
``model`` extent: each model rank computes its s/m query rows against
every earlier position), a later model rank has more causal pairs than
rank 0, so rank 0 alone shows the cheapest rank. `lower_cell` traces the
last model rank of the first dp group too and records, term by term, the
larger of the two. The fake worlds run in a subprocess, so that no xdist
worker keeps a default process group.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

TRACE = """
import json, sys
import repro_torch.configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
real = C.get
C.get = lambda name: real(name).reduced()      # reduced widths, real shapes
# 4 heads over 16 model ranks: the attention is sequence-sharded; 256
# positions give each model rank 16 query rows
cfg = C.get("tinyllama-1.1b")
shape = ShapeConfig("t", 256, 16, "train")
out = {}
for multi in (False, True):
    last = dryrun.last_model_rank(multi)
    out[str(multi)] = {"last": last, "flops": [
        dryrun.trace_rank(cfg, shape, multi, r)["flops_per_device"]
        for r in (0, last)]}
dryrun.SHAPES = dict(dryrun.SHAPES, t=shape)
cell = dryrun.lower_cell("tinyllama-1.1b", "t", False)
out["cell"] = {k: cell[k] for k in ("status", "model", "hlo_flops_total",
                                    "chips")}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ranks") / "ranks.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(TRACE),
                          path], capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("multi", ["False", "True"])
def test_last_model_rank_does_more_work_than_rank_zero(traced, multi):
    r = traced[multi]
    assert r["last"] == 15         # data 0 (pod 0), model 15, row-major
    first, last = r["flops"]
    assert last > first > 0


def test_cell_records_the_larger_rank(traced):
    cell = traced["cell"]
    assert cell["status"] == "ok" and cell["model"] == "tp"
    assert cell["hlo_flops_total"] == \
        max(traced["False"]["flops"]) * cell["chips"]
