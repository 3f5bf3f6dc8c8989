"""The dry run's serving cells under tensor parallelism, on the fake
process group.

A tensor-parallel family's prefill and decode cells trace the serving
step over ``model`` under ``ShardingRules(mesh, fsdp=cfg.fsdp)``, as the
reference's dry run does: each rank's params cut over ``model`` (and a
``wemb`` dim over the dp axes under FSDP), the cache cut on ``kv_seq``,
``"model": "tp"`` in the record, rank 0 and the last model rank traced
and the larger term of each kept. An ssm cell runs over ``model`` too,
its SSD heads cut. Reduced widths at shapes the (16, 16) mesh divides
(mamba2 at 16 SSD heads of 8); the fake
worlds run in a subprocess, so that no xdist worker keeps a default
process group.
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
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import registry
real = C.get
# reduced widths; mamba2 at 16 SSD heads of 8, so that they divide 16
OVER = {"mamba2-2.7b": {"ssm_head_dim": 8}}
C.get = lambda name: real(name).reduced(**OVER.get(name, {}))
shapes = {"p": ShapeConfig("p", 256, 32, "prefill"),
          "d": ShapeConfig("d", 256, 32, "decode")}
dryrun.SHAPES = dict(dryrun.SHAPES, **shapes)
traced = []
trace = dryrun.trace_rank


def recording(cfg, shape, multi_pod, rank=0):
    traced.append([cfg.name, shape.name, multi_pod, rank])
    r = trace(cfg, shape, multi_pod, rank)
    out["terms"][f"{cfg.name}/{shape.name}/{multi_pod}/{rank}"] = {
        k: r[k] for k in ("flops_per_device", "bytes_per_device",
                          "collective_bytes_per_device")}
    return r


dryrun.trace_rank = recording
out = {"cells": {}, "terms": {}, "shapes": {}}
for arch in ("tinyllama-1.1b", "granite-34b", "arctic-480b",
             "llava-next-mistral-7b", "mamba2-2.7b"):
    for multi in (False, True):
        for s in shapes:
            r = dryrun.lower_cell(arch, s, multi)
            out["cells"][f"{arch}/{s}/{multi}"] = {
                k: r.get(k) for k in ("status", "model", "hlo_flops_total",
                                      "chips", "bytes_per_device_hbm",
                                      "collective_s")}
    cfg = C.get(arch)
    for multi in (False, True):
        with fake_world(512 if multi else 256):
            rules = ShardingRules(make_production_mesh(multi_pod=multi,
                                                       device="cpu"),
                                  fsdp=cfg.fsdp)
            params = registry.abstract_params(cfg, rules)
            cache = registry.abstract_cache(cfg, rules, 32, 256)
            empty = registry.init_cache(cfg, 32, 256, device="cpu",
                                        rules=rules)
            assert {k: getattr(t, "shape", t) for k, t in empty.items()} \
                == {k: getattr(t, "shape", t) for k, t in cache.items()
                    if k != "length"} | {"length": 0}
            out["shapes"][f"{arch}/{multi}"] = {
                "params": {k: list(t.shape) for k, t in params.items()},
                "cache": {k: (list(t.shape) if hasattr(t, "shape") else t)
                          for k, t in cache.items()},
                "global": {k: list(s.shape) for k, s in
                           registry.param_specs(cfg).items()},
                "logical": {k: list(s.logical) for k, s in
                            registry.param_specs(cfg).items()},
                "fsdp": cfg.fsdp,
                "kv": [cfg.num_layers, cfg.num_kv_heads, cfg.head_dim]}
out["traced"] = traced
json.dump(out, open(sys.argv[1], "w"))
"""

TP = ("tinyllama-1.1b", "granite-34b", "arctic-480b",
      "llava-next-mistral-7b")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "serve.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(TRACE),
                          path], capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", TP)
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("shape", ["p", "d"])
def test_tp_serving_cell_traces_two_ranks_over_model(traced, arch, multi,
                                                     shape):
    """Each cell ok and ``"model": "tp"``; traced for rank 0 and for the
    last model rank of the first dp group, its FLOPs those of the larger
    trace; its collective term above 0 (the model group's all-reduces,
    and FSDP's gathers)."""
    cell = traced["cells"][f"{arch}/{shape}/{multi}"]
    assert cell["status"] == "ok" and cell["model"] == "tp"
    assert cell["collective_s"] > 0
    ranks = [r for a, s, m, r in traced["traced"]
             if a == arch + "-smoke" and s == shape and m == multi]
    assert ranks == [0, 15]
    flops = [traced["terms"][f"{arch}-smoke/{shape}/{multi}/{r}"]
             ["flops_per_device"] for r in ranks]
    assert cell["hlo_flops_total"] == max(flops) * cell["chips"]


@pytest.mark.parametrize("arch", TP)
@pytest.mark.parametrize("multi", [False, True])
def test_tp_serving_stand_ins_are_rank_local(traced, arch, multi):
    """Rank 0's params are cut over model where the spec maps a dim to it
    (and its wemb dim over the dp ranks under FSDP), and its cache is
    the block (L, b / dp, S / m, kv, hd), with max_seq kept (an empty
    cache of `init_cache` under the same rules too)."""
    got = traced["shapes"][f"{arch}/{multi}"]
    dp = 32 if multi else 16
    model_axes = {"vocab", "heads", "kv_heads", "ff", "expert"}
    for k, shape in got["params"].items():
        want = list(got["global"][k])
        for i, name in enumerate(got["logical"][k]):
            if name in model_axes and want[i] % 16 == 0:
                want[i] //= 16
            elif name == "wemb" and got["fsdp"] and want[i] % dp == 0:
                want[i] //= dp
        assert shape == want, (arch, k)
    n_layers, kv, hd = got["kv"]
    for k in ("k", "v"):
        assert got["cache"][k] == [n_layers, 32 // dp, 256 // 16, kv, hd]
    assert got["cache"]["max_seq"] == 256
    assert got["cache"]["length"] == 255
    if arch == "granite-34b":
        assert got["fsdp"] and got["params"]["wq"] == [2, 64 // dp,
                                                       64 // 16]


@pytest.mark.parametrize("multi", [False, True])
def test_ssm_serving_cell_stays_replicated(traced, multi):
    """mamba2's serving cells run over model (they kept each layer whole
    before the ssm family ran tensor-parallel): ``"model": "tp"``, traced
    for rank 0 and the last model rank, its leaves cut on ``ssm_inner``
    and vocab over model, B and C's whole, and its cache's SSD heads and
    x conv columns cut (no positions, so no ``max_seq``)."""
    for shape in ("p", "d"):
        cell = traced["cells"][f"mamba2-2.7b/{shape}/{multi}"]
        assert cell["status"] == "ok" and cell["model"] == "tp"
        assert cell["collective_s"] > 0
        assert [r for a, s, m, r in traced["traced"]
                if a == "mamba2-2.7b-smoke" and s == shape
                and m == multi] == [0, 15]
    got = traced["shapes"][f"mamba2-2.7b/{multi}"]
    cut = {k for k, v in got["params"].items() if v != got["global"][k]}
    assert cut == {"embed", "unembed", "wz", "wx", "wdt", "conv_x",
                   "A_log", "D", "dt_bias", "gate_norm", "w_out"}
    for k in cut:
        assert sum(a != b for a, b in zip(got["params"][k],
                                          got["global"][k])) == 1
    dp = 32 if multi else 16
    L, h, din = got["global"]["A_log"][0], got["global"]["A_log"][1], \
        got["global"]["gate_norm"][1]
    assert got["cache"]["state"][:3] == [L, 32 // dp, h // 16]
    assert got["cache"]["conv_x"] == [L, 32 // dp, 3, din // 16]
    assert got["cache"]["conv_B"][1:3] == [32 // dp, 3]
    assert "max_seq" not in got["cache"]
