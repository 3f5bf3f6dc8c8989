"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's, on the CPU.

Every fake world (`repro_torch.launch.mesh.fake_world`) runs in a
subprocess, so that no xdist worker keeps a default process group:

- the production meshes of 256 and 512 ranks (the facts of the
  reference's ``test_production_mesh_shapes``) and the error in a world of
  another size;
- the meta stand-ins (``abstract_params``, ``abstract_train_state``,
  ``abstract_cache``, ``input_specs``) on a (4, 2) mesh against the
  reference's ``ShapeDtypeStruct`` ones on 8 forced host devices (a JAX
  subprocess; nothing is compiled), leaf for leaf;
- the ring's collective bytes on a fake (4, 1) world;
- the dry-run CLI at reduced widths (``--out`` resumed).

`analyze_step` on a one-rank mesh needs no group and runs here, against
closed forms. The roofline tables and the ``--mesh`` flags need none
either; serving over four gloo ranks spawns them (`_torch_spawn`).
"""
import json
import os
import subprocess
import sys
import textwrap
from argparse import Namespace

import numpy as np
import pytest
import torch

from _torch_spawn import spawn

from repro_torch import configs as TC
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
from repro_torch.kernels.flash_attention import flash_work
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import registry
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.step import abstract_train_state, build_train_step

torch.set_num_threads(2)   # leave cores to the other test workers

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")

# the configs whose stand-ins are compared: dense, FSDP (gelu2), MoE, and
# the families whose inputs have their own rules (audio, vlm, vit)
ARCHS = ("tinyllama-1.1b", "granite-34b", "arctic-480b", "whisper-medium",
         "llava-next-mistral-7b", "vit-h-14")
# reduced cells: batch 8 splits over the (4, 2) mesh's 4 dp ranks, and 32
# positions leave the reduced vlm's 8 patches 24 text tokens
SHAPES = {"train": (32, 8), "prefill": (32, 8), "decode": (32, 8)}
# Two differences the test names: integer inputs are int64 in the port
# (its index type) where the reference's are int32; and a dim the
# reference cuts over "model" stays whole in the port where it computes
# the layer whole (serving, and the families that are not tensor-parallel).
INT_DTYPES = {"int32": "int64"}


def _run(script: str, *argv, env_extra=None, timeout=300) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script),
                          *argv], capture_output=True, text=True, env=env,
                         timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


REFERENCE = """
import json, sys
import jax
from repro.dist import compat
import repro.configs as C
from repro.configs.base import ShapeConfig
from repro.dist.sharding import ShardingRules
from repro.models import registry
from repro.train.step import abstract_train_state

ARCHS, SHAPES = %r, %r
mesh = compat.make_mesh((4, 2), ("data", "model"), devices=jax.devices()[:8],
                        axis_types=(compat.AxisType.Auto,) * 2)


def leaf(s):
    if getattr(s, "sharding", None) is None:
        return None
    spec = list(s.sharding.spec) + [None] * (len(s.shape)
                                             - len(s.sharding.spec))
    model = ["model" in ((p,) if isinstance(p, str) else (p or ()))
             for p in spec]
    return [list(s.shape), str(s.dtype),
            list(s.sharding.shard_shape(s.shape)), model]


out = {}
for arch in ARCHS:
    cfg = C.get(arch).reduced()
    rules = ShardingRules(mesh, fsdp=cfg.fsdp)
    st = abstract_train_state(cfg, rules)
    got = {"params": st.params, "mu": st.mu, "nu": st.nu}
    if cfg.family != "vit":
        got["cache"] = registry.abstract_cache(cfg, rules, 8, 32)
    for kind, (s, b) in SHAPES.items():
        got["inputs/" + kind] = registry.input_specs(
            cfg, ShapeConfig(kind, s, b, kind), rules)
    out[arch] = {g: {k: leaf(v) for k, v in t.items()}
                 for g, t in got.items()}
    out[arch]["fsdp"] = cfg.fsdp
json.dump(out, open(sys.argv[1], "w"))
""" % (ARCHS, SHAPES)

PORT = """
import json, sys
import torch
from repro_torch import configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.sharding import Mesh, ShardingRules
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import registry
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.step import abstract_train_state, build_train_step

ARCHS, SHAPES = %r, %r
out = {"meshes": {}, "errors": {}}
for multi, n in ((False, 256), (True, 512)):
    with fake_world(n):
        m = make_production_mesh(multi_pod=multi, device="cpu")
        out["meshes"][n] = [m.shape, m.size, list(m.axis_names),
                            m.coords]
for multi in (False, True):
    with fake_world(8):
        try:
            make_production_mesh(multi_pod=multi, device="cpu")
        except ValueError as e:
            out["errors"][str(multi)] = str(e)
try:
    make_production_mesh(device="cpu")
except ValueError as e:
    out["errors"]["one process"] = str(e)

with fake_world(8):
    mesh = Mesh.over_ranks((4, 2), ("data", "model"), device="cpu")
    out["coords"] = mesh.coords
    for arch in ARCHS:
        cfg = C.get(arch).reduced()
        rules = ShardingRules(mesh, fsdp=cfg.fsdp)
        st = abstract_train_state(cfg, rules)
        got = {"params": st.params, "mu": st.mu, "nu": st.nu}
        if cfg.family != "vit":
            got["cache"] = registry.abstract_cache(cfg, rules, 8, 32)
            specs = registry.cache_specs(cfg, 8, 32)
            out[arch + "/cache_global"] = {k: list(s.shape)
                                           for k, s in specs.items()}
        for kind, (s, b) in SHAPES.items():
            got["inputs/" + kind] = registry.input_specs(
                cfg, ShapeConfig(kind, s, b, kind), rules)
        out[arch] = {g: {k: ([list(v.shape), str(v.dtype).removeprefix(
                                 "torch."), str(v.device)]
                             if isinstance(v, torch.Tensor) else v)
                         for k, v in t.items()}
                     for g, t in got.items()}
        out[arch + "/global"] = {k: list(s.shape) for k, s in
                                 registry.param_specs(cfg).items()}
        out[arch + "/step"] = st.step
        out[arch + "/tp"] = registry.tensor_parallel(cfg)

with fake_world(4):
    mesh = Mesh.over_ranks((4, 1), ("data", "model"), device="cpu")
    cfg = C.get("tinyllama-1.1b").reduced()
    rules = ShardingRules(mesh)
    step = build_train_step(cfg, OptimizerConfig(), lambda s: 1e-3, rules)
    r = analyze_step(step, abstract_train_state(cfg, rules),
                     registry.input_specs(cfg, ShapeConfig(
                         "t", 16, 8, "train"), rules))
    out["ring"] = {k: r[k] for k in ("collective_bytes_per_device",
                                     "per_collective")}
    out["ring"]["leaves"] = {k: [list(s.shape), s.size] for k, s in
                             registry.param_specs(cfg).items()}
json.dump(out, open(sys.argv[1], "w"))
""" % (ARCHS, SHAPES)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.json")
    _run(REFERENCE, path, env_extra={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("port") / "port.json")
    _run(PORT, path)
    with open(path) as f:
        return json.load(f)


# -- production meshes ---------------------------------------------------------

def test_production_mesh_shapes(port):
    single, multi = port["meshes"]["256"], port["meshes"]["512"]
    assert single[0] == {"data": 16, "model": 16} and single[1] == 256
    assert multi[0] == {"pod": 2, "data": 16, "model": 16}
    assert multi[1] == 512 and multi[2] == ["pod", "data", "model"]
    assert single[3] == {"data": 0, "model": 0}     # the fake rank 0


def test_production_mesh_names_the_ranks_it_needs(port):
    assert "256 ranks" in port["errors"]["False"]
    assert "not 8" in port["errors"]["False"]
    assert "512 ranks" in port["errors"]["True"]
    assert "not 1" in port["errors"]["one process"]


# -- the stand-ins against the reference's -------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_match_the_references(ref, port, arch):
    """Leaf for leaf: the reference's global shape (from the port's specs
    where the stand-in is local) and dtype, and a local shape equal to the
    reference's per-device shard shape, except on model-mapped dims where
    the port computes the layer whole (every family's cache and inputs,
    and the state of a family that is not tensor-parallel), which it
    holds whole."""
    want, got = ref[arch], port[arch]
    tp = port[arch + "/tp"]
    assert tp == (arch in ("tinyllama-1.1b", "granite-34b",
                           "llava-next-mistral-7b", "vit-h-14"))
    assert port["coords"] == {"data": 0, "model": 0}
    assert set(got) == set(want) - {"fsdp"}
    assert port[arch + "/step"] == 0
    for group, leaves in want.items():
        if group == "fsdp":
            continue
        names = set(leaves) - ({"length"} if group == "cache" else set())
        assert set(got[group]) - {"length"} == names, group
        for k in names:
            shape, dtype, shard, model = leaves[k]
            lshape, ldtype, device = got[group][k]
            assert device == "meta", (group, k)
            assert ldtype == INT_DTYPES.get(dtype, dtype), (group, k)
            cut = tp and group in ("params", "mu", "nu")
            assert lshape == [g if m and not cut else s for g, s, m
                              in zip(shape, shard, model)], (group, k)
            if group in ("params", "mu", "nu"):
                assert port[arch + "/global"][k] == shape, (group, k)
            if group == "cache":
                assert port[arch + "/cache_global"][k] == shape, (group, k)
    if "cache" in want:
        # the reference's length is an int32 scalar, the port's a host int
        assert want["cache"]["length"] is None
        assert got["cache"]["length"] == 31


def test_stand_ins_cut_what_the_reference_cuts(ref):
    """The comparison above bites: on the (4, 2) mesh the reference cuts
    the batch, FSDP's wemb and ZeRO-1's moments over data, and some dims
    over model (which the port cuts too for a tensor-parallel family's
    state, and keeps whole elsewhere)."""
    dense, granite = ref["tinyllama-1.1b"], ref["granite-34b"]
    assert granite["fsdp"] and not dense["fsdp"]
    assert dense["inputs/train"]["tokens"][2] == [2, 32]
    assert dense["params"]["wq"][2] == [2, 64, 32]      # heads over model
    assert granite["params"]["wq"][2] == [2, 16, 32]    # and wemb over data
    assert any(v[2] != v[0] and not any(v[3])
               for v in dense["mu"].values())


# -- analyze_step against closed forms ------------------------------------------

def _dense_step(b: int, s: int):
    cfg = TC.get("tinyllama-1.1b").reduced()
    rules = ShardingRules(make_smoke_mesh("cpu"))
    step = build_train_step(cfg, OptimizerConfig(), lambda t: 1e-3, rules)
    state = abstract_train_state(cfg, rules)
    inputs = registry.input_specs(cfg, ShapeConfig("t", s, b, "train"),
                                  rules)
    return cfg, state, inputs, analyze_step(step, state, inputs)


def test_analyze_step_flops_match_the_closed_form():
    b, s = 2, 32
    cfg, _, _, r = _dense_step(b, s)
    d, h, kv, hd, f, v, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.d_ff, cfg.vocab_size,
                             cfg.num_layers)
    t = b * s
    per_token = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    # each layer's product: forward 2mnk, the remat forward 2mnk, the
    # backward 4mnk (both operands need gradients); the logits 2 + 4. The
    # remat forward stops once the backward's last saved tensor is back
    # (torch.utils.checkpoint's early stop), before the MLP's down
    # projection, whose output nothing saves
    linear = (L * t * (8 * per_token - 2 * f * d)) + 6 * t * d * v
    # the plain attention backward: five (b, h, s, s) x d products
    attn_bwd = L * 5 * 2 * b * h * s * s * hd
    q = torch.empty((b, s, h, hd), device="meta", dtype=torch.bfloat16)
    k = torch.empty((b, s, kv, hd), device="meta", dtype=torch.bfloat16)
    flash = 2 * L * flash_work(q, k, True)[0]        # forward and remat
    want = linear + attn_bwd + flash
    assert r["kernels"]["flash_attention"]["calls"] == 2 * L
    assert r["kernels"]["flash_attention"]["flops"] == flash
    assert abs(r["flops_per_device"] - want) <= 0.01 * want, (
        r["flops_per_device"], want)


def test_analyze_step_counts_the_arguments_exactly():
    cfg, state, inputs, r = _dense_step(2, 32)
    n = sum(p.numel() for p in state.params.values())
    assert r["memory"]["argument_bytes"] == 3 * 4 * n + 2 * 8 * 2 * 32
    # AdamW updates the state in place: the result aliases it
    assert r["memory"]["alias_bytes"] == 3 * 4 * n
    assert r["kernels"]["fused_adamw"]["calls"] == len(state.params)
    assert r["kernels"]["fused_adamw"]["bytes"] == n * (2 * 4 + 4 + 16)
    assert r["memory"]["temp_bytes"] > 4 * n     # the f32 gradients at least
    assert r["collective_bytes_per_device"] == 0
    assert r["bytes_per_device"] > 0


def test_analyze_step_refuses_real_tensors_and_a_host_read():
    cfg = TC.get("tinyllama-1.1b").reduced()
    rules = ShardingRules(make_smoke_mesh("cpu"))
    with pytest.raises(ValueError, match="meta"):
        analyze_step(lambda x: x, torch.zeros(2))
    step = build_train_step(cfg, OptimizerConfig(grad_clip=1.0),
                            lambda t: 1e-3, rules)
    with pytest.raises(RuntimeError, match="grad_clip"):
        analyze_step(step, abstract_train_state(cfg, rules),
                     registry.input_specs(cfg, ShapeConfig("t", 16, 2,
                                                           "train"), rules))


def test_ring_collective_bytes_match_the_closed_form(port):
    """On a fake (4, 1) world each leaf's ring sends (n - 1) chunks in its
    reduce-scatter and (n - 1) in its all-gather, a chunk being an n-th
    of the f32 leaf (every reduced leaf has a dim that splits 4 ways); the
    loss and the grad norm add one f32 all-reduce each."""
    r, n = port["ring"], 4
    chunks = sum(size * 4 // n for _, size in r["leaves"].values())
    assert all(any(x % n == 0 for x in shape)
               for shape, _ in r["leaves"].values())
    assert r["per_collective"]["send"] == 2 * (n - 1) * chunks
    assert r["per_collective"]["recv_"] == 2 * (n - 1) * chunks
    assert r["per_collective"]["allreduce_"] == 8
    assert r["collective_bytes_per_device"] == 2 * (n - 1) * chunks + 8


# -- the CLI ----------------------------------------------------------------------

CLI = """
import json, sys
import repro_torch.configs as C
real = C.get
C.get = lambda name: real(name).reduced()      # reduced widths, real shapes
from repro_torch.launch import dryrun
out = sys.argv[1]
dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--out", out])
first = json.load(open(out))
dryrun.main(["--arch", "tinyllama-1.1b", "--both-meshes", "--out", out])
json.dump({"first": first, "all": json.load(open(out))},
          open(out + ".both", "w"))
"""


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "dryrun_results.json")
    _run(CLI, path)
    with open(path + ".both") as f:
        return json.load(f)


def _reference_keys():
    from repro.launch.roofline import Roofline
    row = Roofline("a", "s", "single", 1, 1.0, 1.0, 1.0, 1.0, {}).row()
    return ({"arch", "shape", "mesh", "status", "chips", "lower_s",
             "compile_s", "memory", "bytes_per_device_hbm"}
            | set(row) - {"arch", "shape", "mesh", "chips"})


def test_dryrun_cli_records_every_cell(cli):
    recs = {(r["arch"], r["shape"], r["mesh"]): r for r in cli["all"]}
    assert len(cli["all"]) == len(recs) == 8       # 4 shapes x 2 meshes
    want = _reference_keys() - {"lower_s", "compile_s"} | {"trace_s",
                                                            "model"}
    for mesh, chips in (("single", 256), ("multi", 512)):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            r = recs[("tinyllama-1.1b", shape, mesh)]
            assert r["status"] == "ok", r
            assert set(r) == want
            assert r["chips"] == chips
            assert r["model"] == ("tp" if shape == "train_4k"
                                  else "replicated")
            assert r["hlo_flops_total"] > 0 and r["memory"]["temp_bytes"] > 0
            assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                        "temp_bytes", "alias_bytes"}
        train = recs[("tinyllama-1.1b", "train_4k", mesh)]
        assert train["per_collective"]["send"] > 0
        skip = recs[("tinyllama-1.1b", "long_500k", mesh)]
        assert skip["status"] == "skipped"
        assert skip["reason"].startswith("pure full-attention family")
    one = recs[("tinyllama-1.1b", "train_4k", "single")]
    two = recs[("tinyllama-1.1b", "train_4k", "multi")]
    # 16 rows a rank, then 8: the work a rank does halves
    assert abs(two["hlo_flops_total"] / 512 / (one["hlo_flops_total"] / 256)
               - 0.5) < 0.02


def test_dryrun_cli_resumes_from_out(cli):
    """The second call keeps the first call's record and adds the rest."""
    assert len(cli["first"]) == 1
    assert cli["all"][0] == cli["first"][0]


def test_dryrun_skips_with_the_references_reason():
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.base import shape_applicable as jshape_applicable
    from repro_torch.launch.dryrun import lower_cell
    r = lower_cell("glm4-9b", "long_500k", False)
    jcfg = __import__("repro.configs", fromlist=["get"]).get("glm4-9b")
    _, why = jshape_applicable(jcfg, JSHAPES["long_500k"])
    assert r == {"arch": "glm4-9b", "shape": "long_500k", "mesh": "single",
                 "status": "skipped", "reason": why}


# -- the roofline tables ------------------------------------------------------------

RESULTS = [
    {"arch": "tinyllama-1.1b", "shape": "train_4k", "mesh": "single",
     "status": "ok", "compute_s": 0.6773, "memory_s": 6.1038,
     "collective_s": 0.33, "bound": "memory", "useful_flops_ratio": 0.0412,
     "mfu_at_roofline": 0.00457, "bytes_per_device_hbm": 48655700000},
    {"arch": "glm4-9b", "shape": "long_500k", "mesh": "single",
     "status": "skipped", "reason": "pure full-attention family"},
    {"arch": "arctic-480b", "shape": "train_4k", "mesh": "single",
     "status": "error", "error": "NotImplementedError: bincount"},
    {"arch": "tinyllama-1.1b", "shape": "train_4k", "mesh": "multi",
     "status": "ok", "compute_s": 0.3387, "memory_s": 3.087,
     "collective_s": 0.341, "bound": "memory", "useful_flops_ratio": 0.0412,
     "mfu_at_roofline": 0.0045, "bytes_per_device_hbm": 30749375000},
    {"arch": "zamba2-1.2b", "shape": "decode_32k", "mesh": "multi",
     "status": "ok", "compute_s": 0.0001, "memory_s": 0.0123,
     "collective_s": 0.0, "bound": "memory", "useful_flops_ratio": 0.5,
     "mfu_at_roofline": 0.0001},
]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_roofline_tables_print_the_same_text(tmp_path, capsys, mesh):
    import benchmarks.roofline_table as jtable
    from repro_torch.benchmarks import roofline_table as ttable
    path = tmp_path / "dryrun_results.json"
    path.write_text(json.dumps(RESULTS))
    jtable.run(str(path), mesh)
    want = capsys.readouterr().out
    ttable.run(str(path), mesh)
    got = capsys.readouterr().out
    assert got == want
    assert len(want.splitlines()) == 2 + sum(r["mesh"] == mesh
                                             for r in RESULTS)


# -- the --mesh flags ---------------------------------------------------------------

TRAIN_ARGS = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
              "--seq", "16", "--checkpointer", "none"]


def test_train_mesh_smoke_reports_as_before():
    a = ttrain.run(TRAIN_ARGS).report
    b = ttrain.run(TRAIN_ARGS + ["--mesh", "smoke"]).report
    assert set(a) == set(b)
    assert a["final_loss"] == b["final_loss"] and a["steps"] == 2


@pytest.mark.parametrize("mesh,ranks", [("single", 256), ("multi", 512)])
def test_production_mesh_flags_raise_in_one_process(mesh, ranks):
    with pytest.raises(ValueError, match=f"{ranks} ranks"):
        ttrain.run(TRAIN_ARGS + ["--mesh", mesh])
    with pytest.raises(ValueError, match=f"{ranks} ranks"):
        tserve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                     "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
                     "2", "--mesh", mesh])


def test_train_mesh_flag_over_four_ranks_reports_on_rank_zero(tmp_path):
    """``--mesh single``'s path on four gloo ranks (a (4, 1) mesh in place
    of the 256-rank one): every rank trains its slices, global rank 0
    hosts Checkmate's shadow, recovers at the failure and reports with
    the keys of the one-rank run; the other ranks report nothing."""
    argv = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "8",
            "--seq", "16", "--checkpointer", "checkmate", "--fail-at", "2"]
    spawn("_torch_dp_workers", "train_cli", 4, tmp_path, str(tmp_path),
          argv)
    got = json.loads((tmp_path / "report.json").read_text())
    want = ttrain.run(argv).report
    assert set(got) == set(want)
    assert got["steps"] == 2 and got["checkpoints"] == want["checkpoints"]
    assert got["recoveries"] == want["recoveries"] == 1
    assert got["shadow"]["lag"] == 0 and np.isfinite(got["final_loss"])


def _serve_cfg():
    return TC.get("tinyllama-1.1b").reduced(compute_dtype="float32")


SERVE = Namespace(batch=8, prompt_len=12, gen=6, seed=3)


def test_serve_mesh_smoke_reports_as_before(capsys):
    tserve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    rep = json.loads(capsys.readouterr().out)
    assert set(rep) == {"arch", "batch", "prompt_len", "generated",
                        "prefill_s", "decode_s", "decode_tok_per_s",
                        "sample_tokens"}
    assert len(rep["sample_tokens"]) == 3


def test_serving_over_four_ranks_equals_one(tmp_path):
    """Each of four dp ranks serves its two rows; the gathered tokens equal
    the one-rank run's, token for token, at f32."""
    want, _, _ = tserve.generate(_serve_cfg(), SERVE, torch.device("cpu"))
    spawn("_torch_dp_workers", "serve_rows", 4, tmp_path, str(tmp_path),
          vars(SERVE))
    for r in range(4):
        got = np.load(tmp_path / f"serve{r}.npy")
        np.testing.assert_array_equal(got, want)
