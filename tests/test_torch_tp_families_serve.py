"""Serving of the ssm, hybrid and audio families over a (2, 2) ("data",
"model") mesh of four gloo ranks on the CPU, against the reference's GSPMD
prefill and decode on four forced host devices; their dry-run serving
cells on the fake process group; and serving on a (1, 1) mesh bitwise
serving with no rules.

The reference runs once, in a module-scoped subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: its
``registry.prefill`` and a jitted ``registry.decode_step`` (and the jitted
``build_decode_step``, whose tokens it holds equal) under
``ShardingRules(mesh, fsdp=cfg.fsdp)``, at f32 compute, batch 4, a 16-token
prompt (whisper: and 32 frames) and 4 greedy decode steps, on the three
``.reduced()`` cases of ``tests/_torch_tp_families_workers.py``; and the
serving CLI's greedy generation of its own prompts on mamba2's weights.
It dumps the initial params, the inputs, the logits, the tokens and each
device's ``addressable_shards`` of every cache leaf after prefill and
after the last step. The port runs once on four gloo ranks
(``families_serve``) from those params.

Tolerances are tests/test_torch_tp_serve.py's: logits to rtol 1e-4 /
atol 1e-5, greedy tokens equal, each rank's cache block to rtol 1e-5 /
atol 1e-5 of its device's shard.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_spawn import spawn
from _torch_tp_families_workers import (BATCH, CLI, PROMPT, SERVE_CASES,
                                        STEPS, serve_cfg)

from repro_torch import configs as TC
from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
from repro_torch.models import registry
from repro_torch.train.step import build_decode_step, serving_params

torch.set_num_threads(2)   # leave cores to the other test workers

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
LOGITS = dict(rtol=1e-4, atol=1e-5)
CACHE = dict(rtol=1e-5, atol=1e-5)

REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.dist import compat
import repro.configs as C
from repro.dist.sharding import ShardingRules
from repro.models import registry
from repro.train.step import build_decode_step

CASES, BATCH, PROMPT, STEPS, CLI = %r, %r, %r, %r, %r
out = {}
m = compat.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(compat.AxisType.Auto,) * 2)
assert [d.id for d in m.devices.flat] == [0, 1, 2, 3]


def shards(tag, cache):
    for k, x in cache.items():
        if k == "length":
            continue
        out[f"{tag}/{k}/spec"] = np.array(str(x.sharding.spec))
        out[f"{tag}/{k}"] = np.asarray(x)
        for s in x.addressable_shards:
            out[f"{tag}/{k}/{s.device.id}"] = np.asarray(s.data)


def serve(cfg, rules, params, tokens, max_seq, extra, steps, tag=None):
    pre = jax.jit(lambda p, t, e: registry.prefill(p, cfg, rules, t,
                                                    max_seq, **e))
    dec = jax.jit(lambda p, c, t: registry.decode_step(p, cfg, rules, c, t))
    step = jax.jit(build_decode_step(cfg, rules))
    cache, logits = pre(params, jnp.asarray(tokens, jnp.int32),
                        {k: jnp.asarray(v) for k, v in extra.items()})
    if tag:
        out[f"{tag}/prefill/logits"] = np.asarray(logits)
        shards(f"{tag}/prefill", cache)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    toks, saved, first = [tok], cache, tok
    for i in range(steps):
        logits, cache = dec(params, cache, tok)
        if tag:
            out[f"{tag}/decode/{i}/logits"] = np.asarray(logits)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks.append(tok)
    if tag:
        shards(f"{tag}/decode", cache)
        again, tok = [first], first
        for _ in range(steps):
            tok, saved = step(params, saved, tok)
            again.append(tok)
        assert (np.concatenate(again, 1) == np.concatenate(toks, 1)).all()
    return np.concatenate([np.asarray(t) for t in toks], axis=1)


with m:
    for tag, (arch, over, max_seq) in CASES.items():
        cfg = C.get(arch).reduced(compute_dtype="float32", **over)
        rules = ShardingRules(m, fsdp=cfg.fsdp)
        params = registry.init_params(jax.random.PRNGKey(3), cfg, rules)
        for k, v in params.items():
            out[f"{tag}/init/{k}"] = np.asarray(v)
            for s in v.addressable_shards:
                out[f"{tag}/param_shape/{k}/{s.device.id}"] = \\
                    np.array(s.data.shape)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT))
        extra = {}
        if cfg.family == "audio":
            extra["frames"] = rng.standard_normal(
                (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32) \\
                * 0.5
        out[f"{tag}/tokens"] = tokens
        for k, v in extra.items():
            out[f"{tag}/{k}"] = v
        out[f"{tag}/generated"] = serve(cfg, rules, params, tokens, max_seq,
                                        extra, STEPS, tag)
        if tag == "mamba2":
            # the serving CLI's prompts, drawn as launch.serve draws them
            prompts = np.random.default_rng(CLI["seed"]).integers(
                0, cfg.vocab_size, (CLI["batch"], CLI["prompt_len"]))
            out["cli/tokens"] = serve(
                cfg, rules, params, prompts,
                CLI["prompt_len"] + CLI["gen"], {}, CLI["gen"] - 1)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(
            REFERENCE % (SERVE_CASES, BATCH, PROMPT, STEPS, CLI)), path],
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    return dict(np.load(ref_path))


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    """What each of the four ranks saw (``families_serve``'s dumps)."""
    d = tmp_path_factory.mktemp("ranks")
    spawn("_torch_tp_families_workers", "families_serve", WORLD, d,
          ref_path, str(d), timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _close(got, want, what, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **tol)


@pytest.mark.parametrize("tag", list(SERVE_CASES))
def test_two_by_two_serving_matches_the_reference(ref, ranks, tag):
    """Prefill's and every decode step's logits, made whole, against the
    reference's on every rank, and the greedy tokens equal (from the
    decode loop and from the built decode step)."""
    for out in ranks:
        _close(out[f"{tag}/prefill/logits"], ref[f"{tag}/prefill/logits"],
               f"{tag} prefill logits", LOGITS)
        for i in range(STEPS):
            _close(out[f"{tag}/decode/{i}/logits"],
                   ref[f"{tag}/decode/{i}/logits"],
                   f"{tag} decode {i} logits", LOGITS)
        want = ref[f"{tag}/generated"].tolist()
        assert out[f"{tag}/tokens"].tolist() == want, tag
        assert out[f"{tag}/step_tokens"].tolist() == want, tag


# the reference's cut of each cache leaf on the (2, 2) mesh: rows over
# data; positions (kv_seq), SSD heads and x conv columns (ssm_inner) and
# cross-attention heads over model; the B and C conv tails whole over it
SPECS = {"state": "PartitionSpec(None, 'data', 'model')",
         "conv_x": "PartitionSpec(None, 'data', None, 'model')",
         "conv_B": "PartitionSpec(None, 'data')",
         "conv_C": "PartitionSpec(None, 'data')",
         "attn_k": "PartitionSpec(None, 'data', 'model')",
         "attn_v": "PartitionSpec(None, 'data', 'model')",
         "k": "PartitionSpec(None, 'data', 'model')",
         "v": "PartitionSpec(None, 'data', 'model')",
         "xk": "PartitionSpec(None, 'data', None, 'model')",
         "xv": "PartitionSpec(None, 'data', None, 'model')"}
LEAVES = {"mamba2": ("state", "conv_x", "conv_B", "conv_C"),
          "zamba2": ("state", "conv_x", "conv_B", "conv_C", "attn_k",
                     "attn_v"),
          "whisper": ("k", "v", "xk", "xv")}


@pytest.mark.parametrize("tag", list(SERVE_CASES))
def test_each_rank_holds_the_references_cache_block(ref, ranks, tag):
    """After prefill and after the last decode step, each rank's cache
    leaves equal the reference device's ``addressable_shards`` under the
    reference's spec (`SPECS`); a cache with positions keeps ``max_seq``,
    the SSM's has none; and each rank served from the reference device's
    shard shape of every param."""
    max_seq = SERVE_CASES[tag][2]
    for r, out in enumerate(ranks):
        assert out["coords"] == {"data": r // 2, "model": r % 2}
        for when in ("prefill", "decode"):
            cache = out[f"{tag}/{when}/cache"]
            assert set(cache) == set(LEAVES[tag]) | {"length"} | (
                set() if tag == "mamba2" else {"max_seq"})
            assert cache.get("max_seq", max_seq) == max_seq
            assert cache["length"] == PROMPT + (
                STEPS if when == "decode" else 0)
            for k in LEAVES[tag]:
                spec = str(ref[f"{tag}/{when}/{k}/spec"])
                assert spec == SPECS[k], (tag, k, spec)
                want = ref[f"{tag}/{when}/{k}/{r}"]
                assert tuple(cache[k].shape) == want.shape, (tag, k, r)
                _close(cache[k], want, f"{tag} {when} {k} rank {r}", CACHE)
        for k, shape in out[f"{tag}/param_shapes"].items():
            assert shape == tuple(ref[f"{tag}/param_shape/{k}/{r}"]), \
                (tag, k, r)


def test_serve_cli_generate_gives_the_references_tokens(ref, ranks):
    """``launch.serve.generate`` over the (2, 2) mesh on the reference's
    mamba2 weights gives the reference's greedy tokens for the CLI's
    prompts, on every rank."""
    want = ref["cli/tokens"].tolist()
    assert len(want) == CLI["batch"] and len(want[0]) == CLI["gen"]
    for out in ranks:
        assert out["cli/tokens"].tolist() == want


# -- the dry run's serving cells -------------------------------------------------

TRACE = """
import json, sys
import repro_torch.configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import registry
real = C.get
# reduced widths; mamba2 at 16 SSD heads of 8 and whisper at its
# published 16:16 heads, so that they divide 16
OVER = {"mamba2-2.7b": {"ssm_head_dim": 8},
        "whisper-medium": {"num_heads": 16, "num_kv_heads": 16}}
C.get = lambda name: real(name).reduced(**OVER.get(name, {}))
shapes = {"p": ShapeConfig("p", 256, 32, "prefill"),
          "d": ShapeConfig("d", 256, 32, "decode")}
dryrun.SHAPES = dict(dryrun.SHAPES, **shapes)
out = {"cells": {}, "shapes": {}}
for arch in ("mamba2-2.7b", "whisper-medium"):
    cfg = C.get(arch)
    for multi in (False, True):
        for s in shapes:
            r = dryrun.lower_cell(arch, s, multi)
            out["cells"][f"{arch}/{s}/{multi}"] = {
                k: r.get(k) for k in ("status", "model", "collective_s",
                                      "error")}
        with fake_world(512 if multi else 256):
            rules = ShardingRules(make_production_mesh(multi_pod=multi,
                                                       device="cpu"),
                                  fsdp=cfg.fsdp)
            params = registry.abstract_params(cfg, rules)
            cache = registry.abstract_cache(cfg, rules, 32, 256)
            out["shapes"][f"{arch}/{multi}"] = {
                "params": {k: list(t.shape) for k, t in params.items()},
                "cache": {k: (list(t.shape) if hasattr(t, "shape") else t)
                          for k, t in cache.items()},
                "global": {k: list(s.shape) for k, s in
                           registry.param_specs(cfg).items()},
                "cache_global": {k: list(s.shape) for k, s in
                                 registry.cache_specs(cfg, 32, 256).items()}}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dry") / "dry.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(TRACE),
                          path], capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


# rank 0's cut of each leaf of the 32 x 256 cache on the production mesh
# (dp 16 or 32, model 16), dim by dim: "b" the rows over dp, "m" over model
CACHE_CUTS = {"state": ".bm..", "conv_x": ".b.m", "conv_B": ".b..",
              "conv_C": ".b..", "k": ".bm..", "v": ".bm..", "xk": ".b.m.",
              "xv": ".b.m."}


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "whisper-medium"])
@pytest.mark.parametrize("multi", [False, True])
def test_dryrun_serving_cells_run_over_model(dry, arch, multi):
    """mamba2's and whisper's prefill and decode cells trace the serving
    step over model (``"model": "tp"``, a collective term above 0); rank
    0's params are cut over model where the spec maps a dim to it (16
    divides), and its cache is cut as the reference cuts it."""
    for s in ("p", "d"):
        cell = dry["cells"][f"{arch}/{s}/{multi}"]
        assert cell["status"] == "ok", cell
        assert cell["model"] == "tp" and cell["collective_s"] > 0
    got = dry["shapes"][f"{arch}/{multi}"]
    dp = 32 if multi else 16
    cut = [k for k, shape in got["params"].items()
           if shape != got["global"][k]]
    assert cut and all(
        sum(a != b for a, b in zip(got["params"][k], got["global"][k])) == 1
        and int(np.prod(got["global"][k])) == 16 * int(np.prod(
            got["params"][k])) for k in cut)
    if arch == "mamba2-2.7b":
        assert {"wz", "wx", "wdt", "A_log", "gate_norm", "w_out",
                "embed"} <= set(cut)
        assert {"wB", "conv_B", "ssm_norm"}.isdisjoint(cut)
    for k, shape in got["cache"].items():
        if k in ("length", "max_seq"):
            continue
        want = [g // (dp if c == "b" else 16 if c == "m" else 1)
                for g, c in zip(got["cache_global"][k], CACHE_CUTS[k])]
        assert shape == want, (arch, k)
    assert got["cache"].get("max_seq") == (
        256 if arch == "whisper-medium" else None)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b",
                                  "whisper-medium"])
def test_one_by_one_mesh_serves_bitwise_as_no_rules(arch):
    """On the (1, 1) mesh the serving path is today's: the same params,
    prefill logits, caches (no ``max_seq`` key) and greedy tokens bit for
    bit, at bf16 compute."""
    cfg = TC.get(arch).reduced()
    rules = ShardingRules(make_smoke_mesh("cpu"), fsdp=cfg.fsdp)
    assert registry.serving_tp(cfg, rules) is None
    params = registry.init_params(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    extra = ({"frames": torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                    generator=gen)}
             if cfg.family == "audio" else {})
    runs = []
    for r in (rules, None):
        p = serving_params(cfg, params, r)
        cache, logits = registry.prefill(p, cfg, tokens, 20, rules=r,
                                         **extra)
        step = build_decode_step(cfg, r)
        tok, out = registry.greedy_token(cfg, logits, r), [logits]
        for _ in range(4):
            tok, cache = step(p, cache, tok)
            out.append(tok)
        runs.append((p, cache, out))
    (pa, ca, oa), (pb, cb, ob) = runs
    assert all(torch.equal(pa[k], pb[k]) for k in pb)
    assert set(ca) == set(cb) and "max_seq" not in ca
    assert ca["length"] == cb["length"]
    assert all(torch.equal(ca[k], cb[k]) for k in cb if k != "length")
    assert all(torch.equal(a, b) for a, b in zip(oa, ob))
