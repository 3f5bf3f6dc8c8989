"""Serving over a (2, 2) ("data", "model") mesh of four gloo ranks on the
CPU against the reference's GSPMD prefill and decode on four forced host
devices; the flash-decode combine; and serving on a (1, 1) mesh bitwise
serving with no rules.

The reference runs once, in a module-scoped subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: its
``registry.prefill`` and a jitted ``registry.decode_step`` (and the
jitted ``build_decode_step``, whose tokens it holds equal) under
``ShardingRules(mesh, fsdp=cfg.fsdp)``, at f32 compute, batch 4, a 16-token
prompt and 4 greedy decode steps, on the six ``.reduced()`` cases of
``tests/_torch_tp_serve_workers.py``; and the CLI's greedy generation of
its own prompts on tinyllama's weights. It dumps to an ``.npz`` the
initial params, the inputs, the logits, the tokens and each device's
``addressable_shards`` of the cache after prefill and after the last
step. The port runs once on four gloo ranks
(``_torch_tp_serve_workers.tp_serve``) from those params.

Tolerances: logits to tests/test_torch_serve.py's rtol 1e-4 / atol 1e-5,
greedy tokens equal; each rank's cache block to rtol 1e-5 of its
device's shard, with that file's atol 1e-5 for the entries near zero (a
later layer's k and v come from the earlier layers' products, summed in
another order than XLA's).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_spawn import spawn
from _torch_tp_serve_workers import (BATCH, CASES, CLI, PROMPT, STEPS,
                                     case_cfg)

from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
from repro_torch.dist.tensor_parallel import flash_decode_combine
from repro_torch.models import layers as L
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
    for k in ("k", "v"):
        out[f"{tag}/{k}/spec"] = np.array(str(cache[k].sharding.spec))
        out[f"{tag}/{k}"] = np.asarray(cache[k])
        for s in cache[k].addressable_shards:
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
        if cfg.family == "vlm":
            extra["patch_embeds"] = rng.standard_normal(
                (BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32) \\
                * 0.5
        out[f"{tag}/tokens"] = tokens
        for k, v in extra.items():
            out[f"{tag}/{k}"] = v
        out[f"{tag}/generated"] = serve(cfg, rules, params, tokens, max_seq,
                                        extra, STEPS, tag)
        if tag == "dense":
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
            REFERENCE % (CASES, BATCH, PROMPT, STEPS, CLI)), path],
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return path


@pytest.fixture(scope="module")
def ref(ref_path):
    return dict(np.load(ref_path))


@pytest.fixture(scope="module")
def ranks(ref_path, tmp_path_factory):
    """What each of the four ranks saw (``tp_serve``'s dumps)."""
    d = tmp_path_factory.mktemp("ranks")
    spawn("_torch_tp_serve_workers", "tp_serve", WORLD, d, ref_path,
          str(d), timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _close(got, want, what, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what,
                               **tol)


@pytest.mark.parametrize("tag", list(CASES))
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


@pytest.mark.parametrize("tag", list(CASES))
def test_each_rank_holds_the_references_cache_block(ref, ranks, tag):
    """After prefill and after the last decode step, each rank's k and v
    equal the reference device's ``addressable_shards`` where max_seq
    divides 2: rows cut over data and positions over model, the
    reference's ``P(None, 'data', 'model')``. Where it does not, the
    spec's fallback keeps the positions whole and each rank holds every
    position of its dp rows (GSPMD lays that cache out over the kv heads
    instead, so it is held against the reference's whole cache). And
    each rank served from the reference device's shard shape of every
    param (cut over model, and over data for FSDP's wemb)."""
    max_seq = CASES[tag][2]
    cut = max_seq % 2 == 0
    for r, out in enumerate(ranks):
        assert out["coords"] == {"data": r // 2, "model": r % 2}
        for when in ("prefill", "decode"):
            cache = out[f"{tag}/{when}/cache"]
            assert cache["max_seq"] == max_seq
            assert cache["length"] == PROMPT + (
                case_cfg(tag).num_patches if tag == "vlm" else 0) + (
                STEPS if when == "decode" else 0)
            for k in ("k", "v"):
                if cut:
                    spec = str(ref[f"{tag}/{when}/{k}/spec"])
                    assert spec == "PartitionSpec(None, 'data', 'model')", \
                        spec
                    want = ref[f"{tag}/{when}/{k}/{r}"]
                    assert want.shape[2] == max_seq // 2
                else:
                    rows = BATCH // 2
                    want = ref[f"{tag}/{when}/{k}"][
                        :, r // 2 * rows:(r // 2 + 1) * rows]
                    assert want.shape[2] == max_seq
                assert tuple(cache[k].shape) == want.shape, (tag, k, r)
                _close(cache[k], want, f"{tag} {when} {k} rank {r}", CACHE)
        for k, shape in out[f"{tag}/param_shapes"].items():
            assert shape == tuple(ref[f"{tag}/param_shape/{k}/{r}"]), \
                (tag, k, r)


def test_serve_cli_generate_gives_the_references_tokens(ref, ranks):
    """``launch.serve.generate`` over the (2, 2) mesh (each dp rank its
    rows, the model ranks sharing them) on the reference's tinyllama
    weights gives the reference's greedy tokens for the CLI's prompts,
    on every rank."""
    want = ref["cli/tokens"].tolist()
    assert len(want) == CLI["batch"] and len(want[0]) == CLI["gen"]
    for out in ranks:
        assert out["cli/tokens"].tolist() == want


# -- one process -------------------------------------------------------------

def _decode_inputs(S: int, dtype):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(3, 1, 8, 16, generator=gen).to(dtype)
    k = torch.randn(3, S, 2, 16, generator=gen).to(dtype)
    v = torch.randn(3, S, 2, 16, generator=gen).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 7, 12, 24])
def test_flash_decode_combine_matches_attention_decode(dtype, length):
    """The partials of three 8-position blocks, combined in one process,
    against `attention_decode` over the whole 24-position cache: at
    length 1 and 7 the last block is wholly masked (length 1 the middle
    one too), and it adds exactly nothing (no NaN). f32 to rtol 1e-6 /
    atol 1e-6; bf16 within its rounding of p (cast per block in place of
    after the normalisation) and of the output."""
    q, k, v = _decode_inputs(24, dtype)
    want = L.attention_decode(q, k, v, length)
    parts = [L.attention_decode_partial(q, k[:, i:i + 8], v[:, i:i + 8],
                                        length - i) for i in (0, 8, 16)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    if length <= 8:
        assert (m[2] == L._NEG).all()
        assert (torch.exp(m[2] - m.amax(0)) == 0).all()
    got = flash_decode_combine(m, l, o, None)
    assert torch.isfinite(got).all()
    got = got.reshape(want.shape).to(dtype)
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **tol)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "arctic-480b",
                                  "llava-next-mistral-7b"])
def test_one_by_one_mesh_serves_bitwise_as_no_rules(arch):
    """On the (1, 1) mesh the serving path is today's: the same params,
    prefill logits, caches (no ``max_seq`` key) and greedy tokens bit for
    bit, at bf16 compute."""
    from repro_torch import configs as TC
    cfg = TC.get(arch).reduced()
    rules = ShardingRules(make_smoke_mesh("cpu"), fsdp=cfg.fsdp)
    assert registry.serving_tp(cfg, rules) is None
    params = registry.init_params(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    extra = ({"patch_embeds": torch.randn(2, cfg.num_patches, cfg.d_model,
                                          generator=gen)}
             if cfg.family == "vlm" else {})
    runs = []
    for r in (rules, None):
        p = serving_params(cfg, params, r)
        cache, logits = registry.prefill(p, cfg, tokens, 20 + (
            cfg.num_patches if cfg.family == "vlm" else 0), rules=r,
            **extra)
        step = build_decode_step(cfg, r)
        tok, out = registry.greedy_token(cfg, logits, r), [logits]
        for _ in range(4):
            tok, cache = step(p, cache, tok)
            out.append(tok)
        runs.append((p, cache, out))
    (pa, ca, oa), (pb, cb, ob) = runs
    assert all(torch.equal(pa[k], pb[k]) for k in pb)
    assert set(ca) == set(cb) == {"k", "v", "length"}
    assert ca["length"] == cb["length"]
    assert torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"])
    assert all(torch.equal(a, b) for a, b in zip(oa, ob))
