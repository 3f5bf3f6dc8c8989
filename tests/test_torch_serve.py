"""The port's serving path against the JAX package's, on the CPU: the
decode and prefill attention cores, and prefill, the caches and greedy
decode of the dense (swiglu, and gelu2 with MQA), moe and vlm families,
the registry, the serving steps, the CLI and the cache's conversion.
tests/test_torch_serve_families.py holds the ssm, hybrid and audio
families with the same helpers.

Every family runs at ``.reduced()`` from the JAX package's initial
weights (f32, carried over by ``repro_torch.convert``) and the same numpy
inputs. Tolerances at f32 compute: attention cores to rtol 1e-5 (atol
1e-6); prefill logits and every cache leaf, and four decode steps from
the reference's own cache carried over, to rtol 1e-4 / atol 1e-5 (the two
frameworks sum in other orders), with identical greedy tokens; the
port's prefill + decode against its own forward to rtol 1e-4 / atol 1e-4.
At bf16 (tinyllama): logits within 3e-2 of the reference's largest |logit|
(bf16 rounds at other places in each) and the same first greedy token.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as C
from repro.dist.sharding import ShardingRules, make_smoke_mesh
from repro.models import layers as JL
from repro.models import registry as jreg
from repro.train import step as jstep

from repro_torch import configs as TC
from repro_torch.configs.base import SHAPES
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,
                                 to_numpy, to_tensor)
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import registry as treg
from repro_torch.train import step as tstep

torch.set_num_threads(2)   # leave cores to the other test workers

RNG = np.random.default_rng(19)

# one config per serving family (granite: gelu2 and MQA 4:1 once reduced)
SERVING = {"dense": "tinyllama-1.1b", "dense-gelu2": "granite-34b",
           "moe": "arctic-480b", "ssm": "mamba2-2.7b",
           "hybrid": "zamba2-1.2b", "audio": "whisper-medium",
           "vlm": "llava-next-mistral-7b"}
PROMPT, STEPS, BATCH = 12, 4, 2
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def rules():
    return ShardingRules(make_smoke_mesh())


def _configs(family, **over):
    arch = SERVING[family]
    return C.get(arch).reduced(**over), TC.get(arch).reduced(**over)


def _extra(cfg, b, seed=0):
    """The family's extra prefill input (frames or patch embeddings) as
    numpy f32, from its own generator."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.5}
    if cfg.family == "vlm":
        return {"patch_embeds": rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.5}
    return {}


def _max_seq(cfg, prompt, steps):
    return prompt + steps + (cfg.num_patches if cfg.family == "vlm" else 0)


def _jax_params(jcfg, rules, seed=3):
    jparams = jreg.init_params(jax.random.PRNGKey(seed), jcfg, rules)
    return jparams, {k: to_tensor(np.asarray(v)) for k, v in jparams.items()}


def _assert_cache_close(port: dict, ref: dict, what: str):
    assert set(port) == set(ref), what
    assert port["length"] == int(ref["length"]), what
    for k, v in ref.items():
        if k == "length":
            continue
        want = np.asarray(v)
        got = port[k]
        assert tuple(got.shape) == want.shape, (what, k)
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, \
            (what, k)
        np.testing.assert_allclose(to_numpy(got), want.astype(np.float32),
                                   err_msg=f"{what}: {k}", **TOL)


def check_serving_matches_jax(family, rules, prompt=PROMPT, steps=STEPS,
                              seed=1):
    """Prefill of both packages from the same weights and inputs (logits
    and every cache leaf), then ``steps`` greedy decode steps of the port
    from the reference's carried-over cache against the reference's own
    (logits, caches and tokens)."""
    jcfg, tcfg = _configs(family, compute_dtype="float32")
    jparams, tparams = _jax_params(jcfg, rules)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size,
                                                (BATCH, prompt))
    extra = _extra(jcfg, BATCH)
    max_seq = _max_seq(jcfg, prompt, steps)

    jcache, jlogits = jreg.prefill(
        jparams, jcfg, rules, jnp.asarray(toks, jnp.int32), max_seq,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    tcache, tlogits = treg.prefill(
        tparams, tcfg, torch.as_tensor(toks), max_seq,
        **{k: torch.as_tensor(v) for k, v in extra.items()})
    assert tuple(tlogits.shape) == (BATCH, 1, jcfg.vocab_size)
    np.testing.assert_allclose(to_numpy(tlogits), np.asarray(jlogits),
                               err_msg="prefill logits", **TOL)
    _assert_cache_close(tcache, jcache, "prefill cache")

    jdecode = jax.jit(lambda p, c, t: jreg.decode_step(p, jcfg, rules, c, t))
    port = cache_from_numpy({k: np.asarray(v) for k, v in jcache.items()},
                            device="cpu")
    jtok = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tlogits[:, -1], dim=-1)[:, None]
    assert to_numpy(ttok).tolist() == np.asarray(jtok).tolist()
    for i in range(steps):
        jlogits, jcache = jdecode(jparams, jcache, jtok)
        tlogits, port = treg.decode_step(tparams, tcfg, port,
                                         torch.as_tensor(np.array(jtok)))
        np.testing.assert_allclose(to_numpy(tlogits), np.asarray(jlogits),
                                   err_msg=f"decode {i} logits", **TOL)
        _assert_cache_close(port, jcache, f"decode {i} cache")
        jtok = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tlogits[:, -1], dim=-1)[:, None]
        assert to_numpy(ttok).tolist() == np.asarray(jtok).tolist(), i
    assert port["length"] == prompt + steps + (
        jcfg.num_patches if jcfg.family == "vlm" else 0)


def port_forward(params, cfg, toks, extra):
    """The port's full forward logits at every token position."""
    mod = treg.family_module(cfg)
    if cfg.family in ("audio", "vlm"):
        out = mod.forward(params, cfg, toks, *extra.values())
    else:
        out = mod.forward(params, cfg, toks)
    return out[0] if cfg.family == "moe" else out


def check_decode_matches_forward(family, prompt=PROMPT, steps=STEPS, seed=2,
                                **over):
    """The port's prefill(tokens[:t]) and then decode of tokens t, t+1,
    ... give its forward's logits at positions t-1, t, ... (teacher
    forcing), at f32."""
    tcfg = TC.get(SERVING[family]).reduced(compute_dtype="float32", **over)
    params = treg.init_params(tcfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, tcfg.vocab_size, (BATCH, prompt + steps)))
    extra = {k: torch.as_tensor(v) for k, v in _extra(tcfg, BATCH).items()}
    with torch.no_grad():
        full = port_forward(params, tcfg, toks, extra)
    cache, logits = treg.prefill(params, tcfg, toks[:, :prompt],
                                 _max_seq(tcfg, prompt, steps), **extra)
    np.testing.assert_allclose(to_numpy(logits[:, -1]),
                               to_numpy(full[:, prompt - 1]),
                               rtol=1e-4, atol=1e-4)
    for i in range(steps):
        logits, cache = treg.decode_step(params, tcfg, cache,
                                         toks[:, prompt + i:prompt + i + 1])
        np.testing.assert_allclose(to_numpy(logits[:, -1]),
                                   to_numpy(full[:, prompt + i]),
                                   rtol=1e-4, atol=1e-4, err_msg=str(i))


def prefill_flash_calls(cfg) -> int:
    """Flash calls of one prefill: one per attention layer; the hybrid's
    shared-block calls; whisper's encoder layers and its decoder's self-
    and cross-attention; none for the ssm."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return 0 if cfg.family == "ssm" else cfg.num_layers


# -- attention cores ---------------------------------------------------------

@pytest.mark.parametrize("length", [None, 5, 9])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4), (6, 1)])
def test_attention_decode_matches_jax(h, kv, length):
    b, S, d = 2, 9, 16
    q = RNG.standard_normal((b, 1, h, d)).astype(np.float32)
    k = RNG.standard_normal((b, S, kv, d)).astype(np.float32)
    v = RNG.standard_normal((b, S, kv, d)).astype(np.float32)
    want = JL.attention_decode(jnp.asarray(q), JL.expand_kv(jnp.asarray(k), h),
                               JL.expand_kv(jnp.asarray(v), h), length=length)
    got = TL.attention_decode(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), length=length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("q_chunk", [4, 8, 32])
@pytest.mark.parametrize("sq,skv,causal", [(16, 16, True), (16, 16, False),
                                           (8, 24, False), (24, 8, False)])
def test_attention_prefill_matches_qchunk(sq, skv, causal, q_chunk):
    b, h, kv, d = 2, 4, 2, 16
    q = RNG.standard_normal((b, sq, h, d)).astype(np.float32)
    k = RNG.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = RNG.standard_normal((b, skv, kv, d)).astype(np.float32)
    want = JL.attention_qchunk(jnp.asarray(q), JL.expand_kv(jnp.asarray(k), h),
                               JL.expand_kv(jnp.asarray(v), h),
                               causal=causal, q_chunk=q_chunk)
    got = TL.attention_prefill(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- families: dense, moe, vlm -------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "dense-gelu2", "moe", "vlm"])
def test_serving_matches_jax(family, rules):
    check_serving_matches_jax(family, rules)


@pytest.mark.parametrize("family", ["dense", "dense-gelu2", "moe", "vlm"])
def test_decode_matches_forward(family):
    # moe: a capacity of every token, so the forward over the whole
    # sequence drops none, as decode (b tokens, capacity 4) drops none;
    # with drops the two are different functions
    over = dict(capacity_factor=2.0) if family == "moe" else {}
    check_decode_matches_forward(family, **over)


def test_bf16_serving_follows_jax(rules):
    """tinyllama at bf16 compute from f32 params, as the reference serves:
    prefill and one decode step's logits near the reference's, the same
    greedy tokens; casting the weights once up front
    (``serving_params``) gives bitwise the logits of casting at each use."""
    jcfg, tcfg = _configs("dense")
    jparams, tparams = _jax_params(jcfg, rules)
    toks = RNG.integers(0, jcfg.vocab_size, (BATCH, PROMPT))
    jcache, jlogits = jreg.prefill(jparams, jcfg, rules,
                                   jnp.asarray(toks, jnp.int32), PROMPT + 2)
    tcache, tlogits = treg.prefill(tparams, tcfg, torch.as_tensor(toks),
                                   PROMPT + 2)
    _, cast_logits = treg.prefill(tstep.serving_params(tcfg, tparams), tcfg,
                                  torch.as_tensor(toks), PROMPT + 2)
    assert torch.equal(cast_logits, tlogits)
    assert tlogits.dtype == torch.bfloat16
    for step in range(2):
        want = np.asarray(jlogits, np.float32)
        err = np.abs(to_numpy(tlogits) - want).max()
        assert err <= 3e-2 * np.abs(want).max(), (step, err)
        jtok = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        ttok = torch.argmax(tlogits[:, -1], dim=-1)[:, None]
        assert to_numpy(ttok).tolist() == np.asarray(jtok).tolist(), step
        jlogits, jcache = jreg.decode_step(jparams, jcfg, rules, jcache, jtok)
        tlogits, tcache = treg.decode_step(tparams, tcfg, tcache, ttok)


def test_serving_params_keep_f32_where_serving_reads_f32():
    for arch in ("zamba2-1.2b", "whisper-medium"):
        cfg = TC.get(arch).reduced()
        params = treg.init_params(cfg, seed=0, device="cpu")
        cast = tstep.serving_params(cfg, params)
        for k, p in cast.items():
            f32 = k.endswith("norm") or k in ("dt_bias", "A_log")
            assert p.dtype == (torch.float32 if f32 else torch.bfloat16), k


def test_prefill_attention_goes_through_the_flash_wrapper(monkeypatch):
    """Every prefill attention call is ``ops.flash_attention`` (the
    wrapper of the Hopper kernel), at the counts the card checks; decode
    makes none."""
    calls = []
    flash = ops.flash_attention

    def counting(q, k, v, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return flash(q, k, v, causal)
    monkeypatch.setattr(ops, "flash_attention", counting)
    for family in SERVING:
        cfg = TC.get(SERVING[family]).reduced(compute_dtype="float32")
        params = treg.init_params(cfg, seed=0, device="cpu")
        extra = {k: torch.as_tensor(v) for k, v in _extra(cfg, 1).items()}
        calls.clear()
        cache, logits = treg.prefill(
            params, cfg, torch.zeros((1, 8), dtype=torch.int64),
            _max_seq(cfg, 8, 2), **extra)
        assert len(calls) == prefill_flash_calls(cfg), family
        calls.clear()
        treg.decode_step(params, cfg, cache, torch.zeros((1, 1),
                                                         dtype=torch.int64))
        assert calls == [], family


# -- registry, steps, conversion ---------------------------------------------

@pytest.mark.parametrize("family", list(SERVING))
def test_cache_specs_and_init_cache_match_jax(family, rules):
    jcfg, tcfg = _configs(family)
    jspecs = jreg.cache_specs(jcfg, 3, 20)
    tspecs = treg.cache_specs(tcfg, 3, 20)
    assert {k: (s.shape, s.logical, s.init, s.dtype)
            for k, s in tspecs.items()} == \
        {k: (s.shape, s.logical, s.init, s.dtype) for k, s in jspecs.items()}
    jcache = jreg.init_cache(jcfg, rules, 3, 20)
    tcache = treg.init_cache(tcfg, 3, 20, device="cpu")
    assert tcache["length"] == int(jcache["length"]) == 0
    for k, v in jcache.items():
        if k != "length":
            assert tuple(tcache[k].shape) == v.shape
            assert not tcache[k].any()


def test_vit_has_no_serving_path(rules):
    jcfg, tcfg = (dataclasses.replace(c.get("vit-h-14").reduced(),
                                      family="vit") for c in (C, TC))
    with pytest.raises(AttributeError):
        jreg.prefill(None, jcfg, rules, None, 8)
    for fn, args in ((treg.prefill, (None, tcfg, None, 8)),
                     (treg.decode_step, (None, tcfg, {}, None)),
                     (treg.cache_specs, (tcfg, 1, 8))):
        with pytest.raises(AttributeError):
            fn(*args)


def test_vlm_prefill_raises_when_the_cache_cannot_hold_the_patches():
    cfg = TC.get("llava-next-mistral-7b").reduced()
    params = treg.init_params(cfg, seed=0, device="cpu")
    patches = torch.zeros((1, cfg.num_patches, cfg.d_model))
    with pytest.raises(ValueError, match="max_seq"):
        treg.prefill(params, cfg, torch.zeros((1, 8), dtype=torch.int64),
                     8 + 4, patch_embeds=patches)


@pytest.mark.parametrize("family", ["dense", "vlm"])
def test_build_steps_match_jax(family, rules):
    """The serving steps built from a SHAPES cell at a reduced length:
    prefill sizes the cache to the shape's seq_len, and greedy decode
    gives the reference's tokens (int64 (b, 1) in the port)."""
    jcfg, tcfg = _configs(family, compute_dtype="float32")
    jparams, tparams = _jax_params(jcfg, rules)
    seq = 24
    jshape = dataclasses.replace(C.SHAPES["prefill_32k"], seq_len=seq)
    tshape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=seq)
    toks = RNG.integers(0, jcfg.vocab_size, (BATCH, 8))
    extra = _extra(jcfg, BATCH)
    jcache, jlogits = jstep.build_prefill_step(jcfg, jshape, rules)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  **{k: jnp.asarray(v) for k, v in extra.items()}})
    tcache, tlogits = tstep.build_prefill_step(tcfg, tshape)(
        tparams, {"tokens": torch.as_tensor(toks),
                  **{k: torch.as_tensor(v) for k, v in extra.items()}})
    assert tcache["k"].shape[2] == seq
    _assert_cache_close(tcache, jcache, "prefill step")
    jserve = jstep.build_decode_step(jcfg, rules)
    tserve = tstep.build_decode_step(tcfg)
    jtok = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tlogits[:, -1], dim=-1)[:, None]
    for _ in range(3):
        jtok, jcache = jserve(jparams, jcache, jtok)
        ttok, tcache = tserve(tparams, tcache, ttok)
        assert ttok.dtype == torch.int64 and tuple(ttok.shape) == (BATCH, 1)
        assert ttok.numpy().tolist() == np.asarray(jtok).tolist()
    with pytest.raises(ValueError):
        tstep.build_decode_step(tcfg, greedy=False)


def test_cache_round_trips_through_numpy():
    cfg = TC.get("zamba2-1.2b").reduced()
    cache = treg.init_cache(cfg, 2, 8, device="cpu")
    cache["state"].normal_()
    cache["attn_k"].normal_()
    cache["length"] = 5
    out = cache_to_numpy(cache)
    assert isinstance(out["length"], np.int32) and out["length"] == 5
    assert out["attn_k"].dtype == np.float32      # bf16 widened
    back = cache_from_numpy(out, device="cpu")
    assert back["length"] == 5 and isinstance(back["length"], int)
    assert torch.equal(back["state"], cache["state"])
    assert torch.equal(back["attn_k"].to(torch.bfloat16), cache["attn_k"])


# -- the CLI -------------------------------------------------------------------

CLI_KEYS = {"arch", "batch", "prompt_len", "generated", "prefill_s",
            "decode_s", "decode_tok_per_s", "sample_tokens"}


def _serve(capsys, *args):
    from repro_torch.launch import serve
    serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4", *args])
    return json.loads(capsys.readouterr().out)


def test_serve_cli_prints_the_reference_keys(monkeypatch, capsys):
    from repro.launch import serve as jserve
    out = _serve(capsys)
    monkeypatch.setattr(sys, "argv", ["serve", "--reduced", "--batch", "2",
                                      "--prompt-len", "8", "--gen", "4"])
    jserve.main()
    ref = json.loads(capsys.readouterr().out)
    assert set(out) == set(ref) == CLI_KEYS
    assert out["arch"] == ref["arch"] == "tinyllama-1.1b-smoke"
    assert out["generated"] == 4 and len(out["sample_tokens"]) == 4
    assert all(0 <= t < 256 for t in out["sample_tokens"])
    assert out["decode_tok_per_s"] > 0


def test_serve_cli_is_deterministic_for_a_seed(capsys):
    a = _serve(capsys, "--seed", "3", "--arch", "arctic-480b")
    b = _serve(capsys, "--seed", "3", "--arch", "arctic-480b")
    assert a["sample_tokens"] == b["sample_tokens"]


def test_serve_cli_serves_a_vlm(capsys):
    out = _serve(capsys, "--arch", "llava-next-mistral-7b",
                 "--prompt-len", "16")
    assert out["arch"] == "llava-next-mistral-7b-smoke"
    assert len(out["sample_tokens"]) == 4


def test_reference_serve_cli_cannot_serve_a_vlm(monkeypatch):
    """A known fault of the reference, recorded in ROADMAP §3 and not
    fixed there: its CLI sizes the cache prompt + gen, and the vlm's
    prefill then pads by a negative amount to hold the patches. The port
    sizes it patches + prompt + gen (test above)."""
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "llava-next-mistral-7b", "--reduced",
        "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    with pytest.raises(ValueError):
        jserve.main()


def test_serve_cli_needs_cuda_unless_cpu_is_asked_for():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced"])
