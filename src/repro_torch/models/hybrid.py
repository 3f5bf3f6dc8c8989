"""zamba2-style hybrid, the port of ``repro.models.hybrid``: a Mamba2
backbone and ONE shared attention block called after every ``attn_every``
SSM layers; training, prefill and decode.

Each call of the shared block sees other activations, so in serving each
has its own KV cache slot: ``attn_k``/``attn_v`` are (n_shared_calls, b,
S, kv, hd), beside the SSM family's state and conv caches.

The shared block is one set of weights (unstacked ``shared_*`` leaves), so
its gradient is the sum over its calls; each call is recomputed in the
backward on its own when ``cfg.remat``, as ``jax.checkpoint`` per call
does there.

Training and serving take ``rules``: on a mesh whose ``model`` extent is
above 1 the SSM segments run over this rank's SSD heads
(`repro_torch.models.ssm`) and each call of the shared block runs the
dense block tensor-parallel on this rank's slices of the ``shared_*``
leaves; ``attn_k`` and ``attn_v`` are cut on ``kv_seq`` (each model rank
one block of every call's positions, `transformer.PrefillCache`), and
the cache keeps ``max_seq``.
"""
from __future__ import annotations

import itertools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.dist import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import ssm as M
from repro_torch.models import transformer as T
from repro_torch.models.common import ParamSpec


def n_shared_calls(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def segments(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """List of (start, end, attn_after) covering all ssm layers."""
    out, start = [], 0
    while start < cfg.num_layers:
        end = min(start + cfg.attn_every, cfg.num_layers)
        out.append((start, end, end - start == cfg.attn_every))
        start = end
    return out


def param_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "embed": ParamSpec((v, d), ("vocab", "wemb"), init="normal"),
        "final_norm": ParamSpec((d,), ("unsharded",), init="ones"),
        "unembed": ParamSpec((d, v), ("wemb", "vocab")),
    }
    specs.update(M.layer_param_specs(cfg, cfg.num_layers))
    # one shared transformer block (unstacked)
    specs.update(T.layer_param_specs(cfg, 1, prefix="shared_", stacked=False))
    return specs


def _shared_lp(params: dict) -> dict:
    return {k[len("shared_"):]: v for k, v in params.items()
            if k.startswith("shared_")}


def _ssm_stacked(params: dict) -> dict:
    return {k: params[k] for k in M.SSM_LAYER_KEYS if k in params}


def tp_context(cfg: ModelConfig, rules):
    """The tensor-parallel context of ``rules`` for ``cfg``'s leaves, the
    shared block's under the names its dense block reads (None without
    rules or at ``model`` extent 1)."""
    specs = param_specs(cfg)
    return M.checked_heads(cfg, TP.context(rules, {**specs,
                                                   **_shared_lp(specs)}))


def backbone(x, params: dict, cfg: ModelConfig, positions, tp=None):
    """The SSM segments, each followed by a call of the shared block when
    it is ``attn_every`` layers long; with ``tp``, over ``model``."""
    stacked = _ssm_stacked(params)
    shared = _shared_lp(params)

    def attn_call(x):
        return T.dense_block(x, shared, cfg, positions, tp=tp)

    for (s0, s1, attn_after) in segments(cfg):
        seg = {k: v[s0:s1] for k, v in stacked.items()}
        x = T.run_layers(x, seg,
                         lambda x, lp: M.mamba_block(x, lp, cfg, tp=tp),
                         cfg.remat)
        if attn_after:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(attn_call, x, use_reentrant=False)
            else:
                x = attn_call(x)
    return x


def forward(params: dict, cfg: ModelConfig, tokens, tp=None):
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = backbone(x, params, cfg, positions, tp)
    return T.final_logits(x, params, cfg, tp)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, rules=None):
    """The mean loss of this rank's rows; under ``rules`` with a ``model``
    extent above 1, tensor-parallel."""
    tp = tp_context(cfg, rules)
    return L.xent_loss(forward(params, cfg, batch["tokens"], tp),
                       batch["labels"], T.vocab_tp(tp))


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    specs = M.cache_specs(cfg, batch, max_seq)
    kv, hd, nsh = cfg.num_kv_heads, cfg.head_dim, n_shared_calls(cfg)
    shape = (nsh, batch, max_seq, kv, hd)
    logical = (None, "batch", "kv_seq", None, None)
    specs["attn_k"] = ParamSpec(shape, logical, init="zeros",
                                dtype=cfg.compute_dtype)
    specs["attn_v"] = ParamSpec(shape, logical, init="zeros",
                                dtype=cfg.compute_dtype)
    return specs


def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int,
            rules=None):
    """The prompt through the segments and the shared block's calls: each
    layer's SSM state and conv tails, each call's k and v (this rank's
    block of positions over ``model``)."""
    b, s = tokens.shape
    tp = tp_context(cfg, rules)
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    layers = T.serving_layers(_ssm_stacked(params))
    shared = _shared_lp(params)
    fill = T.PrefillCache(x, cfg, max_seq, rules, tp,
                          layers=n_shared_calls(cfg))
    entries = []
    for (s0, s1, attn_after) in segments(cfg):
        x, seg = M.prefill_layers(x, itertools.islice(layers, s1 - s0), cfg,
                                  tp)
        entries += seg
        if attn_after:
            x, (k, v) = T.dense_block(x, shared, cfg, positions,
                                      prefill=True, tp=tp)
            fill.add(k, v)
    cache = M.ssm_cache(entries, s)
    cache.update(attn_k=fill.k, attn_v=fill.v, **fill.extra)
    return cache, T.final_logits(x[:, -1:], params, cfg, tp)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token,
                rules=None):
    tp = tp_context(cfg, rules)
    x = L.embed_tokens(params["embed"], token,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    layers = T.serving_layers(_ssm_stacked(params))
    shared = _shared_lp(params)
    pos = cache["length"]
    first = T.cache_first(cache, tp, "attn_k")
    call = 0
    for (s0, s1, attn_after) in segments(cfg):
        x = M.decode_layers(x, itertools.islice(layers, s1 - s0), cache, s0,
                            cfg, tp)
        if attn_after:
            x = T.decode_block(x, shared, cache["attn_k"][call],
                               cache["attn_v"][call], pos, cfg, tp, first)
            call += 1
    return T.final_logits(x, params, cfg, tp), dict(cache, length=pos + 1)
