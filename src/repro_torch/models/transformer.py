"""Dense decoder-only LM (llama/glm/granite/tinyllama family), the port of
``repro.models.transformer``: the training forward, prefill and
single-token decode against a KV cache, and the attention block, decode
block and layer stack every other family with attention builds on.

Per-layer weights are stacked ``(L, ...)`` leaves under the JAX package's
names, so the two packages' bucket layouts are equal. The forward loops
over the layers; with ``cfg.remat`` each layer is recomputed in the
backward (``torch.utils.checkpoint``), as ``jax.checkpoint`` does there.
Every family's training path runs its stacks through `run_layers`, which
is where an FSDP step gathers each layer's weights
(`repro_torch.dist.sharding.gather_per_layer`).

Training and serving take ``rules``: on a mesh whose ``model`` extent is
above 1 the layers run tensor-parallel (`repro_torch.dist
.tensor_parallel`) on this rank's slices of the model-cut leaves; with no
rules, or ``model`` of extent 1, they are the plain whole layers. The
other families build on these blocks over ``model`` too (the hybrid's
shared block, whisper's encoder and decoder, the ViT).

Serving takes the f32 params as the reference's does and casts at each
use. A cache is a dict of tensors and ``length``, a host int: the number
of positions written, so writing at ``pos`` and masking cost no device
sync. ``decode_step`` writes the new position into the cache's tensors in
place (the reference's serving loop donates its cache) and returns the
dict with ``length`` advanced. Over ``model`` the cache is cut on
``kv_seq`` where the spec cuts it (``max_seq`` divisible by m): model
rank r holds positions [r S/m, (r + 1) S/m) of every layer, kv head and
this dp rank's rows, and the cache keeps ``max_seq``, a host int, so
decode knows its block (`cache_first`). Prefill writes into each block
the prompt positions that fall in it; decode writes the new token's k
and v on the rank that holds ``pos`` and combines every rank's partial
attention over its block; prefill's and decode's logits are this rank's
vocab columns where the vocab is cut. The layer loops gather an FSDP
leaf's slice just before its layer (`serving_layers`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.dist import tensor_parallel as TP
from repro_torch.dist.sharding import P, layer_gathers
from repro_torch.models import layers as L
from repro_torch.models.common import ParamSpec

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
              "w_gate", "w_up", "w_down")


def layer_param_specs(cfg: ModelConfig, n_layers: int, prefix: str = "",
                      stacked: bool = True) -> dict:
    """Per-layer attention+MLP weights, optionally stacked ``(n_layers,
    ...)``; ``prefix`` names them (``enc_``, ``dec_``, ``shared_``)."""
    h, kv, hd, d, f = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.d_model, cfg.d_ff)
    lead = (n_layers,) if stacked else ()
    lax_ = ("layers",) if stacked else ()

    def S(shape, logical, **kw):
        return ParamSpec(lead + shape, lax_ + logical, **kw)
    specs = {
        prefix + "attn_norm": S((d,), ("unsharded",), init="ones"),
        prefix + "wq": S((d, h * hd), ("wemb", "heads")),
        prefix + "wk": S((d, kv * hd), ("wemb", "kv_heads")),
        prefix + "wv": S((d, kv * hd), ("wemb", "kv_heads")),
        prefix + "wo": S((h * hd, d), ("heads", "wemb")),
        prefix + "mlp_norm": S((d,), ("unsharded",), init="ones"),
        prefix + "w_up": S((d, f), ("wemb", "ff")),
        prefix + "w_down": S((f, d), ("ff", "wemb")),
    }
    if cfg.mlp == "swiglu":
        specs[prefix + "w_gate"] = S((d, f), ("wemb", "ff"))
    return specs


def param_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "embed": ParamSpec((v, d), ("vocab", "wemb"), init="normal"),
        "final_norm": ParamSpec((d,), ("unsharded",), init="ones"),
    }
    specs.update(layer_param_specs(cfg, cfg.num_layers))
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((d, v), ("wemb", "vocab"))
    return specs


def tp_context(cfg: ModelConfig, rules):
    """The tensor-parallel context of ``rules`` for ``cfg``'s leaves (None
    without rules or at ``model`` extent 1)."""
    return TP.context(rules, param_specs(cfg))


def attn_block(x, lp: dict, cfg: ModelConfig, positions, *, causal=True,
               prefill=False, tp=None):
    """Pre-norm attention with its residual: the flash kernel forward
    (top-left causal or none) and the recompute-from-lse backward; with
    ``tp``, over ``model`` (`layers.attention_tp`). With ``prefill`` the
    forward alone, returning ``(x, (k, v))`` with k, v at every kv head
    and position (the cache's entries)."""
    b, s, _ = x.shape
    xn = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    if tp is not None and prefill:
        y, kv = L.attention_tp(xn, lp, cfg, positions, causal, tp,
                               prefill=True)
        return x + y, kv
    if tp is not None:
        return x + L.attention_tp(xn, lp, cfg, positions, causal, tp)
    q, k, v = L.attn_project_qkv(xn, lp, cfg, positions)
    if prefill:
        o = L.attention_prefill(q, k, v, causal)
    else:
        o = L.FlashAttention.apply(q, k, v, causal)
    x = x + o.reshape(b, s, -1) @ lp["wo"].to(o.dtype)
    return (x, (k, v)) if prefill else x


def dense_block(x, lp: dict, cfg: ModelConfig, positions, *, causal=True,
                prefill=False, tp=None):
    """Attention + MLP (``cfg.mlp``) with pre-norms and residuals; with
    ``prefill``, ``(x, (k, v))`` as ``attn_block`` gives them; with
    ``tp``, both over ``model``."""
    out = attn_block(x, lp, cfg, positions, causal=causal, prefill=prefill,
                     tp=tp)
    x, kv = out if prefill else (out, None)
    xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    x = x + L.mlp(xn, lp, cfg, tp)
    return (x, kv) if prefill else x


def decode_attn(x, lp: dict, kc, vc, pos: int, cfg: ModelConfig, tp=None,
                first=None):
    """The attention half of a decode block: x (b, 1, d) at position
    ``pos``; its k, v are written into one layer's caches kc, vc (b, S, kv,
    hd) at ``pos`` in place, and it attends over positions < pos + 1. With
    ``tp``, over ``model`` (`layers.attention_decode_tp`; ``first`` the
    global position of this rank's cache block, None where the cache is
    whole)."""
    b = x.shape[0]
    xn = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    if tp is not None:
        return x + L.attention_decode_tp(xn, lp, kc, vc, pos, cfg, tp, first)
    positions = torch.full((b, 1), pos, device=x.device)
    q, k, v = L.attn_project_qkv(xn, lp, cfg, positions)
    kc[:, pos] = k[:, 0]
    vc[:, pos] = v[:, 0]
    o = L.attention_decode(q, kc, vc, length=pos + 1)
    return x + o.reshape(b, 1, -1) @ lp["wo"].to(o.dtype)


def decode_block(x, lp: dict, kc, vc, pos: int, cfg: ModelConfig, tp=None,
                 first=None):
    """Single-token dense block against one layer's KV cache (written in
    place). x: (b, 1, d) -> (b, 1, d). With ``tp``, over ``model``."""
    x = decode_attn(x, lp, kc, vc, pos, cfg, tp, first)
    xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + L.mlp(xn, lp, cfg, tp)


def layers_of(stacked: dict) -> list:
    """Each layer's slice of the stacked leaves, as a dict per layer. The
    leaves are unbound once, so the backward stacks the per-layer grads in
    one pass."""
    keys = list(stacked)
    per_layer = [stacked[k].unbind(0) for k in keys]
    return [dict(zip(keys, ws)) for ws in zip(*per_layer)]


def serving_layers(stacked: dict):
    """Each layer's slice of the stacked leaves, as `layers_of` gives
    them, for a serving loop: under the step's `gather_per_layer`, an
    FSDP leaf's slice gathered in the compute dtype just before its layer
    runs (`layer_gathers`), every other slice as it is. A generator, so
    that one layer's gathered weights are made at a time."""
    keys = list(stacked)
    gathers = layer_gathers(stacked)
    for lp in layers_of(stacked):
        yield {k: g(lp[k]) for k, g in zip(keys, gathers)}


def run_layers(x, stacked: dict, body, remat: bool):
    """``x = body(x, lp)`` for each layer's slice ``lp`` of the stacked
    leaves (a scan over their leading axis), recomputed in the backward
    when ``remat`` (one ``jax.checkpoint``-ed scan step each). Under the
    step's `gather_per_layer`, an FSDP leaf's slice is gathered inside
    the recomputed function, so the gather runs again in the recompute
    and no gathered weight is kept between the two."""
    keys = list(stacked)
    gathers = layer_gathers(stacked)

    def one_layer(x, *ws):
        return body(x, {k: g(w) for k, g, w in zip(keys, gathers, ws)})

    for lp in layers_of(stacked):
        if remat and torch.is_grad_enabled():
            x = checkpoint(one_layer, x, *lp.values(), use_reentrant=False)
        else:
            x = one_layer(x, *lp.values())
    return x


def decoder_stack(x, params: dict, cfg: ModelConfig, positions, *,
                  causal=True, block_fn=dense_block, tp=None):
    """The layer loop over the stacked keys present (gelu2 has no
    ``w_gate``); returns the final hidden states in the compute dtype.
    With ``tp`` the dense block runs tensor-parallel over ``model``."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    stacked = {k: params[k] for k in LAYER_KEYS if k in params}
    kw = {} if tp is None else {"tp": tp}
    return run_layers(
        x, stacked,
        lambda x, lp: block_fn(x, lp, cfg, positions, causal=causal,
                               **kw).to(cd),
        cfg.remat)


def vocab_tp(tp):
    """``tp`` where the vocab is cut over ``model`` (``embed`` and
    ``unembed`` share the vocab dim, so one leaf tells), else None: the
    divisibility fallback leaves the vocab whole on every rank."""
    return tp if tp is not None and tp.is_cut("embed") else None


def final_logits(x, params: dict, cfg: ModelConfig, tp=None):
    """The final norm and the logits (through the tied embedding where
    ``cfg.tie_embeddings``); with ``tp`` cutting the vocab over
    ``model``, this rank's vocab columns."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"])
    return L.lm_logits(x, unembed, vocab_tp(tp))


def forward(params: dict, cfg: ModelConfig, tokens, tp=None):
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype], vocab_tp(tp))
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = decoder_stack(x, params, cfg, positions, tp=tp)
    return final_logits(x, params, cfg, tp)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, rules=None):
    """The mean loss of this rank's rows; under ``rules`` with a ``model``
    extent above 1, tensor-parallel."""
    tp = tp_context(cfg, rules)
    return L.xent_loss(forward(params, cfg, batch["tokens"], tp),
                       batch["labels"], vocab_tp(tp))


# -- KV cache ----------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (cfg.num_layers, batch, max_seq, kv, hd)
    logical = ("layers", "batch", "kv_seq", None, None)
    return {
        "k": ParamSpec(shape, logical, init="zeros", dtype=cfg.compute_dtype),
        "v": ParamSpec(shape, logical, init="zeros", dtype=cfg.compute_dtype),
    }


def cache_block(rules, tp, max_seq: int) -> tuple[int, int]:
    """``(first, n)``: the positions [first, first + n) of a cache of
    ``max_seq`` that this rank holds: its block of max_seq / m where
    ``tp`` is given and the spec cuts ``kv_seq`` over ``model``, else
    every position (the divisibility fallback keeps the cache whole)."""
    if tp is not None and rules.spec("kv_seq", dims=(max_seq,)) == P(
            "model"):
        n = max_seq // tp.size
        return tp.rank * n, n
    return 0, max_seq


def cache_first(cache: dict, tp, key: str = "k"):
    """The global position of this rank's block of the positions of
    ``cache[key]`` (n, b, positions, ...), or None where the cache is
    whole on every rank (no ``tp``, or a ``max_seq`` that does not divide
    over ``model``)."""
    n = cache[key].shape[2]
    if tp is None or n == cache["max_seq"]:
        return None
    return tp.rank * n


class PrefillCache:
    """The KV cache a prefill fills a layer at a time: this rank's block
    of positions (`cache_block`; every position without ``tp``), zero
    where the prompt does not reach, each layer's k and v (every
    position) written into the part of it the prompt covers. ``layers``
    is the number of attention calls that fill it (default
    ``cfg.num_layers``). Over ``model`` the cache keeps ``max_seq``.
    Raises ``ValueError`` when ``max_seq`` is shorter than the prompt, as
    the reference's ``jnp.pad`` does on the negative pad."""

    def __init__(self, x, cfg: ModelConfig, max_seq: int, rules=None,
                 tp=None, layers=None):
        b, self.s = x.shape[:2]
        if max_seq < self.s:
            raise ValueError(f"max_seq {max_seq} is shorter than the "
                             f"prompt's {self.s} positions")
        self.first, n = cache_block(rules, tp, max_seq)
        shape = (cfg.num_layers if layers is None else layers, b, n,
                 cfg.num_kv_heads, cfg.head_dim)
        self.k, self.v = x.new_zeros(shape), x.new_zeros(shape)
        self.extra = {} if tp is None else {"max_seq": max_seq}
        self.layers = 0

    def add(self, k, v):
        i, first = self.layers, self.first
        end = min(self.s, first + self.k.shape[2])
        if end > first:
            self.k[i, :, :end - first] = k[:, first:end]
            self.v[i, :, :end - first] = v[:, first:end]
        self.layers += 1

    def cache(self) -> dict:
        return {"k": self.k, "v": self.v, "length": self.s, **self.extra}


def prefill_embedded(x, params: dict, cfg: ModelConfig, max_seq: int,
                     rules=None):
    """The prefill of the dense stack from its input embeddings x (b, s,
    d): (cache, logits of the last position (b, 1, vocab)); under
    ``rules`` with a ``model`` extent above 1, tensor-parallel (the
    module docstring)."""
    b, s, _ = x.shape
    tp = tp_context(cfg, rules)
    positions = torch.arange(s, device=x.device).expand(b, s)
    stacked = {k: params[k] for k in LAYER_KEYS if k in params}
    fill = PrefillCache(x, cfg, max_seq, rules, tp)
    for lp in serving_layers(stacked):
        x, (k, v) = dense_block(x, lp, cfg, positions, prefill=True, tp=tp)
        fill.add(k, v)
    return fill.cache(), final_logits(x[:, -1:], params, cfg, tp)


def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int,
            rules=None):
    """Run the full prompt; returns (cache with per-layer k/v padded to
    ``max_seq``, logits of the last position)."""
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype],
                       vocab_tp(tp_context(cfg, rules)))
    return prefill_embedded(x, params, cfg, max_seq, rules)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token,
                rules=None):
    """token: (b, 1) integer; cache: {"k", "v", "length"} (and
    ``max_seq`` over ``model``). One new token: (logits (b, 1, vocab),
    the cache with ``length`` + 1)."""
    tp = tp_context(cfg, rules)
    pos = cache["length"]
    x = L.embed_tokens(params["embed"], token,
                       TORCH_DTYPES[cfg.compute_dtype], vocab_tp(tp))
    first = cache_first(cache, tp)
    stacked = {k: params[k] for k in LAYER_KEYS if k in params}
    for i, lp in enumerate(serving_layers(stacked)):
        x = decode_block(x, lp, cache["k"][i], cache["v"][i], pos, cfg, tp,
                         first)
    return final_logits(x, params, cfg, tp), dict(cache, length=pos + 1)
