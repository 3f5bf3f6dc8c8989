"""Dense decoder-only LM (llama/glm/granite/tinyllama family), the port of
``repro.models.transformer``: the training forward, prefill and
single-token decode against a KV cache, and the attention block, decode
block and layer stack every other family with attention builds on.

Per-layer weights are stacked ``(L, ...)`` leaves under the JAX package's
names, so the two packages' bucket layouts are equal. The forward loops
over the layers; with ``cfg.remat`` each layer is recomputed in the
backward (``torch.utils.checkpoint``), as ``jax.checkpoint`` does there.

Training takes ``rules``: on a mesh whose ``model`` extent is above 1 the
layers run tensor-parallel (`repro_torch.dist.tensor_parallel`) on this
rank's slices of the model-cut leaves; with no rules, or ``model`` of
extent 1, they are the plain whole layers. Serving is not tensor-parallel.

Serving takes the f32 params as the reference's does and casts at each
use. A cache is a dict of tensors and ``length``, a host int: the number
of positions written, so writing at ``pos`` and masking cost no device
sync. ``decode_step`` writes the new position into the cache's tensors in
place (the reference's serving loop donates its cache) and returns the
dict with ``length`` advanced.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.dist import tensor_parallel as TP
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
    forward alone, returning ``(x, (k, v))`` with k, v at the kv heads
    (the cache's entries)."""
    b, s, _ = x.shape
    xn = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
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


def decode_attn(x, lp: dict, kc, vc, pos: int, cfg: ModelConfig):
    """The attention half of a decode block: x (b, 1, d) at position
    ``pos``; its k, v are written into one layer's caches kc, vc (b, S, kv,
    hd) at ``pos`` in place, and it attends over positions < pos + 1."""
    b = x.shape[0]
    xn = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    positions = torch.full((b, 1), pos, device=x.device)
    q, k, v = L.attn_project_qkv(xn, lp, cfg, positions)
    kc[:, pos] = k[:, 0]
    vc[:, pos] = v[:, 0]
    o = L.attention_decode(q, kc, vc, length=pos + 1)
    return x + o.reshape(b, 1, -1) @ lp["wo"].to(o.dtype)


def decode_block(x, lp: dict, kc, vc, pos: int, cfg: ModelConfig):
    """Single-token dense block against one layer's KV cache (written in
    place). x: (b, 1, d) -> (b, 1, d)."""
    x = decode_attn(x, lp, kc, vc, pos, cfg)
    xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + L.mlp(xn, lp, cfg)


def layers_of(stacked: dict) -> list:
    """Each layer's slice of the stacked leaves, as a dict per layer. The
    leaves are unbound once, so the backward stacks the per-layer grads in
    one pass."""
    keys = list(stacked)
    per_layer = [stacked[k].unbind(0) for k in keys]
    return [dict(zip(keys, ws)) for ws in zip(*per_layer)]


def run_layers(x, stacked: dict, body, remat: bool):
    """``x = body(x, lp)`` for each layer's slice ``lp`` of the stacked
    leaves (a scan over their leading axis), recomputed in the backward
    when ``remat`` (one ``jax.checkpoint``-ed scan step each)."""
    keys = list(stacked)

    def one_layer(x, *ws):
        return body(x, dict(zip(keys, ws)))

    for lp in layers_of(stacked):
        if remat and torch.is_grad_enabled():
            x = checkpoint(one_layer, x, *lp.values(), use_reentrant=False)
        else:
            x = body(x, lp)
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


def stack_padded(ts: list, max_seq: int):
    """Per-call (b, s, ...) tensors stacked along a new leading axis and
    zero-padded to ``max_seq`` positions: (n, b, max_seq, ...). Raises
    ``ValueError`` when ``max_seq < s``, as the reference's ``jnp.pad``
    does on the negative pad."""
    b, s = ts[0].shape[:2]
    if max_seq < s:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt's "
                         f"{s} positions")
    out = ts[0].new_zeros((len(ts), b, max_seq) + tuple(ts[0].shape[2:]))
    for i, t in enumerate(ts):
        out[i, :, :s] = t
    return out


def prefill_embedded(x, params: dict, cfg: ModelConfig, max_seq: int):
    """The prefill of the dense stack from its input embeddings x (b, s,
    d): (cache, logits of the last position (b, 1, vocab))."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    stacked = {k: params[k] for k in LAYER_KEYS if k in params}
    ks, vs = [], []
    for lp in layers_of(stacked):
        x, (k, v) = dense_block(x, lp, cfg, positions, prefill=True)
        ks.append(k)
        vs.append(v)
    cache = {"k": stack_padded(ks, max_seq), "v": stack_padded(vs, max_seq),
             "length": s}
    return cache, final_logits(x[:, -1:], params, cfg)


def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int):
    """Run the full prompt; returns (cache with per-layer k/v padded to
    ``max_seq``, logits of the last position)."""
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype])
    return prefill_embedded(x, params, cfg, max_seq)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token):
    """token: (b, 1) integer; cache: {"k", "v", "length"}. One new token:
    (logits (b, 1, vocab), the cache with ``length`` + 1)."""
    pos = cache["length"]
    x = L.embed_tokens(params["embed"], token,
                       TORCH_DTYPES[cfg.compute_dtype])
    stacked = {k: params[k] for k in LAYER_KEYS if k in params}
    for i, lp in enumerate(layers_of(stacked)):
        x = decode_block(x, lp, cache["k"][i], cache["v"][i], pos, cfg)
    return final_logits(x, params, cfg), dict(cache, length=pos + 1)
