"""whisper-style encoder-decoder backbone, the port of
``repro.models.encdec``: training, prefill and decode.

The log-mel + conv1d frontend is a stub, as in the JAX package: the batch
carries precomputed frame embeddings (batch, encoder_seq, d_model). A
bidirectional encoder with RoPE; a decoder with causal self-attention,
cross-attention to the encoder's memory, and a SwiGLU MLP. Cross-attention
runs the flash kernel with no mask at sq = text length, skv = encoder_seq
(the reference computes the same function with ``attention_qchunk``).
In serving the cache holds the decoder's self-attention k, v (at the kv
heads, ``max_seq`` positions) and each layer's cross-attention k, v of the
encoder's memory (at every head, ``encoder_seq`` positions).

Training and serving take ``rules``: on a mesh whose ``model`` extent is
above 1 the encoder's and the decoder's dense blocks run tensor-parallel
(not causal in the encoder), and each decoder layer's cross-attention
runs over this rank's heads (`layers.cross_attention_tp`): the memory,
a replicated activation every layer reads at its own heads, enters each
one through `tensor_parallel.copy_to_model`. In serving the
self-attention cache is cut on ``kv_seq`` as the dense family's is, and
``xk``/``xv`` hold this rank's heads, the reference's cut; decode's
cross-attention reads them, then ``xwo`` row-parallel. The embedding and
logits are vocab-parallel where the vocab divides ``model``
(whisper-medium's 51865 does not divide 16: whole there).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.dist import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ParamSpec


def param_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    h, hd = cfg.num_heads, cfg.head_dim
    specs = {
        "embed": ParamSpec((v, d), ("vocab", "wemb"), init="normal"),
        "final_norm": ParamSpec((d,), ("unsharded",), init="ones"),
        "memory_norm": ParamSpec((d,), ("unsharded",), init="ones"),
        "unembed": ParamSpec((d, v), ("wemb", "vocab")),
    }
    specs.update(T.layer_param_specs(cfg, cfg.encoder_layers, prefix="enc_"))
    specs.update(T.layer_param_specs(cfg, cfg.num_layers, prefix="dec_"))
    # decoder cross-attention (stacked)
    nl = cfg.num_layers
    specs.update({
        "xattn_norm": ParamSpec((nl, d), ("layers", "unsharded"), init="ones"),
        "xwq": ParamSpec((nl, d, h * hd), ("layers", "wemb", "heads")),
        "xwk": ParamSpec((nl, d, h * hd), ("layers", "wemb", "heads")),
        "xwv": ParamSpec((nl, d, h * hd), ("layers", "wemb", "heads")),
        "xwo": ParamSpec((nl, h * hd, d), ("layers", "heads", "wemb")),
    })
    return specs


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def tp_context(cfg: ModelConfig, rules):
    """The tensor-parallel context of ``rules`` for ``cfg``'s leaves, the
    encoder's and decoder's under the names their blocks read (None
    without rules or at ``model`` extent 1)."""
    specs = param_specs(cfg)
    return TP.context(rules, {**specs, **_sub(specs, "enc_"),
                              **_sub(specs, "dec_")})


XATTN_KEYS = ("xattn_norm", "xwq", "xwk", "xwv", "xwo")


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def encode(params: dict, cfg: ModelConfig, frames, *, prefill=False,
           tp=None):
    """frames: (b, enc_seq, d) precomputed embeddings -> encoder memory;
    with ``prefill``, the flash forward alone (serving); with ``tp``, the
    blocks over ``model``."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    x = frames.to(cd)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    enc = _sub(params, "enc_")
    if prefill:
        for lp in T.serving_layers(enc):
            x, _ = T.dense_block(x, lp, cfg, positions, causal=False,
                                 prefill=True, tp=tp)
    else:
        x = T.run_layers(
            x, enc, lambda x, lp: T.dense_block(x, lp, cfg, positions,
                                                causal=False, tp=tp).to(cd),
            cfg.remat)
    return L.rmsnorm(x, params["memory_norm"], cfg.norm_eps)


def _cross_attn(x, lp: dict, memory, cfg: ModelConfig, *, prefill=False,
                tp=None):
    """Cross-attention with its residual; with ``prefill``, the flash
    forward alone and ``(x, (k, v))`` with the memory's k, v; with ``tp``,
    over this rank's heads (`layers.cross_attention_tp`)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    xn = L.rmsnorm(x, lp["xattn_norm"], cfg.norm_eps)
    if tp is not None:
        out = L.cross_attention_tp(xn, memory, lp, cfg, tp, prefill)
        return (x + out[0], out[1]) if prefill else x + out
    q = (xn @ lp["xwq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (memory @ lp["xwk"].to(x.dtype)).reshape(b, -1, h, hd)
    v = (memory @ lp["xwv"].to(x.dtype)).reshape(b, -1, h, hd)
    if prefill:
        o = L.attention_prefill(q, k, v, False)
    else:
        o = L.FlashAttention.apply(q.contiguous(), k.contiguous(),
                                   v.contiguous(), False)
    x = x + o.reshape(b, s, -1) @ lp["xwo"].to(x.dtype)
    return (x, (k, v)) if prefill else x


def _mlp(xn, lp: dict, tp=None):
    """The decoder's SwiGLU MLP (whatever ``cfg.mlp`` says, as the
    reference's); with ``tp``, over the ff columns."""
    if tp is None or not tp.is_cut("w_up"):
        return L.mlp_swiglu(xn, lp)
    return TP.reduce_from_model(L.mlp_swiglu(TP.copy_to_model(xn, tp), lp),
                                tp)


def _decoder_params(params: dict) -> dict:
    dec = _sub(params, "dec_")
    dec.update({k: params[k] for k in XATTN_KEYS})
    return dec


def _decoder_stack(x, params: dict, memory, cfg: ModelConfig, positions,
                   tp=None):
    def one_layer(x, lp):
        y = T.attn_block(x, lp, cfg, positions, tp=tp)
        y = _cross_attn(y, lp, memory, cfg, tp=tp)
        xn = L.rmsnorm(y, lp["mlp_norm"], cfg.norm_eps)
        y = y + _mlp(xn, lp, tp)
        return y.to(x.dtype)

    return T.run_layers(x, _decoder_params(params), one_layer, cfg.remat)


def forward(params: dict, cfg: ModelConfig, tokens, frames, tp=None):
    """The decoder's logits at every text position."""
    memory = encode(params, cfg, frames, tp=tp)
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    x = _decoder_stack(x, params, memory, cfg,
                       _positions(b, s, tokens.device), tp)
    return T.final_logits(x, params, cfg, tp)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, rules=None):
    """The mean loss of this rank's rows; under ``rules`` with a ``model``
    extent above 1, tensor-parallel."""
    tp = tp_context(cfg, rules)
    logits = forward(params, cfg, batch["tokens"], batch["frames"], tp)
    return L.xent_loss(logits, batch["labels"], T.vocab_tp(tp))


# -- cache -------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    kv, hd, h = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    nl, es = cfg.num_layers, cfg.encoder_seq
    self_shape = (nl, batch, max_seq, kv, hd)
    self_logical = ("layers", "batch", "kv_seq", None, None)
    cross_shape = (nl, batch, es, h, hd)
    cross_logical = ("layers", "batch", None, "heads", None)
    return {
        "k": ParamSpec(self_shape, self_logical, init="zeros",
                       dtype=cfg.compute_dtype),
        "v": ParamSpec(self_shape, self_logical, init="zeros",
                       dtype=cfg.compute_dtype),
        "xk": ParamSpec(cross_shape, cross_logical, init="zeros",
                        dtype=cfg.compute_dtype),
        "xv": ParamSpec(cross_shape, cross_logical, init="zeros",
                        dtype=cfg.compute_dtype),
    }


def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int,
            frames=None, rules=None):
    """Encode ``frames``, then run the decoder over the prompt: its self-
    and cross-attention both on the flash forward; under ``rules`` over
    ``model``, this rank's block of the self-attention cache and its
    heads of the cross-attention's."""
    tp = tp_context(cfg, rules)
    memory = encode(params, cfg, frames, prefill=True, tp=tp)
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    positions = _positions(b, s, tokens.device)
    fill = T.PrefillCache(x, cfg, max_seq, rules, tp)
    xks, xvs = [], []
    for lp in T.serving_layers(_decoder_params(params)):
        x, (k, v) = T.attn_block(x, lp, cfg, positions, prefill=True, tp=tp)
        x, (xk, xv) = _cross_attn(x, lp, memory, cfg, prefill=True, tp=tp)
        xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(xn, lp, tp)
        fill.add(k, v)
        xks.append(xk)
        xvs.append(xv)
    cache = dict(fill.cache(), xk=torch.stack(xks), xv=torch.stack(xvs))
    return cache, T.final_logits(x[:, -1:], params, cfg, tp)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token,
                rules=None):
    """Self-attention over the positions written so far, cross-attention
    over the whole memory (no mask); under ``rules`` over ``model``, the
    self-attention over this rank's cache block (combined over the
    group) and the cross-attention over its heads."""
    tp = tp_context(cfg, rules)
    pos = cache["length"]
    x = L.embed_tokens(params["embed"], token,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    b = x.shape[0]
    h = cfg.num_heads if tp is None else cfg.num_heads // tp.size
    hd = cfg.head_dim
    first = T.cache_first(cache, tp)
    for i, lp in enumerate(T.serving_layers(_decoder_params(params))):
        x = T.decode_attn(x, lp, cache["k"][i], cache["v"][i], pos, cfg, tp,
                          first)
        xn = L.rmsnorm(x, lp["xattn_norm"], cfg.norm_eps)
        q = (xn @ lp["xwq"].to(x.dtype)).reshape(b, 1, h, hd)
        o = L.attention_decode(q, cache["xk"][i], cache["xv"][i])
        y = o.reshape(b, 1, -1) @ lp["xwo"].to(x.dtype)
        x = x + (y if tp is None else TP.reduce_from_model(y, tp))
        xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(xn, lp, tp)
    return T.final_logits(x, params, cfg, tp), dict(cache, length=pos + 1)
