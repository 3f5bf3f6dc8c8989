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
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
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


XATTN_KEYS = ("xattn_norm", "xwq", "xwk", "xwv", "xwo")


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device).expand(b, s)


def encode(params: dict, cfg: ModelConfig, frames, *, prefill=False):
    """frames: (b, enc_seq, d) precomputed embeddings -> encoder memory;
    with ``prefill``, the flash forward alone (serving)."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    x = frames.to(cd)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    enc = _sub(params, "enc_")
    if prefill:
        for lp in T.layers_of(enc):
            x, _ = T.dense_block(x, lp, cfg, positions, causal=False,
                                 prefill=True)
    else:
        x = T.run_layers(
            x, enc, lambda x, lp: T.dense_block(x, lp, cfg, positions,
                                                causal=False).to(cd),
            cfg.remat)
    return L.rmsnorm(x, params["memory_norm"], cfg.norm_eps)


def _cross_attn(x, lp: dict, memory, cfg: ModelConfig, *, prefill=False):
    """Cross-attention with its residual; with ``prefill``, the flash
    forward alone and ``(x, (k, v))`` with the memory's k, v."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    xn = L.rmsnorm(x, lp["xattn_norm"], cfg.norm_eps)
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


def _decoder_params(params: dict) -> dict:
    dec = _sub(params, "dec_")
    dec.update({k: params[k] for k in XATTN_KEYS})
    return dec


def _decoder_stack(x, params: dict, memory, cfg: ModelConfig, positions):
    def one_layer(x, lp):
        y = T.attn_block(x, lp, cfg, positions)
        y = _cross_attn(y, lp, memory, cfg)
        xn = L.rmsnorm(y, lp["mlp_norm"], cfg.norm_eps)
        y = y + L.mlp_swiglu(xn, lp)
        return y.to(x.dtype)

    return T.run_layers(x, _decoder_params(params), one_layer, cfg.remat)


def forward(params: dict, cfg: ModelConfig, tokens, frames):
    """The decoder's logits at every text position."""
    memory = encode(params, cfg, frames)
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype])
    x = _decoder_stack(x, params, memory, cfg,
                       _positions(b, s, tokens.device))
    return T.final_logits(x, params, cfg)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    logits = forward(params, cfg, batch["tokens"], batch["frames"])
    return L.xent_loss(logits, batch["labels"])


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
            frames=None):
    """Encode ``frames``, then run the decoder over the prompt: its self-
    and cross-attention both on the flash forward."""
    memory = encode(params, cfg, frames, prefill=True)
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype])
    positions = _positions(b, s, tokens.device)
    ks, vs, xks, xvs = [], [], [], []
    for lp in T.layers_of(_decoder_params(params)):
        x, (k, v) = T.attn_block(x, lp, cfg, positions, prefill=True)
        x, (xk, xv) = _cross_attn(x, lp, memory, cfg, prefill=True)
        xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + L.mlp_swiglu(xn, lp)
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    cache = {"k": T.stack_padded(ks, max_seq),
             "v": T.stack_padded(vs, max_seq),
             "xk": torch.stack(xks), "xv": torch.stack(xvs), "length": s}
    return cache, T.final_logits(x[:, -1:], params, cfg)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token):
    """Self-attention over the positions written so far, cross-attention
    over the whole memory (no mask)."""
    pos = cache["length"]
    x = L.embed_tokens(params["embed"], token,
                       TORCH_DTYPES[cfg.compute_dtype])
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    for i, lp in enumerate(T.layers_of(_decoder_params(params))):
        x = T.decode_attn(x, lp, cache["k"][i], cache["v"][i], pos, cfg)
        xn = L.rmsnorm(x, lp["xattn_norm"], cfg.norm_eps)
        q = (xn @ lp["xwq"].to(x.dtype)).reshape(b, 1, h, hd)
        o = L.attention_decode(q, cache["xk"][i], cache["xv"][i])
        x = x + o.reshape(b, 1, -1) @ lp["xwo"].to(x.dtype)
        xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + L.mlp_swiglu(xn, lp)
    return T.final_logits(x, params, cfg), dict(cache, length=pos + 1)
