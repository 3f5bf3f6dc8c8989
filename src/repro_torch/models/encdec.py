"""whisper-style encoder-decoder backbone, the port of
``repro.models.encdec``'s training path.

The log-mel + conv1d frontend is a stub, as in the JAX package: the batch
carries precomputed frame embeddings (batch, encoder_seq, d_model). A
bidirectional encoder with RoPE; a decoder with causal self-attention,
cross-attention to the encoder's memory, and a SwiGLU MLP. Cross-attention
runs the flash kernel with no mask at sq = text length, skv = encoder_seq
(the reference computes the same function with ``attention_qchunk``).
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


def encode(params: dict, cfg: ModelConfig, frames):
    """frames: (b, enc_seq, d) precomputed embeddings -> encoder memory."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    x = frames.to(cd)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    x = T.run_layers(
        x, _sub(params, "enc_"),
        lambda x, lp: T.dense_block(x, lp, cfg, positions,
                                    causal=False).to(cd),
        cfg.remat)
    return L.rmsnorm(x, params["memory_norm"], cfg.norm_eps)


def _cross_attn(x, lp: dict, memory, cfg: ModelConfig):
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    xn = L.rmsnorm(x, lp["xattn_norm"], cfg.norm_eps)
    q = (xn @ lp["xwq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (memory @ lp["xwk"].to(x.dtype)).reshape(b, -1, h, hd)
    v = (memory @ lp["xwv"].to(x.dtype)).reshape(b, -1, h, hd)
    o = L.FlashAttention.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), False)
    return x + o.reshape(b, s, -1) @ lp["xwo"].to(x.dtype)


def _decoder_stack(x, params: dict, memory, cfg: ModelConfig, positions):
    dec = _sub(params, "dec_")
    dec.update({k: params[k] for k in XATTN_KEYS})

    def one_layer(x, lp):
        y = T.attn_block(x, lp, cfg, positions)
        y = _cross_attn(y, lp, memory, cfg)
        xn = L.rmsnorm(y, lp["mlp_norm"], cfg.norm_eps)
        y = y + L.mlp_swiglu(xn, lp)
        return y.to(x.dtype)

    return T.run_layers(x, dec, one_layer, cfg.remat)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    tokens, labels = batch["tokens"], batch["labels"]
    memory = encode(params, cfg, batch["frames"])
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype])
    x = _decoder_stack(x, params, memory, cfg,
                       _positions(b, s, tokens.device))
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.xent_loss(L.lm_logits(x, params["unembed"]), labels)
