"""Dense decoder-only LM (llama/tinyllama family), the port of
``repro.models.transformer``'s training path.

Per-layer weights are stacked ``(L, ...)`` leaves under the JAX package's
names, so the two packages' bucket layouts are equal. The forward loops
over the layers; with ``cfg.remat`` each layer is recomputed in the
backward (``torch.utils.checkpoint``), as ``jax.checkpoint`` does there.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.models import layers as L
from repro_torch.models.common import ParamSpec

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
              "w_gate", "w_up", "w_down")


def layer_param_specs(cfg: ModelConfig, n_layers: int) -> dict:
    h, kv, hd, d, f = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.d_model, cfg.d_ff)

    def S(shape, logical, **kw):
        return ParamSpec((n_layers,) + shape, ("layers",) + logical, **kw)
    specs = {
        "attn_norm": S((d,), ("unsharded",), init="ones"),
        "wq": S((d, h * hd), ("wemb", "heads")),
        "wk": S((d, kv * hd), ("wemb", "kv_heads")),
        "wv": S((d, kv * hd), ("wemb", "kv_heads")),
        "wo": S((h * hd, d), ("heads", "wemb")),
        "mlp_norm": S((d,), ("unsharded",), init="ones"),
        "w_up": S((d, f), ("wemb", "ff")),
        "w_down": S((f, d), ("ff", "wemb")),
    }
    if cfg.mlp != "swiglu":
        raise NotImplementedError(f"mlp {cfg.mlp!r} is not ported")
    specs["w_gate"] = S((d, f), ("wemb", "ff"))
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


def dense_block(x, lp: dict, cfg: ModelConfig, positions):
    """Attention + SwiGLU MLP with pre-norms and residuals."""
    b, s, _ = x.shape
    xn = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = L.attn_project_qkv(xn, lp, cfg, positions)
    o = L.FlashAttention.apply(q, k, v, True).reshape(b, s, -1)
    x = x + o @ lp["wo"].to(o.dtype)
    xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + L.mlp_swiglu(xn, lp)


def decoder_stack(x, params: dict, cfg: ModelConfig, positions):
    cd = TORCH_DTYPES[cfg.compute_dtype]
    # unbind once: its backward stacks the per-layer grads in one pass
    per_layer = {k: params[k].unbind(0) for k in LAYER_KEYS}

    def one_layer(x, *ws):
        return dense_block(x, dict(zip(LAYER_KEYS, ws)), cfg,
                           positions).to(cd)

    for i in range(cfg.num_layers):
        ws = [per_layer[k][i] for k in LAYER_KEYS]
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(one_layer, x, *ws, use_reentrant=False)
        else:
            x = one_layer(x, *ws)
    return x


def forward(params: dict, cfg: ModelConfig, tokens):
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype])
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = decoder_stack(x, params, cfg, positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"])
    return L.lm_logits(x, unembed)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    return L.xent_loss(forward(params, cfg, batch["tokens"]), batch["labels"])
