"""Dense decoder-only LM (llama/glm/granite/tinyllama family), the port of
``repro.models.transformer``'s training path, and the attention block and
layer stack every other family with attention builds on.

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


def attn_block(x, lp: dict, cfg: ModelConfig, positions, *, causal=True):
    """Pre-norm attention with its residual: the flash kernel forward
    (top-left causal or none) and the recompute-from-lse backward."""
    b, s, _ = x.shape
    xn = L.rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = L.attn_project_qkv(xn, lp, cfg, positions)
    o = L.FlashAttention.apply(q, k, v, causal).reshape(b, s, -1)
    return x + o @ lp["wo"].to(o.dtype)


def dense_block(x, lp: dict, cfg: ModelConfig, positions, *, causal=True):
    """Attention + MLP (``cfg.mlp``) with pre-norms and residuals."""
    x = attn_block(x, lp, cfg, positions, causal=causal)
    xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + L.mlp(xn, lp, cfg)


def run_layers(x, stacked: dict, body, remat: bool):
    """``x = body(x, lp)`` for each layer's slice ``lp`` of the stacked
    leaves (a scan over their leading axis), recomputed in the backward
    when ``remat`` (one ``jax.checkpoint``-ed scan step each)."""
    keys = list(stacked)
    # unbind once: its backward stacks the per-layer grads in one pass
    per_layer = {k: stacked[k].unbind(0) for k in keys}

    def one_layer(x, *ws):
        return body(x, dict(zip(keys, ws)))

    for i in range(len(per_layer[keys[0]])):
        ws = [per_layer[k][i] for k in keys]
        if remat and torch.is_grad_enabled():
            x = checkpoint(one_layer, x, *ws, use_reentrant=False)
        else:
            x = one_layer(x, *ws)
    return x


def decoder_stack(x, params: dict, cfg: ModelConfig, positions, *,
                  causal=True, block_fn=dense_block):
    """The layer loop over the stacked keys present (gelu2 has no
    ``w_gate``); returns the final hidden states in the compute dtype."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    stacked = {k: params[k] for k in LAYER_KEYS if k in params}
    return run_layers(
        x, stacked,
        lambda x, lp: block_fn(x, lp, cfg, positions, causal=causal).to(cd),
        cfg.remat)


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
