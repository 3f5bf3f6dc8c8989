"""ViT classifier backbone (the paper's Table 1 ViT-H-14), the port of
``repro.models.vit``: precomputed patch embeddings (stub frontend), a
bidirectional encoder without RoPE, mean pooling and a linear head.

vit-h-14's config is ``family="vlm"`` in both packages, so this family is
reached only through ``dataclasses.replace(cfg, family="vit")``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ParamSpec


def param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    specs = {
        "final_norm": ParamSpec((d,), ("unsharded",), init="ones"),
        "head": ParamSpec((d, cfg.vocab_size), ("wemb", "vocab")),
    }
    specs.update(T.layer_param_specs(cfg, cfg.num_layers))
    return specs


def forward(params: dict, cfg: ModelConfig, patch_embeds):
    cd = TORCH_DTYPES[cfg.compute_dtype]
    x = T.decoder_stack(patch_embeds.to(cd), params, cfg, positions=None,
                        causal=False)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    pooled = x.mean(dim=1)
    return pooled @ params["head"].to(cd)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    logits = forward(params, cfg, batch["patch_embeds"]).float()
    labels = batch["labels"]
    labels = labels[:, 0] if labels.dim() > 1 else labels
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(lse - ll)
