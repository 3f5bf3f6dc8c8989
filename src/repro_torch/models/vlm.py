"""llava-next-style VLM, the port of ``repro.models.vlm``'s training path:
a stubbed vision frontend and the dense LM backbone.

The batch carries precomputed, projected patch embeddings (batch,
num_patches, d_model); they are prepended to the token embeddings, the
causal LM runs over the combined sequence, and the loss is taken on the
text positions only.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def param_specs(cfg: ModelConfig) -> dict:
    return T.param_specs(cfg)


def forward(params: dict, cfg: ModelConfig, tokens, patch_embeds):
    cd = TORCH_DTYPES[cfg.compute_dtype]
    b, s_text = tokens.shape
    p = patch_embeds.shape[1]
    tok = L.embed_tokens(params["embed"], tokens, cd)
    x = torch.cat([patch_embeds.to(cd), tok], dim=1)
    s = p + s_text
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = T.decoder_stack(x, params, cfg, positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"])
    return L.lm_logits(x[:, p:], unembed)      # text positions only


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    logits = forward(params, cfg, batch["tokens"], batch["patch_embeds"])
    return L.xent_loss(logits, batch["labels"])
