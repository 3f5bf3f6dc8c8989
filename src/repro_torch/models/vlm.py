"""llava-next-style VLM, the port of ``repro.models.vlm``: a stubbed
vision frontend and the dense LM backbone; training, prefill and decode.

The batch carries precomputed, projected patch embeddings (batch,
num_patches, d_model); they are prepended to the token embeddings, the
causal LM runs over the combined sequence, and the loss is taken on the
text positions only. In serving the patches sit before the prompt in the
cache, which then holds ``num_patches + s_text`` positions after prefill.
Training and serving under ``rules`` run the dense blocks tensor-parallel
over ``model``; the patch embeddings are replicated over it, as in the
reference. A cache cut on ``kv_seq`` holds the patches' and the prompt's
positions in whichever ranks' blocks they fall.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def param_specs(cfg: ModelConfig) -> dict:
    return T.param_specs(cfg)


tp_context = T.tp_context      # the dense family's leaves


def _embed(params: dict, cfg: ModelConfig, tokens, patch_embeds,
           vocab=None):
    cd = TORCH_DTYPES[cfg.compute_dtype]
    tok = L.embed_tokens(params["embed"], tokens, cd, vocab)
    return torch.cat([patch_embeds.to(cd), tok], dim=1)


def forward(params: dict, cfg: ModelConfig, tokens, patch_embeds, tp=None):
    b, s_text = tokens.shape
    p = patch_embeds.shape[1]
    x = _embed(params, cfg, tokens, patch_embeds, T.vocab_tp(tp))
    s = p + s_text
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = T.decoder_stack(x, params, cfg, positions, tp=tp)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"])
    return L.lm_logits(x[:, p:], unembed,          # text positions only
                       T.vocab_tp(tp))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, rules=None):
    tp = tp_context(cfg, rules)
    logits = forward(params, cfg, batch["tokens"], batch["patch_embeds"],
                     tp)
    return L.xent_loss(logits, batch["labels"], T.vocab_tp(tp))


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return T.cache_specs(cfg, batch, max_seq)


def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int,
            patch_embeds=None, rules=None):
    """Patches, then the prompt. Raises ``ValueError`` when ``max_seq``
    is shorter than ``num_patches + s_text``, as the reference does."""
    vocab = T.vocab_tp(tp_context(cfg, rules))
    return T.prefill_embedded(_embed(params, cfg, tokens, patch_embeds,
                                     vocab), params, cfg, max_seq, rules)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token,
                rules=None):
    return T.decode_step(params, cfg, cache, token, rules)
