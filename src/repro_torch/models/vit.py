"""ViT classifier backbone (the paper's Table 1 ViT-H-14), the port of
``repro.models.vit``: precomputed patch embeddings (stub frontend), a
bidirectional encoder without RoPE, mean pooling and a linear head.

vit-h-14's config is ``family="vlm"`` in both packages, so this family is
reached only through ``dataclasses.replace(cfg, family="vit")``.

Training takes ``rules``: on a mesh whose ``model`` extent is above 1 the
encoder's dense blocks run tensor-parallel with no mask and no RoPE;
the mean pooling runs on the replicated output, outside the
model-parallel region, and ``head`` is column-parallel over the classes
where they divide ``model`` (the loss through
`tensor_parallel.vocab_xent`), whole elsewhere (vit-h-14's 1000 classes
over 16). There is no serving path, as in the reference.
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
    d = cfg.d_model
    specs = {
        "final_norm": ParamSpec((d,), ("unsharded",), init="ones"),
        "head": ParamSpec((d, cfg.vocab_size), ("wemb", "vocab")),
    }
    specs.update(T.layer_param_specs(cfg, cfg.num_layers))
    return specs


def tp_context(cfg: ModelConfig, rules):
    """The tensor-parallel context of ``rules`` for ``cfg``'s leaves (None
    without rules or at ``model`` extent 1)."""
    return TP.context(rules, param_specs(cfg))


def _head_tp(tp):
    """``tp`` where ``head`` is cut over ``model`` (the classes divide),
    else None."""
    return tp if tp is not None and tp.is_cut("head") else None


def forward(params: dict, cfg: ModelConfig, patch_embeds, tp=None):
    cd = TORCH_DTYPES[cfg.compute_dtype]
    x = T.decoder_stack(patch_embeds.to(cd), params, cfg, positions=None,
                        causal=False, tp=tp)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    pooled = x.mean(dim=1)
    return L.lm_logits(pooled, params["head"], _head_tp(tp))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, rules=None):
    """The mean loss of this rank's rows; under ``rules`` with a ``model``
    extent above 1, tensor-parallel."""
    tp = tp_context(cfg, rules)
    logits = forward(params, cfg, batch["patch_embeds"], tp).float()
    labels = batch["labels"]
    labels = labels[:, 0] if labels.dim() > 1 else labels
    if _head_tp(tp) is not None:
        return TP.vocab_xent(logits, labels, tp)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(lse - ll)
