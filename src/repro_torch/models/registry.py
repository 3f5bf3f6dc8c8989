"""Family registry, the port of ``repro.models.registry``: param specs,
counts, init and loss of all seven families, and the serving entry points
(cache specs, an empty cache, prefill and decode) of the six that serve.

Prefill and decode run under ``torch.inference_mode``. ``vit`` has no
serving path, as in the JAX package: asking it for one raises
``AttributeError``, as the reference's missing functions do. The
``ShapeDtypeStruct`` stand-ins (``abstract_cache``, ``input_specs``) are
the JAX package's dry run's and have no counterpart here.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.device import resolve
from repro_torch.models import common

_FAMILIES = {
    "dense": "repro_torch.models.transformer",
    "moe": "repro_torch.models.moe",
    "ssm": "repro_torch.models.ssm",
    "hybrid": "repro_torch.models.hybrid",
    "audio": "repro_torch.models.encdec",
    "vlm": "repro_torch.models.vlm",
    "vit": "repro_torch.models.vit",
}


def family_module(cfg: ModelConfig):
    return importlib.import_module(_FAMILIES[cfg.family])


def param_specs(cfg: ModelConfig) -> dict:
    return family_module(cfg).param_specs(cfg)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    return common.spec_param_count(
        param_specs(cfg), active_only=active_only,
        top_k=cfg.top_k, num_experts=cfg.num_experts)


def init_params(cfg: ModelConfig, seed: int, device) -> dict:
    return common.init_params(param_specs(cfg), seed, device)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, rules=None):
    """The loss of this rank's rows. ``rules`` reach the MoE family alone
    (its token groups are the dp ranks'); every other family computes
    each row on its own, the same on any mesh."""
    if cfg.family == "moe":
        return family_module(cfg).loss_fn(params, cfg, batch, rules=rules)
    return family_module(cfg).loss_fn(params, cfg, batch)


def _serving(cfg: ModelConfig, name: str):
    fn = getattr(family_module(cfg), name, None)
    if fn is None:
        raise AttributeError(f"family {cfg.family!r} has no {name} (no "
                             f"serving path, as in the JAX package)")
    return fn


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return _serving(cfg, "cache_specs")(cfg, batch, max_seq)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> dict:
    """An empty cache: every leaf zero, ``length`` 0."""
    device = resolve(device)
    cache = {name: torch.zeros(spec.shape, dtype=TORCH_DTYPES[spec.dtype],
                               device=device)
             for name, spec in cache_specs(cfg, batch, max_seq).items()}
    cache["length"] = 0
    return cache


@torch.inference_mode()
def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int, **extra):
    """(cache, logits of the last position (b, 1, vocab)); ``extra`` is
    ``frames`` (audio) or ``patch_embeds`` (vlm)."""
    return _serving(cfg, "prefill")(params, cfg, tokens, max_seq, **extra)


@torch.inference_mode()
def decode_step(params: dict, cfg: ModelConfig, cache: dict, token):
    """(logits (b, 1, vocab), cache advanced by one position); the cache's
    tensors are updated in place."""
    return _serving(cfg, "decode_step")(params, cfg, cache, token)
