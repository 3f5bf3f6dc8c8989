"""Family registry, the port of ``repro.models.registry``'s training half
(param specs, counts, init and loss of all seven families)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
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


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    return family_module(cfg).loss_fn(params, cfg, batch)
