"""Family registry, the port of ``repro.models.registry`` (dense family
only so far)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

_FAMILIES = {"dense": "repro_torch.models.transformer"}


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported; "
                                  f"ported: {sorted(_FAMILIES)}")
    return importlib.import_module(_FAMILIES[cfg.family])


def param_specs(cfg: ModelConfig) -> dict:
    return family_module(cfg).param_specs(cfg)


def param_count(cfg: ModelConfig) -> int:
    return common.spec_param_count(param_specs(cfg))


def init_params(cfg: ModelConfig, seed: int, device) -> dict:
    return common.init_params(param_specs(cfg), seed, device)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    return family_module(cfg).loss_fn(params, cfg, batch)
