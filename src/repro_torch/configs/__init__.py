"""Architectures the port runs so far."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

_MODULES = {"tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b"}


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; ported: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
