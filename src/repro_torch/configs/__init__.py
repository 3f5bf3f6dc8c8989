"""Architecture registry, the port of ``repro.configs``: the ten assigned
architectures and the paper's five evaluation models, one module each."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, RunConfig,
    SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    shape_applicable,
)

# Assigned architectures (public pool) — one module per id.
ASSIGNED = [
    "zamba2-1.2b",
    "mamba2-2.7b",
    "granite-34b",
    "llama3.2-3b",
    "tinyllama-1.1b",
    "glm4-9b",
    "whisper-medium",
    "llava-next-mistral-7b",
    "dbrx-132b",
    "arctic-480b",
]

# The paper's own evaluation models (Table 1) used by the benchmark harness.
PAPER = ["gpt2-1.5b", "gpt3-xl", "gpt3-6.7b", "vit-h-14", "llama2-7b"]

_MODULES = {n: "repro_torch.configs." + n.replace("-", "_").replace(".", "_")
            for n in ASSIGNED + PAPER}


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_archs() -> list[str]:
    return list(ASSIGNED)
