"""Parameter specs and their initialisation, the port of
``repro.models.common``.

A family module exposes ``param_specs(cfg) -> {name: ParamSpec}``; the same
names, shapes and dtypes as the JAX package give the same bucket layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.buckets import TORCH_DTYPES


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple                  # one logical axis name (or None) per dim
    init: str = "fan_in"            # fan_in | zeros | ones | normal
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _init_leaf(gen: torch.Generator, spec: ParamSpec, device) -> torch.Tensor:
    dt = TORCH_DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "normal":
        std = 0.02
    elif spec.init == "fan_in":
        # scaled by 1/sqrt(fan_in): second-to-last dim (or last for 1D)
        fan = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 1.0 / math.sqrt(max(fan, 1))
    else:
        raise ValueError(f"init {spec.init!r} is not ported")
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dt)


def init_params(specs: dict, seed: int, device) -> dict:
    """Random parameters from one generator seeded with ``seed``, drawn in
    sorted leaf order (the JAX package's order; the dict keeps it)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: _init_leaf(gen, specs[name], device)
            for name in sorted(specs)}


def spec_param_count(specs: dict) -> int:
    return sum(spec.size for spec in specs.values())
