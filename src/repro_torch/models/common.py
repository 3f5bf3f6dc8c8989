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
    init: str = "fan_in"            # fan_in | zeros | ones | normal | ssm_a | ssm_dt
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
    if spec.init == "ssm_a":        # A_log init: log(uniform[1,16])
        u = 1.0 + 15.0 * torch.rand(spec.shape, generator=gen,
                                    dtype=torch.float32, device=device)
        return torch.log(u).to(dt)
    if spec.init == "ssm_dt":       # dt_bias: inverse softplus of dt, with
        # log(dt) uniform in [log 1e-3, log 0.1]
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=device)
        dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
        return (dt0 + torch.log(-torch.expm1(-dt0))).to(dt)
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


def spec_param_count(specs: dict, active_only: bool = False,
                     top_k: int = 0, num_experts: int = 0) -> int:
    """Parameters in ``specs``; with ``active_only``, an expert leaf counts
    the ``top_k`` of its ``num_experts`` experts a token runs."""
    total = 0
    for spec in specs.values():
        n = spec.size
        if active_only and num_experts and "expert" in spec.logical:
            n = n * top_k // num_experts
        total += n
    return total
