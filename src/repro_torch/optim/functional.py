"""Functional AdamW (the paper's §4.2.4 requirement), as plain functions on
tensors.

Each parameter's update is an elementwise function of (param, grad,
moments, step), so any contiguous slice of any leaf can be updated on its
own. The trainer (per leaf) and the shadow (per flat bucket) both run the
same fused AdamW kernel with the same host-computed f32 scalars, so their
states are bit-identical by construction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import adamw_ref, adamw_scalars


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # only adamw is ported so far
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 0.0         # 0 = off (global-norm clip)

    def scalars(self, step: int, lr: float):
        """The per-step f32 scalars both the kernel and its plain version
        take (bias corrections computed once, on the host)."""
        if self.name != "adamw":
            raise NotImplementedError(f"optimizer {self.name!r} is not "
                                      "ported; only adamw")
        return adamw_scalars(step, lr, self.b1, self.b2, self.eps,
                             self.weight_decay)


def adamw_leaf(p, g, m, v, step, cfg: OptimizerConfig, lr):
    """Out-of-place AdamW on one leaf: the plain version, returns (p, m, v)."""
    return adamw_ref(p, g, m, v, cfg.scalars(step, lr))


def adamw_flat(p, g, m, v, step, cfg: OptimizerConfig, lr, scale=1.0):
    """Out-of-place AdamW on a flat bucket with the clip scale folded in."""
    return adamw_ref(p, g, m, v, cfg.scalars(step, lr), scale)


@dataclass
class TrainState:
    params: dict
    mu: dict
    nu: dict
    step: int


def init_state(params: dict) -> TrainState:
    return TrainState(
        params=params,
        mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        step=0)


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_scale(cfg: OptimizerConfig, grad_norm: float) -> float:
    """The global-norm clip factor as one f32 value, the same for trainer
    and shadow."""
    if not cfg.grad_clip:
        return 1.0
    return float(np.float32(min(1.0, cfg.grad_clip / (grad_norm + 1e-9))))


@torch.no_grad()
def apply_updates(state: TrainState, grads: dict, cfg: OptimizerConfig,
                  lr: float, scale: float = 1.0) -> TrainState:
    """One optimizer step over the whole tree, in place, one fused AdamW
    launch per leaf."""
    step = state.step + 1
    s = cfg.scalars(step, lr)
    for k, p in state.params.items():
        ops.fused_adamw_(p, grads[k], state.mu[k], state.nu[k], s, scale)
    state.step = step
    return state
