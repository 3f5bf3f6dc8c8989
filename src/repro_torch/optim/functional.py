"""Functional optimizers (the paper's §4.2.4 requirement), as plain functions
on tensors — the port of ``repro.optim.functional``.

Each parameter's update is an elementwise function of (param, grad,
moments, step), so any contiguous slice of any leaf can be updated on its
own. The trainer (per leaf) and the shadow (per flat bucket) run the same
update with the same host-computed f32 scalars, so their states are
bit-identical by construction: AdamW through the fused AdamW kernel, Adam
and SGD through the plain elementwise functions below (the JAX package
computes those two in jnp, outside any Pallas kernel). Every flat function
forms ``g * scale`` first, so the trainer's per-leaf call and the shadow's
per-bucket call run the same operations in the same order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed

from repro_torch.kernels import ops
from repro_torch.kernels.ref import adamw_ref, adamw_scalars


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adam | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9          # sgd
    grad_clip: float = 0.0         # 0 = off (global-norm clip)

    def __post_init__(self):
        if self.name not in UPDATE_FNS:
            raise ValueError(f"unknown optimizer {self.name!r}; "
                             f"one of {sorted(UPDATE_FNS)}")

    def scalars(self, step: int, lr: float):
        """The per-step f32 scalars (bias corrections computed once, on the
        host) that AdamW's kernel and every plain update take."""
        return adamw_scalars(step, lr, self.b1, self.b2, self.eps,
                             self.weight_decay)


def _scaled(g, scale):
    return g.float() * float(np.float32(scale))


def _adam(p, g, m, v, step, cfg: OptimizerConfig, lr):
    """Adam without weight decay on an f32 gradient already scaled; the
    divisors are tensors on the data's device, as in `adamw_ref`."""
    s = cfg.scalars(step, lr)
    p32 = p.float()
    bc1 = torch.full((), s.bc1, dtype=torch.float32, device=p.device)
    bc2 = torch.full((), s.bc2, dtype=torch.float32, device=p.device)
    m_new = m * s.b1 + g * s.omb1
    v_new = v * s.b2 + (g * s.omb2) * g
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + s.eps)
    return (p32 - upd * s.lr).to(p.dtype), m_new, v_new


def _sgd(p, g, m, v, cfg: OptimizerConfig, lr):
    """SGD with momentum on an f32 gradient already scaled; ``v`` is
    returned as it came."""
    m_new = m * float(np.float32(cfg.momentum)) + g
    return (p.float() - m_new * float(np.float32(lr))).to(p.dtype), m_new, v


# -- per-leaf updates (out of place; the JAX package's UPDATE_FNS) -----------

def adamw_leaf(p, g, m, v, step, cfg: OptimizerConfig, lr):
    """Out-of-place AdamW on one leaf: the plain version, returns (p, m, v)."""
    return adamw_ref(p, g, m, v, cfg.scalars(step, lr))


def adam_leaf(p, g, m, v, step, cfg: OptimizerConfig, lr):
    return _adam(p, g.float(), m, v, step, cfg, lr)


def sgd_leaf(p, g, m, v, step, cfg: OptimizerConfig, lr):
    del step
    return _sgd(p, g.float(), m, v, cfg, lr)


UPDATE_FNS = {"adamw": adamw_leaf, "adam": adam_leaf, "sgd": sgd_leaf}


# -- flat (wire-layout) updates: the clip scale folded into the same pass ---

def adamw_flat(p, g, m, v, step, cfg: OptimizerConfig, lr, scale=1.0):
    """Out-of-place AdamW on a flat bucket with the clip scale folded in."""
    return adamw_ref(p, g, m, v, cfg.scalars(step, lr), scale)


def adam_flat(p, g, m, v, step, cfg: OptimizerConfig, lr, scale=1.0):
    return _adam(p, _scaled(g, scale), m, v, step, cfg, lr)


def sgd_flat(p, g, m, v, step, cfg: OptimizerConfig, lr, scale=1.0):
    return _sgd(p, _scaled(g, scale), m, v, cfg, lr)


UPDATE_FNS_FLAT = {"adamw": adamw_flat, "adam": adam_flat, "sgd": sgd_flat}


def update_(p, g, m, v, step, cfg: OptimizerConfig, lr, scale=1.0):
    """One update of (p, m, v) in place with gradient ``g * scale``: one
    fused AdamW kernel launch for ``adamw``, the plain flat update for the
    others. The trainer calls it per leaf, the shadow per bucket."""
    if cfg.name == "adamw":
        return ops.fused_adamw_(p, g, m, v, cfg.scalars(step, lr), scale)
    pn, mn, vn = UPDATE_FNS_FLAT[cfg.name](p, g, m, v, step, cfg, lr, scale)
    p.copy_(pn)
    m.copy_(mn)
    if vn is not v:
        v.copy_(vn)
    return p, m, v


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


def sharded_global_norm(owned: dict, counted, group) -> torch.Tensor:
    """The global norm of a gradient tree split over the ranks of
    ``group``: each rank sums the squares of the leaves of ``owned`` whose
    names are in ``counted`` (its slices, and a leaf held whole along an
    axis of the mesh on the first rank along it only, so that each
    element of the global tree is counted once over the whole mesh), and
    one all-reduce adds the ranks' sums."""
    some = next(iter(owned.values()))
    sq = torch.zeros((), dtype=torch.float32, device=some.device)
    for k, x in owned.items():
        if k in counted:
            sq = sq + torch.sum(torch.square(x.float()))
    torch.distributed.all_reduce(sq, group=group)
    return torch.sqrt(sq)


def clip_scale(cfg: OptimizerConfig, grad_norm: float) -> float:
    """The global-norm clip factor as one f32 value, the same for trainer
    and shadow."""
    if not cfg.grad_clip:
        return 1.0
    return float(np.float32(min(1.0, cfg.grad_clip / (grad_norm + 1e-9))))


@torch.no_grad()
def apply_updates(state: TrainState, grads: dict, cfg: OptimizerConfig,
                  lr: float, scale: float = 1.0) -> TrainState:
    """One optimizer step over the whole tree, in place, one `update_` per
    leaf (for AdamW one fused kernel launch per leaf)."""
    step = state.step + 1
    for k, p in state.params.items():
        update_(p, grads[k], state.mu[k], state.nu[k], step, cfg, lr, scale)
    state.step = step
    return state
