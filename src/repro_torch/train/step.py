"""Train step, the port of ``repro.train.step.build_train_step``: microbatch
gradient accumulation, the captured gradients returned as an output (the
Checkmate capture point), and the optimizer update as one fused AdamW
launch per leaf — the kernel the shadow runs per bucket.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.device import resolve
from repro_torch.models import registry
from repro_torch.optim.functional import (OptimizerConfig, TrainState,
                                          apply_updates, clip_scale,
                                          global_norm, init_state)


def make_train_state(cfg: ModelConfig, seed: int = 0,
                     device=None) -> TrainState:
    """Fresh random params (from ``seed``) and zero moments on ``device``."""
    return init_state(registry.init_params(cfg, seed, resolve(device)))


def build_train_step(cfg: ModelConfig, opt: OptimizerConfig,
                     lr_fn: Callable):
    """Returns train_step(state, batch) -> (state, metrics, grads).

    The state is updated in place. ``grads`` are the f32 gradients the
    update applied (sum over microbatches, then divided by their count, as
    the JAX step does); ``metrics`` holds the loss and grad norm as device
    scalars and the lr and clip scale as the host floats that were applied.
    """
    cd = TORCH_DTYPES[cfg.compute_dtype]

    def loss_of(params, microbatch):
        # cast the whole tree to the compute dtype before the layers
        return registry.loss_fn({k: p.to(cd) for k, p in params.items()},
                                cfg, microbatch)

    def train_step(state: TrainState, batch: dict):
        mb = cfg.microbatches
        names = list(state.params)
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in state.params.items()}
        bsz = next(iter(batch.values())).shape[0]
        if bsz % mb:
            raise ValueError(f"batch {bsz} not divisible by {mb} "
                             f"microbatches")
        per = bsz // mb
        grads, loss = None, None
        for i in range(mb):
            one = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            l = loss_of(leaves, one)
            g = torch.autograd.grad(l, [leaves[k] for k in names])
            if grads is None:
                grads, loss = dict(zip(names, g)), l.detach()
            else:
                for k, gi in zip(names, g):
                    grads[k].add_(gi)
                loss = loss + l.detach()
            del g, l
        if mb > 1:
            n = torch.full((), mb, dtype=torch.float32, device=loss.device)
            grads = {k: g.div_(n) for k, g in grads.items()}
            loss = loss / n
        gnorm = global_norm(grads)
        lr = float(lr_fn(state.step))
        scale = clip_scale(opt, float(gnorm)) if opt.grad_clip else 1.0
        apply_updates(state, grads, opt, lr, scale)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "grad_scale": scale}
        return state, metrics, grads

    return train_step
