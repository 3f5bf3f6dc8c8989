"""Train, prefill and decode steps, the port of ``repro.train.step``.

``build_train_step``: microbatch gradient accumulation, the captured
gradients returned as an output (the Checkmate capture point), and the
optimizer update as one fused AdamW launch per leaf — the kernel the
shadow runs per bucket. ``build_prefill_step`` and ``build_decode_step``:
the serving steps, greedy.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
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


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

# leaves serving reads in f32 (norm weights, and the SSM's dt_bias and
# A_log); every other leaf is cast to the compute dtype where it is used
F32_IN_SERVING = ("norm", "dt_bias", "A_log")


def serving_params(cfg: ModelConfig, params: dict) -> dict:
    """The f32 params with every leaf serving casts to the compute dtype
    at its use (matmul and embedding weights, conv kernels, D) cast once
    here: bitwise the same results, without a cast per decode step. Norm
    weights, dt_bias and A_log stay f32, as serving reads them."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    return {k: p if k.endswith(F32_IN_SERVING) else p.to(cd)
            for k, p in params.items()}


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig):
    """prefill_step(params, inputs) -> (cache, logits): inputs holds
    ``tokens`` and, for audio and vlm, ``frames`` / ``patch_embeds``; the
    cache is sized to ``shape.seq_len``."""
    def prefill_step(params: dict, inputs: dict):
        extra = {k: v for k, v in inputs.items() if k != "tokens"}
        return registry.prefill(params, cfg, inputs["tokens"],
                                shape.seq_len, **extra)
    return prefill_step


def build_decode_step(cfg: ModelConfig, greedy: bool = True):
    """serve_step(params, cache, token) -> (next token (b, 1) int64,
    cache): the argmax of the last position's logits (the first maximum,
    as ``jnp.argmax``)."""
    if not greedy:
        raise ValueError("only greedy decode is ported (the JAX package's "
                         "decode step is greedy too)")

    def serve_step(params: dict, cache: dict, token):
        logits, cache = registry.decode_step(params, cfg, cache, token)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache
    return serve_step
