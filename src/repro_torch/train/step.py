"""Train, prefill and decode steps, the port of ``repro.train.step``.

``build_train_step``: microbatch gradient accumulation, the captured
gradients returned as an output (the Checkmate capture point), and the
optimizer update as one fused AdamW launch per leaf — the kernel the
shadow runs per bucket. ``build_prefill_step`` and ``build_decode_step``:
the serving steps, greedy.

On ``rules`` over n > 1 dp ranks (one process per rank) a step is the
reference's GSPMD step written out: the local forward and backward over
each microbatch of this rank's rows; the ring reduce-scatter of each leaf
onto its ZeRO-1 slice (the leaf viewed with its ZeRO-1 dim in front, so
the ring's owned chunk *is* the slice; a leaf with no dim that splits is
all-reduced whole, as the reference leaves it replicated); the division
by n; fused AdamW on the owned slices of params, mu and nu; the ring
all-gather of the params. FSDP leaves (``rules.fsdp``: the ``wemb`` dim
cut over the dp ranks) stay f32 slices between steps and are gathered
where they are read, as the reference's GSPMD gathers them inside its
layer scan: each layer's slice of a stacked leaf is cast to the compute
dtype and all-gathered just before that layer runs and again in its
remat recompute (`repro_torch.dist.sharding.gather_per_layer`, applied by
`repro_torch.models.transformer.run_layers`), a leaf outside the stacks
once per microbatch; each gradient is upcast to f32 and ring
reduce-scattered onto the slice as soon as the backward is done with it,
once per microbatch. No full-width f32 copy of an FSDP leaf, nor of its
gradient, is ever live, and nothing is gathered after the update. The
reduced slices are the capture point: each rank returns the ones it
owns. At n = 1 the step runs today's kernels in today's order.

For a tensor-parallel family (`registry.TENSOR_PARALLEL`: all seven) on a
mesh whose ``model`` extent m is above 1, each rank holds its model slice
of every leaf the spec cuts over ``model`` (heads, kv heads, ff, vocab,
experts, the SSM's ``ssm_inner``); the forward and backward run the
layers of `repro_torch.dist.tensor_parallel` on those slices, and the
dp reduce-scatter, the update and the all-gather above run on them as on
whole leaves (the ZeRO-1 dim is another dim than the model cut). The
grad norm sums each element of the global tree once over the whole mesh:
a leaf whole over ``model`` on model rank 0 only.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import obs as _obs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.device import resolve
from repro_torch.dist.collectives import (ring_all_gather_,
                                          ring_all_reduce_rs_ag,
                                          ring_reduce_scatter_)
from repro_torch.dist.sharding import (dp_axes, dp_size, fsdp_gather,
                                       gather_per_layer)
from repro_torch.models import registry
from repro_torch.optim.functional import (OptimizerConfig, TrainState,
                                          apply_updates, clip_scale,
                                          global_norm, init_state,
                                          sharded_global_norm, update_)
from repro_torch.optim.sharded import StateSharding


def state_sharding(cfg: ModelConfig, rules) -> StateSharding:
    """Where each leaf of ``cfg``'s trainer state lives under ``rules``
    (cut over ``model`` too for a tensor-parallel family)."""
    return StateSharding(registry.param_specs(cfg), rules, zero1=cfg.zero1,
                         model=registry.tensor_parallel(cfg))


def model_size(cfg: ModelConfig, rules) -> int:
    """The ``model`` extent ``cfg``'s layers are split over under
    ``rules`` (1 for a family outside `registry.TENSOR_PARALLEL`, which
    would compute each layer whole)."""
    if rules is None or not registry.tensor_parallel(cfg):
        return 1
    return rules.mesh.shape.get("model", 1)


def make_train_state(cfg: ModelConfig, seed: int = 0, device=None,
                     rules=None) -> TrainState:
    """Fresh random params (from ``seed``) and zero moments on ``device``;
    on ``rules`` over more than one rank, this rank's slices of them."""
    state = init_state(registry.init_params(cfg, seed, resolve(device)))
    if rules is None or (dp_size(rules.mesh) == 1
                         and model_size(cfg, rules) == 1):
        return state
    p, m, v = state_sharding(cfg, rules).local(state.params, state.mu,
                                               state.nu)
    return TrainState(params=p, mu=m, nu=v, step=0)


def abstract_train_state(cfg: ModelConfig, rules) -> TrainState:
    """The trainer state as meta tensors at this rank's local shapes (the
    dry run's stand-in, the port of the reference's): params as
    `registry.abstract_params`, mu and nu f32 at their ZeRO-1 (or FSDP)
    slices of `state_sharding`, step 0."""
    sh = state_sharding(cfg, rules)

    def moment(k):
        return torch.empty(sh.state[k].local_shape(sh.shapes[k]),
                           dtype=torch.float32, device="meta")
    params = registry.abstract_params(cfg, rules)
    return TrainState(params=params, mu={k: moment(k) for k in params},
                      nu={k: moment(k) for k in params}, step=0)


def _to_front(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` with dim ``d`` moved to the front, contiguous."""
    return t.movedim(d, 0).contiguous()


def build_train_step(cfg: ModelConfig, opt: OptimizerConfig,
                     lr_fn: Callable, rules=None):
    """Returns train_step(state, batch) -> (state, metrics, grads).

    The state is updated in place. ``grads`` are the f32 gradients the
    update applied (sum over microbatches, then divided by their count, as
    the JAX step does; over n > 1 dp ranks, this rank's reduced ZeRO-1
    slices, and the whole reduced leaf where nothing is cut; an FSDP
    leaf's reduced per layer and microbatch in the backward, the others
    after it; over m > 1
    model ranks, of the leaves' model slices); ``metrics``
    holds the loss and grad norm as device scalars (over ranks, their
    global values) and the lr and clip scale as the host floats that were
    applied. ``train_step.sharding`` is the `StateSharding` of ``rules``
    (None without rules).
    """
    cd = TORCH_DTYPES[cfg.compute_dtype]
    n = 1 if rules is None else dp_size(rules.mesh)
    m = model_size(cfg, rules)
    group_rules = rules if n > 1 or m > 1 else None
    stacked = {k for k, ps in registry.param_specs(cfg).items()
               if ps.logical[:1] == ("layers",)}

    def loss_of(params, microbatch, fsdp):
        """The loss of one microbatch. A leaf of ``fsdp`` ({name: its
        NamedSharding}) is gathered in the compute dtype where it is read:
        a stacked one a layer at a time, any other once, here; every
        other leaf is cast whole to the compute dtype before the layers."""
        tree, per_layer = {}, []
        for k, p in params.items():
            if k not in fsdp:
                tree[k] = p.to(cd)
            elif k in stacked:
                tree[k] = p
                per_layer.append((p, fsdp[k]))
            else:
                tree[k] = fsdp_gather(p, fsdp[k], fsdp[k].dim, cd)
        with gather_per_layer(per_layer, cd):
            return registry.loss_fn(tree, cfg, microbatch,
                                    rules=group_rules)

    def local_grads(params: dict, batch: dict, fsdp: dict, step: int):
        """f32 gradients and loss of this rank's rows, averaged over the
        microbatches; a leaf of ``fsdp``'s gradient is its slice, reduced
        over the dp ranks in each microbatch's backward. Each microbatch's
        forward and backward (the accumulation included) are the spans
        ``step.forward`` and ``step.backward`` of iteration ``step``."""
        tracer = _obs.get().tracer
        mb = cfg.microbatches
        names = list(params)
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        bsz = next(iter(batch.values())).shape[0]
        if bsz % mb:
            raise ValueError(f"batch {bsz} not divisible by {mb} "
                             f"microbatches")
        per = bsz // mb
        grads, loss = None, None
        for i in range(mb):
            one = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            with tracer.span("step.forward", args={"step": step}):
                l = loss_of(leaves, one, fsdp)
            with tracer.span("step.backward", args={"step": step}):
                g = torch.autograd.grad(l, [leaves[k] for k in names])
                if grads is None:
                    grads, loss = dict(zip(names, g)), l.detach()
                else:
                    for k, gi in zip(names, g):
                        grads[k].add_(gi)
                    loss = loss + l.detach()
            del g, l
        if mb > 1:
            d = torch.full((), mb, dtype=torch.float32, device=loss.device)
            grads = {k: g.div_(d) for k, g in grads.items()}
            loss = loss / d
        return grads, loss

    def train_step(state: TrainState, batch: dict):
        step = state.step + 1
        grads, loss = local_grads(state.params, batch, {}, step)
        with _obs.get().tracer.span("step.optimizer", args={"step": step}):
            gnorm = global_norm(grads)
            lr = float(lr_fn(state.step))
            scale = clip_scale(opt, float(gnorm)) if opt.grad_clip else 1.0
            apply_updates(state, grads, opt, lr, scale)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "grad_scale": scale}
        return state, metrics, grads

    if n == 1 and m == 1:
        train_step.sharding = (None if rules is None
                               else state_sharding(cfg, rules))
        return train_step

    sh = state_sharding(cfg, rules)
    mesh = rules.mesh
    dp = dp_axes(mesh)
    group = mesh.group_over(dp)
    first = mesh.coordinate(dp) == 0
    first_model = m == 1 or mesh.coordinate("model") == 0
    for k, z in sh.state.items():
        if z.n > 1 and z.axes != dp:
            raise ValueError(f"{k}: state cut over {z.axes}, not {dp}")
    # a rank sums the squares of its slices, of a leaf whole over dp only
    # where it is the first dp rank, and of a leaf whole over model only
    # where it is the first model rank
    counted = {k for k, z in sh.state.items()
               if (z.n > 1 or first) and (z.m > 1 or first_model)}
    norm_group = group if m == 1 else mesh.mesh_group
    # the FSDP leaves, gathered where the loss reads them
    fsdp = {k: ps for k, ps in sh.params.items() if ps.n > 1}

    def dp_train_step(state: TrainState, batch: dict):
        if "mask" in batch:
            raise ValueError("a masked batch over more than one rank needs "
                             "the global mask count; no stream has a mask")
        step = state.step + 1
        grads, loss = local_grads(state.params, batch, fsdp, step)
        nt = torch.full((), n, dtype=torch.float32, device=loss.device)
        owned = {}
        for k in list(grads):
            g, z = grads.pop(k), sh.state[k]
            if n == 1:             # model ranks alone: nothing to reduce
                owned[k] = g
                continue
            if k in fsdp:          # reduced in the backward, layer by layer
                owned[k] = g.div_(nt)
                continue
            if z.n == 1:           # replicated: all-reduced whole
                owned[k] = ring_all_reduce_rs_ag(g, mesh, dp)[0].div_(nt)
                continue
            d = z.dim
            front = _to_front(g, d)
            del g
            chunk = ring_reduce_scatter_(front.reshape(n, -1), mesh, dp)
            chunk.div_(nt)
            owned[k] = chunk.reshape((front.shape[0] // n,)
                                     + front.shape[1:]).movedim(0, d) \
                .contiguous()
            del front, chunk
        if n > 1:
            dist.all_reduce(loss, group=group)
            loss = loss / nt
        with _obs.get().tracer.span("step.optimizer", args={"step": step}):
            gnorm = sharded_global_norm(owned, counted, norm_group)
            lr = float(lr_fn(state.step))
            scale = clip_scale(opt, float(gnorm)) if opt.grad_clip else 1.0
            with torch.no_grad():
                for k, p in state.params.items():
                    ps, z = sh.params[k], sh.state[k]
                    if z.n == 1 or ps.n > 1:
                        # replicated, or an FSDP slice: the update is local
                        update_(p, owned[k], state.mu[k], state.nu[k], step,
                                opt, lr, scale)
                        continue
                    # ZeRO-1: update this rank's slice, then gather the
                    # params
                    d = z.dim
                    mine = z.dp_local(p).contiguous()
                    update_(mine, owned[k], state.mu[k], state.nu[k], step,
                            opt, lr, scale)
                    acc = torch.empty((n, p.numel() // n), dtype=p.dtype,
                                      device=p.device)
                    acc[mesh.coordinate(dp)].copy_(
                        _to_front(mine, d).reshape(-1))
                    ring_all_gather_(acc, mesh, dp)
                    p.copy_(acc.reshape((p.shape[d],) + tuple(
                        s for j, s in enumerate(p.shape) if j != d))
                        .movedim(0, d))
        state.step = step
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "grad_scale": scale}
        return state, metrics, owned

    dp_train_step.sharding = sh
    return dp_train_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

# leaves serving reads in f32 (norm weights, and the SSM's dt_bias and
# A_log); every other leaf is cast to the compute dtype where it is used
F32_IN_SERVING = ("norm", "dt_bias", "A_log")


def serving_params(cfg: ModelConfig, params: dict, rules=None) -> dict:
    """The f32 params with every leaf serving casts to the compute dtype
    at its use (matmul and embedding weights, conv kernels, D) cast once
    here: bitwise the same results, without a cast per decode step. Norm
    weights, dt_bias and A_log stay f32, as serving reads them. Under
    ``rules`` where serving runs over ``model``
    (`registry.serving_shardings`), this rank's slices, cut before the
    cast into tensors of their own (no view keeps the whole leaf)."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    shardings = registry.serving_shardings(cfg, rules)
    if shardings is not None:
        params = {k: p if shardings[k].local(p) is p
                  else shardings[k].local(p).clone()
                  for k, p in params.items()}
    return {k: p if k.endswith(F32_IN_SERVING) else p.to(cd)
            for k, p in params.items()}


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, rules=None):
    """prefill_step(params, inputs) -> (cache, logits): inputs holds
    ``tokens`` and, for audio and vlm, ``frames`` / ``patch_embeds``; the
    cache is sized to ``shape.seq_len``. Under ``rules``, this rank's
    part (`registry.prefill`)."""
    def prefill_step(params: dict, inputs: dict):
        extra = {k: v for k, v in inputs.items() if k != "tokens"}
        return registry.prefill(params, cfg, inputs["tokens"],
                                shape.seq_len, rules=rules, **extra)
    return prefill_step


def build_decode_step(cfg: ModelConfig, rules=None, greedy: bool = True):
    """serve_step(params, cache, token) -> (next token (b, 1) int64,
    cache): the argmax of the last position's logits (the first maximum,
    as ``jnp.argmax``; over the whole vocab where ``rules`` cut it,
    `registry.greedy_token`)."""
    if not greedy:
        raise ValueError("only greedy decode is ported (the JAX package's "
                         "decode step is greedy too)")

    def serve_step(params: dict, cache: dict, token):
        logits, cache = registry.decode_step(params, cfg, cache, token,
                                             rules)
        return registry.greedy_token(cfg, logits, rules), cache
    return serve_step
