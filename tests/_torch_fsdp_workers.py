"""Rank workers of the per-layer FSDP test (tests/test_torch_fsdp_train.py;
spawned by ``tests/_torch_spawn.py``; no JAX here: spawn imports this
module).

`whole_tree_step` is the FSDP schedule the per-layer one replaced, written
out from the port's public pieces: every FSDP leaf gathered whole in f32
before the forward (`NamedSharding.gather_dp`), the whole tree cast to
the compute dtype and the loss taken (`registry.loss_fn`), every gradient
ring reduce-scattered after the backward (`ring_reduce_scatter_`; a leaf
with no cut all-reduced whole), and AdamW on the owned slices
(`update_`), ZeRO-1 leaves then ring all-gathered. `fsdp_schedule` runs it
and `build_train_step` side by side on four gloo ranks and writes what
each rank saw to ``rank<r>.pt``.
"""
import os

import torch
import torch.distributed as dist

from _torch_dp_workers import SEQ, _captured_run, lr_fn

from repro_torch import configs as TC
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.dist.collectives import (ring_all_gather_,
                                          ring_all_reduce_rs_ag,
                                          ring_reduce_scatter_)
from repro_torch.dist.sharding import Mesh, ShardingRules, dp_axes, dp_size
from repro_torch.models import registry
from repro_torch.optim.functional import (OptimizerConfig, clip_scale,
                                          sharded_global_norm, update_)
from repro_torch.train.step import (build_train_step, make_train_state,
                                    model_size, state_sharding)

# the clip binds, so the grad norm reaches the update
OPT = OptimizerConfig(lr=1e-3, eps=1e-5, grad_clip=0.5)
BATCH, STEPS = 16, 3
# tag -> (arch, mesh, overrides of .reduced()): tinyllama with every
# ``wemb`` dim over four dp ranks; arctic on (2, 2), its experts over
# model and their ``wemb`` dim over data (the leaves cut twice), 4 layers;
# then one config of every other family on (4, 1), each through its own
# layer loops (hybrid's segments and shared block, the audio encoder and
# decoder, the vlm's patches, the ViT head, granite's gelu2 MLP)
CASES = {"dense": ("tinyllama-1.1b", (4, 1), {}),
         "moe": ("arctic-480b", (2, 2), {"num_layers": 4}),
         "ssm": ("mamba2-2.7b", (4, 1), {}),
         "hybrid": ("zamba2-1.2b", (4, 1), {}),
         "audio": ("whisper-medium", (4, 1), {}),
         "vlm": ("llava-next-mistral-7b", (4, 1), {}),
         "vit": ("vit-h-14", (4, 1), {"family": "vit"}),
         "gelu2": ("granite-34b", (4, 1), {})}
# the cases also captured into a shadow
CAPTURED = ("dense", "moe")


def case_cfg(tag: str, **over):
    arch, _, kw = CASES[tag]
    return TC.get(arch).reduced(fsdp=True, **{**kw, **over})


def _to_front(t, d):
    return t.movedim(d, 0).contiguous()


def whole_tree_step(cfg, opt, lr_fn, rules):
    """train_step(state, batch) -> (state, metrics, owned) of the
    whole-tree schedule (the module docstring), with the per-layer step's
    signature and results."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    sh = state_sharding(cfg, rules)
    mesh = rules.mesh
    dp = dp_axes(mesh)
    n, m = dp_size(mesh), model_size(cfg, rules)
    group = mesh.group_over(dp)
    first = mesh.coordinate(dp) == 0
    first_model = m == 1 or mesh.coordinate("model") == 0
    counted = {k for k, z in sh.state.items()
               if (z.n > 1 or first) and (z.m > 1 or first_model)}
    norm_group = group if m == 1 else mesh.mesh_group

    def step(state, batch):
        full = {k: sh.params[k].gather_dp(p).detach().requires_grad_(True)
                for k, p in state.params.items()}
        mb = cfg.microbatches
        per = next(iter(batch.values())).shape[0] // mb
        grads, loss = None, None
        for i in range(mb):
            one = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            l = registry.loss_fn({k: p.to(cd) for k, p in full.items()},
                                 cfg, one, rules=rules)
            g = torch.autograd.grad(l, list(full.values()))
            if grads is None:
                grads, loss = dict(zip(full, g)), l.detach()
            else:
                for k, gi in zip(full, g):
                    grads[k].add_(gi)
                loss = loss + l.detach()
        del full
        if mb > 1:
            d = torch.full((), mb, dtype=torch.float32, device=loss.device)
            grads = {k: g.div_(d) for k, g in grads.items()}
            loss = loss / d
        nt = torch.full((), n, dtype=torch.float32, device=loss.device)
        owned = {}
        for k, g in grads.items():
            z = sh.state[k]
            if z.n == 1:
                owned[k] = ring_all_reduce_rs_ag(g, mesh, dp)[0].div_(nt)
                continue
            front = _to_front(g, z.dim)
            chunk = ring_reduce_scatter_(front.reshape(n, -1), mesh, dp)
            owned[k] = chunk.div_(nt).reshape(
                (front.shape[0] // n,) + front.shape[1:]) \
                .movedim(0, z.dim).contiguous()
        dist.all_reduce(loss, group=group)
        loss = loss / nt
        gnorm = sharded_global_norm(owned, counted, norm_group)
        lr = float(lr_fn(state.step))
        scale = clip_scale(opt, float(gnorm)) if opt.grad_clip else 1.0
        t = state.step + 1
        with torch.no_grad():
            for k, p in state.params.items():
                ps, z = sh.params[k], sh.state[k]
                if z.n == 1 or ps.n > 1:
                    update_(p, owned[k], state.mu[k], state.nu[k], t, opt,
                            lr, scale)
                    continue
                mine = z.dp_local(p).contiguous()
                update_(mine, owned[k], state.mu[k], state.nu[k], t, opt,
                        lr, scale)
                acc = torch.empty((n, p.numel() // n), dtype=p.dtype,
                                  device=p.device)
                acc[mesh.coordinate(dp)].copy_(
                    _to_front(mine, z.dim).reshape(-1))
                ring_all_gather_(acc, mesh, dp)
                p.copy_(acc.reshape((p.shape[z.dim],) + tuple(
                    s for j, s in enumerate(p.shape) if j != z.dim))
                    .movedim(0, z.dim))
        state.step = t
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                       "grad_scale": scale}, owned
    return step


def _steps(step, cfg, rules, out, tag):
    """``STEPS`` of ``step`` from seed 0's state: each step's loss, grad
    norm and owned slices, and the local state after them."""
    state = make_train_state(cfg, 0, "cpu", rules)
    stream = SyntheticStream(cfg, BATCH, SEQ, seed=0)
    for t in range(STEPS):
        state, met, owned = step(state, device_batch(
            stream.batch_at(t), "cpu", rules, cfg.microbatches))
        out[f"{tag}/loss/{t}"] = met["loss"]
        out[f"{tag}/gnorm/{t}"] = met["grad_norm"]
        out[f"{tag}/owned/{t}"] = owned
    out[f"{tag}/state"] = {"params": state.params, "mu": state.mu,
                           "nu": state.nu, "step": state.step}


def fsdp_schedule(rank, out_dir):
    """Each case at microbatches 1 through the per-layer step and the
    whole-tree one; then, for the captured cases, the per-layer step's
    capture into a shadow at microbatches 2."""
    out = {}
    for tag, (_, shape, _) in CASES.items():
        rules = ShardingRules(Mesh.over_ranks(shape, ("data", "model"),
                                              device="cpu"), fsdp=True)
        cfg = case_cfg(tag)
        assert cfg.microbatches == 1
        sh = state_sharding(cfg, rules)
        out[f"{tag}/fsdp_leaves"] = sorted(k for k, ps in sh.params.items()
                                           if ps.n > 1)
        _steps(build_train_step(cfg, OPT, lr_fn, rules), cfg, rules, out,
               f"{tag}/layer")
        _steps(whole_tree_step(cfg, OPT, lr_fn, rules), cfg, rules, out,
               f"{tag}/tree")
        if tag in CAPTURED:
            _captured_run(case_cfg(tag, microbatches=2), rules,
                          make_train_state(case_cfg(tag), 0, "cpu", rules),
                          STEPS, out, f"{tag}/capture", opt=OPT)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
