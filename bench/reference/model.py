"""The plain reference of the benchmark's configurations: the training
step of a dense decoder (``family: dense``) and of a ViT encoder
(``family: vit``) in float32, written from the architectures'
descriptions with the departures each configuration file lists, and
AdamW.

Plain PyTorch: explicit softmax attention, no kernel, no cache, no fused
operation, TF32 off. It imports nothing of the program. It reads the
configuration's ``model`` group, the weights and the batches of
`inputs`, and the optimizer settings of the traffic file.

The batch is processed in blocks of rows, each layer recomputed in the
backward (``torch.utils.checkpoint``), so that a full-size step fits on
the card beside nothing else; the loss of the batch is the mean over all
its rows, which the blocks add up to.

``precision="fp8"`` is the control: every matrix product, forward and
backward, takes its operands rounded to float8 e4m3 (one scale per
operand, its largest magnitude at 448), the nearest precision below the
bf16 the configurations compute in. Two planted faults, the reference
put in the program's place: ``rows="half"`` takes the step's loss and
gradients over the first half of the rows only, and ``update=False``
returns the state unchanged from every step (its optimizer state then
holds no gradient, and nothing moves).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.inputs import (LAYER_KEYS, batch_at, iter_params,
                                    make_params, param_layout,
                                    probe_indices)

FP8_MAX = 448.0


def _q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, back in f32."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    s = amax / FP8_MAX
    return (x.float() / s).to(torch.float8_e4m3fn).float() * s


class _Fp8MatMul(torch.autograd.Function):
    """``a @ b`` with both operands of each product in float8, the
    gradient products too."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g)
        ga = (qg @ qb.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        gb = (qa.transpose(-1, -2) @ qg).sum_to_size(ctx.shapes[1])
        return ga, gb


def _matmul(precision: str):
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8MatMul.apply
    raise ValueError(f"precision {precision!r}: f32 or fp8")


@contextlib.contextmanager
def strict_f32():
    """TF32 off for the duration (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotary positions 0..s-1 on x (b, s, h, d), the halves rotated as
    pairs (i, i + d/2)."""
    s, half = x.shape[1], x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(xn, lp, model, mm, causal: bool, rotary: bool):
    b, s, _ = xn.shape
    h, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    q = mm(xn, lp["wq"]).view(b, s, h, hd)
    k = mm(xn, lp["wk"]).view(b, s, kv, hd)
    v = mm(xn, lp["wv"]).view(b, s, kv, hd)
    if rotary:
        q, k = rope(q, model["rope_theta"]), rope(k, model["rope_theta"])
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (b, h, s, hd)
    scores = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=xn.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1), v)
    return mm(o.transpose(1, 2).reshape(b, s, h * hd), lp["wo"])


def block(x, lp, model, mm, causal, rotary):
    eps = model["norm_eps"]
    x = x + attention(rmsnorm(x, lp["attn_norm"], eps), lp, model, mm,
                      causal, rotary)
    hmid = F.gelu(mm(rmsnorm(x, lp["mlp_norm"], eps), lp["w_up"]),
                  approximate="tanh")
    return x + mm(hmid, lp["w_down"])


def loss_of(params: dict, model: dict, rows: dict, mm) -> torch.Tensor:
    """The mean cross entropy over ``rows`` (tensors on the device)."""
    dense = model["family"] == "dense"
    if dense:
        x = F.embedding(rows["tokens"], params["embed"])
    else:
        x = rows["patch_embeds"]
    stacked = [params[k].unbind(0) for k in LAYER_KEYS]
    for ws in zip(*stacked):
        x = checkpoint(
            lambda x, *w: block(x, dict(zip(LAYER_KEYS, w)), model, mm,
                                causal=dense, rotary=dense),
            x, *ws, use_reentrant=False)
    x = rmsnorm(x, params["final_norm"], model["norm_eps"])
    if dense:
        unembed = (params["embed"].T if model.get("tie_embeddings")
                   else params["unembed"])
        logits = mm(x, unembed)
        labels = rows["labels"]
    else:
        logits = mm(x.mean(dim=1), params["head"])
        labels = rows["labels"][:, 0]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def _rows_on(batch: dict, lo: int, hi: int, device) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
        out[k] = t.to(device=device, dtype=torch.float32
                      if t.dtype.is_floating_point else torch.int64)
    return out


def adamw_(p, g, m, v, step: int, opt: dict):
    """One decoupled-weight-decay AdamW update in place, in f32."""
    b1, b2 = opt["b1"], opt["b2"]
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    den = (v / (1 - b2 ** step)).sqrt_().add_(opt["eps"])
    upd = (m / (1 - b1 ** step)).div_(den).add_(p, alpha=opt["weight_decay"])
    p.sub_(upd, alpha=opt["lr"])


def train_reference(model: dict, traffic: dict, seed: int, device,
                    steps: int = 3, precision: str = "f32",
                    rows: str = "all", update: bool = True) -> dict:
    """``steps`` AdamW steps of ``model`` from the seed's weights on the
    seed's batches. Returns the loss of each step, the norm of each leaf's
    first gradient and its elements at `probe_indices` (on the host), and
    the norm of each leaf's change after the last step."""
    mm = _matmul(precision)
    opt = traffic["optimizer"]
    bsz, seq = traffic["batch"], traffic["seq"]
    use = bsz if rows == "all" else bsz // 2
    blk = max(1, bsz // traffic["microbatches"])
    layout = param_layout(model)
    probe = probe_indices(layout, seed)
    losses, grad_norms, grad_probe = [], None, None
    with strict_f32():
        params = make_params(layout, seed, device)
        for p in params.values():
            p.requires_grad_(True)
        mom = {k: torch.zeros_like(p) for k, p in params.items()}
        vel = {k: torch.zeros_like(p) for k, p in params.items()}
        for step in range(steps):
            batch = batch_at(model, bsz, seq, seed, step)
            total = 0.0
            for lo in range(0, use, blk):
                hi = min(use, lo + blk)
                part = loss_of(params, model, _rows_on(batch, lo, hi, device),
                               mm) * ((hi - lo) / use)
                part.backward()
                total += float(part.detach())
                del part
            losses.append(total)
            with torch.no_grad():
                if grad_norms is None:
                    # the first gradient as the optimizer's state holds it:
                    # none where the step leaves the state unchanged
                    grads = {k: p.grad if update else torch.zeros_like(p)
                             for k, p in params.items()}
                    grad_norms = {k: float(torch.linalg.vector_norm(g))
                                  for k, g in grads.items()}
                    grad_probe = {k: g.reshape(-1)[probe[k].to(device)].cpu()
                                  for k, g in grads.items()}
                    del grads
                for k, p in params.items():
                    if update:
                        adamw_(p, p.grad, mom[k], vel[k], step + 1, opt)
                    p.grad = None
        del mom, vel
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(params[k] - p0))
                      for k, p0 in iter_params(layout, seed, device)}
    return {"losses": losses, "grad_norms": grad_norms,
            "grad_probe": grad_probe, "change_norms": change}
