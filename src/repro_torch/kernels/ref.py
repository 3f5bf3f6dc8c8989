"""Plain PyTorch versions of the port's kernels.

Each is the function its kernel computes, written with ordinary tensor
operations. The wrappers run them for tensors on the CPU; on the card they
are what the kernels are held against.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_NEG = -1e30       # the reference's mask value in the flash backward


class AdamWScalars(NamedTuple):
    """Per-step AdamW scalars, each rounded to f32 once on the host.

    The kernel and the plain version take these same values, so neither
    computes ``b1 ** step`` on its own.
    """
    b1: float
    omb1: float          # 1 - b1
    b2: float
    omb2: float          # 1 - b2
    bc1: float           # 1 - b1 ** step
    bc2: float           # 1 - b2 ** step
    lr: float
    eps: float
    wd: float


def adamw_scalars(step, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1
                  ) -> AdamWScalars:
    f = np.float32
    one, st = f(1.0), f(step)
    return AdamWScalars(
        b1=float(f(b1)), omb1=float(f(1.0 - b1)),
        b2=float(f(b2)), omb2=float(f(1.0 - b2)),
        bc1=float(one - f(b1) ** st), bc2=float(one - f(b2) ** st),
        lr=float(f(lr)), eps=float(f(eps)), wd=float(f(wd)))


def adamw_ref(p, g, m, v, s: AdamWScalars, scale: float = 1.0):
    """One AdamW update in f32; returns (p', m', v') with p' in p's dtype.

    Written as separate elementwise operations in the kernel's order, so no
    two of them fuse into one rounding. The divisors are tensors on the
    data's device: PyTorch's CUDA division by a host scalar multiplies by
    its reciprocal, which rounds differently from a true division.
    """
    gs = g.float() * float(np.float32(scale))
    p32 = p.float()
    bc1 = torch.full((), s.bc1, dtype=torch.float32, device=p.device)
    bc2 = torch.full((), s.bc2, dtype=torch.float32, device=p.device)
    m_new = m * s.b1 + gs * s.omb1
    v_new = v * s.b2 + (gs * s.omb2) * gs
    den = torch.sqrt(v_new / bc2) + s.eps
    upd = (m_new / bc1) / den + p32 * s.wd
    return (p32 - upd * s.lr).to(p.dtype), m_new, v_new


def expand_kv(k, heads: int):
    """(b, s, kv, d) -> (b, s, heads, d) by GQA group repeat."""
    kv = k.shape[2]
    return k if kv == heads else torch.repeat_interleave(k, heads // kv, dim=2)


def causal_mask(sq: int, skv: int, device, q_offset: int = 0
                ) -> torch.Tensor:
    """Top-left causal mask (qpos >= kpos), as the Pallas kernel masks,
    with the queries at absolute positions ``q_offset + i`` (the
    reference's ``flash_attention_jnp`` offset): row i keeps the keys up
    to ``q_offset + i``."""
    return (torch.arange(sq, device=device)[:, None] + q_offset
            >= torch.arange(skv, device=device)[None, :])


def flash_attention_ref(q, k, v, causal: bool = True, q_offset: int = 0):
    """q: (b, sq, h, d); k, v: (b, skv, kv, d), kv dividing h; causal
    row i keeps the keys up to ``q_offset + i``.

    Returns (o in q's dtype, lse (b, h, sq) in f32).
    """
    h, d = q.shape[2], q.shape[3]
    ke = expand_kv(k, h).float()
    ve = expand_kv(v, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke) * (1.0 / math.sqrt(d))
    if causal:
        s = s.masked_fill(~causal_mask(q.shape[1], k.shape[1], q.device,
                                       q_offset), float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    lse = m + torch.log(l)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l[..., None], ve)
    return o.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool,
                            q_offset: int = 0):
    """Recompute-from-lse backward (the rule of ``repro.models.layers
    ._flash_bwd``, its ``q_offset`` too) in plain PyTorch, with GQA kv:
    the expanded kv's gradients are summed back over each kv head's
    group. q, o, do: (b, sq, h, d); k, v: (b, skv, kv, d); lse: (b, h, sq)
    f32. Returns (dq, dk, dv) in the inputs' dtypes."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    ke, ve = expand_kv(k, h), expand_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke.float()) * scale
    if causal:
        s = s.masked_fill(~causal_mask(sq, skv, q.device, q_offset), _NEG)
    p = torch.exp(s - lse[..., None])                       # recomputed
    del s
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), ve.float())
    delta = torch.sum(do.float() * o.float(), dim=-1)       # (b, sq, h)
    ds = (p * (dp - delta.transpose(1, 2)[..., None]) * scale).to(q.dtype)
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, ke)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    if kv != h:
        g = h // kv
        dk = dk.float().reshape(b, skv, kv, g, d).sum(3).to(k.dtype)
        dv = dv.float().reshape(b, skv, kv, g, d).sum(3).to(v.dtype)
    return dq, dk, dv


def bucket_pack_ref(leaves, offsets, out):
    """Write each raveled leaf into ``out`` at its element offset."""
    for leaf, off in zip(leaves, offsets):
        out[off:off + leaf.numel()] = leaf.reshape(-1)
    return out
