"""Plain PyTorch versions of the port's three kernels.

Each is the function its kernel computes, written with ordinary tensor
operations. The wrappers run them for tensors on the CPU; on the card they
are what the kernels are held against.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


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


def causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    """Top-left causal mask (qpos >= kpos), as the Pallas kernel masks."""
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(skv, device=device)[None, :])


def flash_attention_ref(q, k, v, causal: bool = True):
    """q: (b, sq, h, d); k, v: (b, skv, kv, d), kv dividing h.

    Returns (o in q's dtype, lse (b, h, sq) in f32).
    """
    h, d = q.shape[2], q.shape[3]
    ke = expand_kv(k, h).float()
    ve = expand_kv(v, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke) * (1.0 / math.sqrt(d))
    if causal:
        s = s.masked_fill(~causal_mask(q.shape[1], k.shape[1], q.device),
                          float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    lse = m + torch.log(l)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l[..., None], ve)
    return o.to(q.dtype), lse


def bucket_pack_ref(leaves, offsets, out):
    """Write each raveled leaf into ``out`` at its element offset."""
    for leaf, off in zip(leaves, offsets):
        out[off:off + leaf.numel()] = leaf.reshape(-1)
    return out
