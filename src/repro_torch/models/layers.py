"""Shared layers of every family, the port of ``repro.models.layers``:
norms, RoPE, attention (training, prefill and decode), MLPs, embedding,
logits and loss.

Matmuls run in the config's compute dtype with f32 softmax and norm
statistics. Weights keep the JAX package's (d_in, d_out) layout, so a layer
is ``x @ w``.

The training forms take ``tp``, the rank's `repro_torch.dist
.tensor_parallel.ModelParallel` (None: the layer whole, as on one rank):
``attention_tp`` (heads or sequence rows over ``model``), ``mlp`` (ff
columns), ``embed_tokens`` and ``lm_logits`` / ``xent_loss`` (vocab).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as TP
from repro_torch.kernels import ops
from repro_torch.kernels.ref import causal_mask, expand_kv

_NEG = -1e30


def rmsnorm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs          # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool,
                        q_offset: int = 0):
    """Recompute-from-lse backward (the rule of ``repro.models.layers
    ._flash_bwd``, its ``q_offset`` too) in plain PyTorch, with GQA kv:
    the expanded kv's gradients are summed back over each kv head's
    group."""
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


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the flash kernel (o and lse) and whose
    backward recomputes the probabilities from lse. q: (b, sq, h, d);
    k, v: (b, skv, kv, d), kv dividing h; causal row i keeps the keys up
    to ``q_offset + i``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int = 0):
        o, lse = ops.flash_attention(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None


def attention_prefill(q, k, v, causal: bool):
    """Prefill attention: the flash kernel's forward ``o`` alone (no lse
    kept, nothing saved for a backward). The port's one counterpart of the
    reference's ``attention_qchunk`` and ``attention_tri``, which compute
    the same function (top-left causal or no mask). q: (b, sq, h, d);
    k, v: (b, skv, kv, d), kv dividing h."""
    o, _ = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal)
    return o


def attention_decode(q, k_cache, v_cache, length=None):
    """One query position against a cache, in plain PyTorch (the reference
    computes it outside any kernel too). q: (b, 1, h, d); caches:
    (b, S, kv, d) with kv dividing h, contracted per kv head's group of
    query heads (the function of expanding them first). Scores and softmax
    in f32; positions at or past ``length`` (a host int) masked with _NEG;
    the probabilities cast to the cache's dtype before ``p @ v``, which
    accumulates in f32."""
    b, _, h, d = q.shape
    S, kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kv, h // kv, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * (1.0 / math.sqrt(d))
    if length is not None:
        keep = torch.arange(S, device=q.device) < length
        s = s.masked_fill(~keep, _NEG)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgs,bskd->bkgd", p.float(), v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def attn_project_qkv(x, lp, cfg, positions):
    """q, k, v of one attention layer, contiguous; RoPE unless
    ``positions`` is None (ViT)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ lp["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ lp["wk"].to(x.dtype)).reshape(b, s, kv, hd)
    v = (x @ lp["wv"].to(x.dtype)).reshape(b, s, kv, hd)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _kv_heads(x, lp, name: str, cfg, tp, hl: int):
    """k or v (``name`` "wk" / "wv") of this rank's ``hl`` q heads from
    the column-parallel input x: (b, s, n, hd) with n dividing hl. Where
    the spec cuts the leaf on whole kv heads those are this rank's own
    columns; else (a kv head cut inside, or the leaf whole) the leaf is
    taken whole (`tensor_parallel.whole`) and only the kv heads the q
    heads need are computed, one a q head where their groups do not line
    up."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if tp.is_cut(name) and kv % tp.size == 0:
        return (x @ lp[name].to(x.dtype)).reshape(b, s, kv // tp.size, hd)
    g = h // kv
    first = tp.rank * hl
    lo, hi = first // g, (first + hl - 1) // g
    w = TP.whole(lp[name], name, -1, tp)
    t = (x @ w[:, lo * hd:(hi + 1) * hd].to(x.dtype)).reshape(
        b, s, hi - lo + 1, hd)
    idx = [(first + i) // g - lo for i in range(hl)]
    n = hi - lo + 1
    if hl % n == 0 and idx == [i // (hl // n) for i in range(hl)]:
        return t
    return t[:, :, idx]


def attention_tp(xn, lp, cfg, positions, causal: bool, tp):
    """The attention of one layer over ``model`` from its normed input
    xn (b, s, d), without the residual; the reference's choice
    (``repro.models.transformer.attn_block``): heads cut over the ranks
    where they divide ``model``, else each rank's s/m query rows
    (sequence-sharded: ``wq`` and ``wo`` whole, K and V of every
    position, the flash kernel at ``q_offset`` = the rows' first
    position, the rows all-gathered after ``wo``)."""
    b, s, _ = xn.shape
    h, hd, m = cfg.num_heads, cfg.head_dim, tp.size
    x = TP.copy_to_model(xn, tp)
    if h % m == 0:
        hl = h // m
        q = (x @ lp["wq"].to(x.dtype)).reshape(b, s, hl, hd)
        k = _kv_heads(x, lp, "wk", cfg, tp, hl)
        v = _kv_heads(x, lp, "wv", cfg, tp, hl)
        q = rope(q, positions, cfg.rope_theta).contiguous()
        k = rope(k, positions, cfg.rope_theta).contiguous()
        o = FlashAttention.apply(q, k, v.contiguous(), causal)
        return TP.reduce_from_model(
            o.reshape(b, s, -1) @ lp["wo"].to(o.dtype), tp)
    if s % m:
        raise ValueError(f"attention over model {m}: {h} heads and "
                         f"{s} positions, neither divides")
    sl = s // m
    first = tp.rank * sl
    rows = x.narrow(1, first, sl)
    wq = TP.whole(lp["wq"], "wq", -1, tp)
    wo = TP.whole(lp["wo"], "wo", 0, tp)
    kv = cfg.num_kv_heads
    q = (rows @ wq.to(x.dtype)).reshape(b, sl, h, hd)
    k = (x @ TP.whole(lp["wk"], "wk", -1, tp).to(x.dtype)).reshape(
        b, s, kv, hd)
    v = (x @ TP.whole(lp["wv"], "wv", -1, tp).to(x.dtype)).reshape(
        b, s, kv, hd)
    q = rope(q, positions.narrow(1, first, sl), cfg.rope_theta).contiguous()
    k = rope(k, positions, cfg.rope_theta).contiguous()
    o = FlashAttention.apply(q, k, v.contiguous(), causal, first)
    return TP.gather_rows(o.reshape(b, sl, -1) @ wo.to(o.dtype), 1, tp)


def mlp(x, lp, cfg, tp=None):
    """The MLP of ``cfg.mlp``; with ``tp`` and the ff columns cut over
    ``model``, column-parallel up (and gate), row-parallel down."""
    if tp is None or not tp.is_cut("w_up"):
        return (mlp_swiglu if cfg.mlp == "swiglu" else mlp_gelu2)(x, lp)
    x = TP.copy_to_model(x, tp)
    y = (mlp_swiglu if cfg.mlp == "swiglu" else mlp_gelu2)(x, lp)
    return TP.reduce_from_model(y, tp)


def mlp_gelu2(x, lp):
    """GPT-BigCode-style 2-matrix MLP (granite-34b). The GELU is the tanh
    form: ``jax.nn.gelu``'s default, where PyTorch's is the erf form."""
    h = x @ lp["w_up"].to(x.dtype)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ lp["w_down"].to(x.dtype)


def mlp_swiglu(x, lp):
    g = x @ lp["w_gate"].to(x.dtype)
    u = x @ lp["w_up"].to(x.dtype)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ lp["w_down"].to(x.dtype)


def embed_tokens(embed, tokens, compute_dtype: torch.dtype, tp=None):
    """The token embeddings; with ``tp`` (the vocab cut over ``model``)
    the vocab-parallel lookup."""
    if tp is not None:
        return TP.vocab_embed(embed, tokens, compute_dtype, tp)
    # F.embedding, not embed[tokens]: on the CPU the indexing's backward
    # accumulates repeated rows with atomic adds across threads, in an
    # order that changes from run to run, and a replayed step must be
    # bitwise the step it replays
    return torch.nn.functional.embedding(tokens, embed).to(compute_dtype)


def lm_logits(x, unembed, tp=None):
    """Logits; with ``tp`` (the vocab cut over ``model``) this rank's
    vocab columns, column-parallel."""
    if tp is not None:
        x = TP.copy_to_model(x, tp)
    return x @ unembed.to(x.dtype)


def xent_loss(logits, labels, tp=None):
    """Mean next-token cross entropy; with ``tp``, of vocab-parallel
    logits (`tensor_parallel.vocab_xent`)."""
    if tp is not None:
        return TP.vocab_xent(logits, labels, tp)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(lse - ll)
