"""Shared layers of every family, the port of ``repro.models.layers``:
norms, RoPE, attention (training, prefill and decode), MLPs, embedding,
logits and loss.

Matmuls run in the config's compute dtype with f32 softmax and norm
statistics. Weights keep the JAX package's (d_in, d_out) layout, so a layer
is ``x @ w``.

The training forms take ``tp``, the rank's `repro_torch.dist
.tensor_parallel.ModelParallel` (None: the layer whole, as on one rank):
``attention_tp`` (heads or sequence rows over ``model``),
``cross_attention_tp`` (heads), ``mlp`` (ff columns), ``embed_tokens``
and ``lm_logits`` / ``xent_loss`` (vocab).
Serving over ``model`` uses ``attention_tp`` with ``prefill`` (the flash
forward alone, and k and v of every kv head for the cache) and
``attention_decode_tp`` (this rank's block of cache positions, its
partials joined by `tensor_parallel.flash_decode_combine`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as TP
from repro_torch.kernels import ops

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


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the flash kernel (o and lse) and whose
    backward (`ops.flash_attention_bwd`, a kernel too) recomputes the
    probabilities from lse. q: (b, sq, h, d); k, v: (b, skv, kv, d), kv
    dividing h; causal row i keeps the keys up to ``q_offset + i``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int = 0):
        o, lse = ops.flash_attention(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                             ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None


def attention_prefill(q, k, v, causal: bool, q_offset: int = 0):
    """Prefill attention: the flash kernel's forward ``o`` alone (no lse
    kept, nothing saved for a backward). The port's one counterpart of the
    reference's ``attention_qchunk`` and ``attention_tri``, which compute
    the same function (top-left causal or no mask). q: (b, sq, h, d);
    k, v: (b, skv, kv, d), kv dividing h; causal row i keeps the keys up
    to ``q_offset + i``."""
    offset = (q_offset,) if q_offset else ()
    o, _ = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal, *offset)
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


def attention_decode_partial(q, k_block, v_block, length: int):
    """`attention_decode`'s partials over one block of n cache positions,
    for `tensor_parallel.flash_decode_combine`: the same f32 scores, the
    positions at or past ``length`` (a host int counted from the block's
    first position; at most 0 masks the whole block) masked with _NEG,
    and ``p = exp(s - m)`` cast to the cache's dtype before ``p @ v``,
    which accumulates in f32. q: (b, 1, h, d); blocks: (b, n, kv, d).
    Returns f32 ``(m, l, o)``: the row max and the sum of ``p`` (b, kv,
    h/kv) and the unnormalised ``p @ v`` (b, kv, h/kv, d)."""
    b, _, h, d = q.shape
    n, kv = k_block.shape[1], k_block.shape[2]
    qg = q.reshape(b, kv, h // kv, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_block.float()) * (
        1.0 / math.sqrt(d))
    if length < n:
        keep = torch.arange(n, device=q.device) < length
        s = s.masked_fill(~keep, _NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_block.dtype).float(),
                     v_block.float())
    return m, p.sum(dim=-1), o


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


def _kv_cut(cfg, tp) -> bool:
    """Whether the spec cuts ``wk`` and ``wv`` on whole kv heads."""
    return tp.is_cut("wk") and cfg.num_kv_heads % tp.size == 0


def _kv_span(cfg, tp, hl: int) -> tuple:
    """``(lo, hi, idx)``: the kv heads lo..hi that this rank's ``hl`` q
    heads read, and the position of each q head's kv head among them, or
    None where they line up (each of them serves hl / (hi - lo + 1)
    consecutive q heads, as GQA expands them)."""
    g = cfg.num_heads // cfg.num_kv_heads
    first = tp.rank * hl
    lo, hi = first // g, (first + hl - 1) // g
    idx = [(first + i) // g - lo for i in range(hl)]
    n = hi - lo + 1
    if hl % n == 0 and idx == [i // (hl // n) for i in range(hl)]:
        idx = None
    return lo, hi, idx


def _kv_heads(x, lp, name: str, cfg, tp, hl: int):
    """k or v (``name`` "wk" / "wv") of this rank's ``hl`` q heads from
    the column-parallel input x: (b, s, n, hd) with n dividing hl. Where
    the spec cuts the leaf on whole kv heads those are this rank's own
    columns; else (a kv head cut inside, or the leaf whole) the leaf is
    taken whole (`tensor_parallel.whole`) and only the kv heads the q
    heads need are computed, one a q head where their groups do not line
    up."""
    b, s, _ = x.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    if _kv_cut(cfg, tp):
        return (x @ lp[name].to(x.dtype)).reshape(b, s, kv // tp.size, hd)
    lo, hi, idx = _kv_span(cfg, tp, hl)
    w = TP.whole(lp[name], name, -1, tp)
    t = (x @ w[:, lo * hd:(hi + 1) * hd].to(x.dtype)).reshape(
        b, s, hi - lo + 1, hd)
    return t if idx is None else t[:, :, idx]


def _rope(x, positions, cfg):
    """RoPE at ``positions``, or ``x`` as it is where they are None (the
    ViT)."""
    return x if positions is None else rope(x, positions, cfg.rope_theta)


def _kv_all(x, lp, cfg, tp, positions):
    """k (with RoPE unless ``positions`` is None) and v of every kv head
    from the leaves taken whole: (b, s, kv, hd) each."""
    b, s, _ = x.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    k, v = ((x @ TP.whole(lp[n], n, -1, tp).to(x.dtype)).reshape(
        b, s, kv, hd) for n in ("wk", "wv"))
    return _rope(k, positions, cfg).contiguous(), v.contiguous()


def attention_tp(xn, lp, cfg, positions, causal: bool, tp,
                 prefill: bool = False):
    """The attention of one layer over ``model`` from its normed input
    xn (b, s, d), without the residual; the reference's choice
    (``repro.models.transformer.attn_block``): heads cut over the ranks
    where they divide ``model``, else each rank's s/m query rows
    (sequence-sharded: ``wq`` and ``wo`` whole, K and V of every
    position, the flash kernel at ``q_offset`` = the rows' first
    position, the rows all-gathered after ``wo``); RoPE unless
    ``positions`` is None (the ViT). With ``prefill`` the flash forward
    alone (`attention_prefill`: no autograd graph), and
    ``(y, (k, v))`` with k and v at every kv head and position, the
    cache's entries: this rank's kv heads gathered over the group where
    the spec cuts them on whole heads, else the kv heads projected from
    the leaves taken whole, of which the attention reads its own."""
    b, s, _ = xn.shape
    h, hd, m = cfg.num_heads, cfg.head_dim, tp.size
    x = TP.copy_to_model(xn, tp)
    if h % m == 0:
        hl = h // m
        q = (x @ lp["wq"].to(x.dtype)).reshape(b, s, hl, hd)
        q = _rope(q, positions, cfg).contiguous()
        if prefill and not _kv_cut(cfg, tp):
            ka, va = _kv_all(x, lp, cfg, tp, positions)
            lo, hi, idx = _kv_span(cfg, tp, hl)
            k, v = (t[:, :, lo:hi + 1] if idx is None
                    else t[:, :, lo:hi + 1][:, :, idx] for t in (ka, va))
        else:
            k = _kv_heads(x, lp, "wk", cfg, tp, hl)
            v = _kv_heads(x, lp, "wv", cfg, tp, hl)
            k = _rope(k, positions, cfg).contiguous()
        if prefill:
            o = attention_prefill(q, k, v, causal)
            if _kv_cut(cfg, tp):
                ka, va = TP.gather_from_model(
                    torch.stack([k, v.contiguous()]), 3, tp).unbind(0)
        else:
            o = FlashAttention.apply(q, k, v.contiguous(), causal)
        y = TP.reduce_from_model(
            o.reshape(b, s, -1) @ lp["wo"].to(o.dtype), tp)
        return (y, (ka, va)) if prefill else y
    if s % m:
        raise ValueError(f"attention over model {m}: {h} heads and "
                         f"{s} positions, neither divides")
    sl = s // m
    first = tp.rank * sl
    rows = x.narrow(1, first, sl)
    wq = TP.whole(lp["wq"], "wq", -1, tp)
    wo = TP.whole(lp["wo"], "wo", 0, tp)
    q = (rows @ wq.to(x.dtype)).reshape(b, sl, h, hd)
    q = _rope(q, None if positions is None else positions.narrow(
        1, first, sl), cfg).contiguous()
    k, v = _kv_all(x, lp, cfg, tp, positions)
    if prefill:
        o = attention_prefill(q, k, v, causal, first)
    else:
        o = FlashAttention.apply(q, k, v, causal, first)
    y = TP.gather_rows(o.reshape(b, sl, -1) @ wo.to(o.dtype), 1, tp)
    return (y, (k, v)) if prefill else y


def cross_attention_tp(xn, memory, lp, cfg, tp, prefill: bool = False):
    """Cross-attention over ``model`` from the normed decoder input xn
    (b, s, d) to the encoder's memory (b, skv, d), without the residual:
    q, k and v column-parallel over this rank's h/m heads (``xwq``,
    ``xwk``, ``xwv``), the flash forward with no mask at sq != skv, and
    ``xwo`` row-parallel. The memory is a replicated activation every
    layer reads at its own heads, so it enters through
    `tensor_parallel.copy_to_model` (the gradient that reaches the
    encoder is the sum over the ranks' heads). With ``prefill`` the flash
    forward alone and ``(y, (k, v))`` with k and v at this rank's heads,
    the reference's cut of the cache (not gathered). Heads that do not
    divide ``model`` raise ``ValueError``."""
    b, s, _ = xn.shape
    h, hd, m = cfg.num_heads, cfg.head_dim, tp.size
    if h % m:
        raise ValueError(f"cross-attention over model {m}: its {h} heads "
                         f"do not divide")
    hl = h // m
    x = TP.copy_to_model(xn, tp)
    mem = TP.copy_to_model(memory, tp)
    q = (x @ lp["xwq"].to(x.dtype)).reshape(b, s, hl, hd).contiguous()
    k = (mem @ lp["xwk"].to(x.dtype)).reshape(b, -1, hl, hd).contiguous()
    v = (mem @ lp["xwv"].to(x.dtype)).reshape(b, -1, hl, hd).contiguous()
    if prefill:
        o = attention_prefill(q, k, v, False)
    else:
        o = FlashAttention.apply(q, k, v, False)
    y = TP.reduce_from_model(o.reshape(b, s, -1) @ lp["xwo"].to(o.dtype), tp)
    return (y, (k, v)) if prefill else y


def attention_decode_tp(xn, lp, kc, vc, pos: int, cfg, tp, first=None):
    """The attention of one decode token over ``model`` from its normed
    input xn (b, 1, d), without the residual. q, k and v are computed
    column-parallel and made whole by one all-gather (a leaf the spec
    leaves whole is computed whole); k and v are written at ``pos`` (a
    host int) into the caches kc, vc (b, n, kv, hd) where this rank holds
    that position. With ``first`` (the global position of this rank's
    block: the cache cut on ``kv_seq``) each rank attends over its block
    (`attention_decode_partial`) and the partials are joined
    (`tensor_parallel.flash_decode_combine`); with None (the cache whole
    on every rank) `attention_decode` over it. Then ``o`` is cut back to
    this rank's rows of ``wo`` for the row-parallel product."""
    b = xn.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    names = ("wq", "wk", "wv")
    cols = [xn @ lp[n].to(xn.dtype) for n in names]
    cut = [i for i, n in enumerate(names) if tp.is_cut(n)]
    if cut:
        for i, t in zip(cut, TP.gather_columns([cols[i] for i in cut], tp)):
            cols[i] = t
    positions = torch.full((b, 1), pos, device=xn.device)
    q = rope(cols[0].reshape(b, 1, h, hd), positions, cfg.rope_theta)
    k = rope(cols[1].reshape(b, 1, kv, hd), positions, cfg.rope_theta)
    v = cols[2].reshape(b, 1, kv, hd)
    start = 0 if first is None else first
    if start <= pos < start + kc.shape[1]:
        kc[:, pos - start] = k[:, 0]
        vc[:, pos - start] = v[:, 0]
    if first is None:
        o = attention_decode(q, kc, vc, length=pos + 1)
    else:
        o = TP.flash_decode_combine(
            *attention_decode_partial(q, kc, vc, pos + 1 - first), tp)
    o = o.reshape(b, 1, h * hd).to(q.dtype)
    if not tp.is_cut("wo"):
        return o @ lp["wo"].to(o.dtype)
    n = h * hd // tp.size
    return TP.reduce_from_model(
        o.narrow(-1, tp.rank * n, n) @ lp["wo"].to(o.dtype), tp)


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
