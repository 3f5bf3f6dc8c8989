"""Mamba2 / SSD (state-space duality) blocks, the attention-free LM family:
the port of ``repro.models.ssm`` (training, prefill and decode).

The chunked SSD algorithm (arXiv:2405.21060): a quadratic path inside each
chunk, and a linear recurrence over the chunks' states. The short causal
conv on x, B and C is depthwise, as unrolled taps. Decode is one step of
the recurrence per token against a cache of each layer's SSD state (f32)
and the last ``ssm_conv - 1`` inputs of each conv (compute dtype),
updated in place.

One departure from the reference: ``ssd_chunked`` masks the intra-chunk
decay exponent *before* the exponential. The reference takes
``exp(cum_q - cum_k)`` over the whole chunk and masks the product after;
above the diagonal that exponent is positive, and once a chunk's summed
|dt * A| passes about 88 it overflows to inf, and inf * 0 is NaN. Where the
reference is finite both give the same values; where it is NaN (the
published chunk of 256 at full width) the port stays finite.

Training and serving take ``rules``: on a mesh whose ``model`` extent m is
above 1 a rank holds ``ssm_heads / m`` of the SSD heads (the leaves the
specs cut on ``ssm_inner``: ``wz``, ``wx`` and ``wdt`` column-parallel,
``conv_x``, ``A_log``, ``D``, ``dt_bias`` and ``gate_norm`` its slices,
``w_out`` row-parallel, ending in `tensor_parallel.reduce_from_model`);
``ssd_chunked`` runs unchanged on the local heads, a batch dim of every
einsum. ``wB``, ``wC``, ``conv_B`` and ``conv_C`` are whole on every rank:
B and C are computed from the normed input, convolved and gated, and only
then enter the model-parallel region (`tensor_parallel.copy_to_model`),
so that those leaves' gradients are the sum over the ranks' heads. The
reference's docstring calls the block communication-free except the
out-projection's reduce; its GSPMD step adds a second reduction all the
same, and so does the port: the gated norm is an RMS norm over the whole
``d_inner``, so its mean of squares is the ranks' sums of squares summed
over the group (`tensor_parallel.sum_over_model`, an all-reduce in the
forward and in the backward) over the full ``d_inner``. In serving a
rank's cache holds its heads' SSD state (b, h/m, n, p) and its
``d_inner / m`` columns of the x conv's tail; the B and C tails are whole,
each rank updating its own copy identically. The embedding and logits
are vocab-parallel where the vocab divides m, whole elsewhere. Heads that
do not divide m raise ``ValueError``. With no rules, or m = 1, the block
is the plain one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.dist import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ParamSpec


def layer_param_specs(cfg: ModelConfig, n_layers: int, stacked=True) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    n, g, h = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    w = cfg.ssm_conv
    lead = (n_layers,) if stacked else ()
    lax_ = ("layers",) if stacked else ()

    def S(shape, logical, **kw):
        return ParamSpec(lead + shape, lax_ + logical, **kw)
    return {
        "ssm_norm": S((d,), ("unsharded",), init="ones"),
        "wz": S((d, din), ("wemb", "ssm_inner")),
        "wx": S((d, din), ("wemb", "ssm_inner")),
        "wB": S((d, g * n), ("wemb", "unsharded")),
        "wC": S((d, g * n), ("wemb", "unsharded")),
        "wdt": S((d, h), ("wemb", "ssm_inner")),
        "conv_x": S((w, din), ("unsharded", "ssm_inner"), init="normal"),
        "conv_B": S((w, g * n), ("unsharded", "unsharded"), init="normal"),
        "conv_C": S((w, g * n), ("unsharded", "unsharded"), init="normal"),
        "A_log": S((h,), ("ssm_inner",), init="ssm_a"),
        "D": S((h,), ("ssm_inner",), init="ones"),
        "dt_bias": S((h,), ("ssm_inner",), init="ssm_dt"),
        "gate_norm": S((din,), ("ssm_inner",), init="ones"),
        "w_out": S((din, d), ("ssm_inner", "wemb")),
    }


def param_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "embed": ParamSpec((v, d), ("vocab", "wemb"), init="normal"),
        "final_norm": ParamSpec((d,), ("unsharded",), init="ones"),
        "unembed": ParamSpec((d, v), ("wemb", "vocab")),
    }
    specs.update(layer_param_specs(cfg, cfg.num_layers))
    return specs


SSM_LAYER_KEYS = tuple(layer_param_specs(
    ModelConfig("x", "ssm", 1, 64, 0, 0, 0, 16, ssm_state=8), 1).keys())


def causal_conv(x, kernel):
    """x: (b, s, c); kernel: (w, c). Left-padded causal depthwise conv."""
    w = kernel.shape[0]
    out = x * kernel[-1]
    for t in range(1, w):
        shifted = F.pad(x, (0, 0, t, 0))[:, :-t]
        out = out + shifted * kernel[-1 - t]
    return out


def conv_step(x_t, conv_cache, kernel):
    """x_t: (b, c); conv_cache: (b, w-1, c) holding the last w-1 inputs.
    Returns (y_t, the cache shifted by one with x_t last)."""
    hist = torch.cat([conv_cache, x_t[:, None]], dim=1)          # (b, w, c)
    y = torch.einsum("bwc,wc->bc", hist, kernel)
    return y, hist[:, 1:]


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h) (post-softplus, f32); A: (h,) negative
    f32; B, C: (b, s, n) (groups=1, shared across heads). Returns
    (y, final_state) with y: (b, s, h, p) in x's dtype, final_state:
    (b, h, n, p) f32. Products of bf16 inputs accumulate in f32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    if s % q:
        q = s
    nc = s // q

    xr = x.reshape(b, nc, q, h, p).float()
    dtr = dt.reshape(b, nc, q, h)
    Br = B.reshape(b, nc, q, n).float()
    Cr = C.reshape(b, nc, q, n).float()

    dA = dtr * A                                      # (b,nc,q,h), negative
    cum = torch.cumsum(dA, dim=2)                     # within-chunk cumulative

    # --- intra-chunk (quadratic within chunk); masked before the exp ---
    CB = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    expo = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (b,nc,q,k,h)
    decay = torch.exp(torch.where(mask[None, None, :, :, None], expo,
                                  float("-inf")))
    att = CB[..., None] * decay
    y_intra = torch.einsum("bcqkh,bckh,bckhp->bcqhp", att, dtr, xr)

    # --- chunk states ---
    last = cum[:, :, -1:, :]                          # (b,nc,1,h)
    decay_out = torch.exp(last - cum)                 # (b,nc,q,h)
    S_c = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Br, decay_out * dtr, xr)
    chunk_decay = torch.exp(last[:, :, 0])            # (b,nc,h)

    # --- inter-chunk recurrence ---
    S = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_c[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)             # (b,nc,h,n,p)

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cr, torch.exp(cum),
                           S_prevs)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), S


def ssd_decode_step(x_t, dt_t, A, B_t, C_t, S):
    """One recurrence step. x_t: (b, h, p); dt_t: (b, h) f32; A: (h,) f32;
    B_t, C_t: (b, n); S: (b, h, n, p) f32 -> (y_t in x_t's dtype, S').
    Products in f32, as the reference's mixed-dtype einsums promote."""
    dA = torch.exp(dt_t * A)                                     # (b, h)
    dBx = torch.einsum("bn,bh,bhp->bhnp", B_t.float(), dt_t, x_t.float())
    S = S * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), S)
    return y.to(x_t.dtype), S


def _softplus(dt, bias):
    """``jax.nn.softplus(dt + bias)`` in f32: logaddexp(x, 0), with no
    threshold (the bias stays f32, as the reference adds it)."""
    dt = dt.float() + bias.float()
    return torch.logaddexp(dt, torch.zeros_like(dt))


def tp_context(cfg: ModelConfig, rules):
    """The tensor-parallel context of ``rules`` for ``cfg``'s leaves (None
    without rules or at ``model`` extent 1)."""
    return checked_heads(cfg, TP.context(rules, param_specs(cfg)))


def checked_heads(cfg: ModelConfig, tp):
    """``tp``, once the SSD heads are known to divide its ``model``
    extent (no branch cuts a head: ``ValueError`` otherwise)."""
    if tp is not None and cfg.ssm_heads % tp.size:
        raise ValueError(f"the SSM over model {tp.size}: its "
                         f"{cfg.ssm_heads} heads do not divide")
    return tp


def _gate_norm_tp(y, w, cfg: ModelConfig, tp):
    """`layers.rmsnorm` over the whole ``d_inner`` of this rank's columns
    y: the mean of squares from the group's summed sums of squares."""
    dt = y.dtype
    y = y.float()
    ss = TP.sum_over_model(torch.sum(y * y, dim=-1, keepdim=True), tp)
    y = y * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (y * w.float()).to(dt)


def _gate_out(x, y, z, lp: dict, cfg: ModelConfig, tp=None):
    """The gated norm and the out-projection with the residual; with
    ``tp``, the norm over the group's columns and ``w_out`` row-parallel."""
    cd = x.dtype
    g = y * F.silu(z.float()).to(cd)
    if tp is None:
        y = L.rmsnorm(g, lp["gate_norm"], cfg.norm_eps)
        return x + y @ lp["w_out"].to(cd)
    y = _gate_norm_tp(g, lp["gate_norm"], cfg, tp)
    return x + TP.reduce_from_model(y @ lp["w_out"].to(cd), tp)


def _heads(cfg: ModelConfig, tp) -> int:
    return cfg.ssm_heads if tp is None else cfg.ssm_heads // tp.size


def mamba_block(x, lp: dict, cfg: ModelConfig, *, prefill=False, tp=None):
    """Full-sequence block. x: (b, s, d) -> (b, s, d); with ``prefill``
    also the layer's cache entries: (x, (final SSD state, the last w-1
    rows of the pre-conv x, B and C projections)). With ``tp``, this
    rank's heads (the module docstring)."""
    b, s, d = x.shape
    h, p = _heads(cfg, tp), cfg.ssm_head_dim
    cd = x.dtype
    xn = L.rmsnorm(x, lp["ssm_norm"], cfg.norm_eps)
    xc = xn if tp is None else TP.copy_to_model(xn, tp)
    z = xc @ lp["wz"].to(cd)
    xi0 = xc @ lp["wx"].to(cd)
    Bp0 = xn @ lp["wB"].to(cd)
    Cp0 = xn @ lp["wC"].to(cd)
    dt = xc @ lp["wdt"].to(cd)
    xi = F.silu(causal_conv(xi0, lp["conv_x"].to(cd)).float()).to(cd)
    Bp = F.silu(causal_conv(Bp0, lp["conv_B"].to(cd)).float()).to(cd)
    Cp = F.silu(causal_conv(Cp0, lp["conv_C"].to(cd)).float()).to(cd)
    if tp is not None:
        Bp, Cp = TP.copy_to_model(Bp, tp), TP.copy_to_model(Cp, tp)
    dt = _softplus(dt, lp["dt_bias"])
    A = -torch.exp(lp["A_log"].float())
    y, S = ssd_chunked(xi.reshape(b, s, h, p), dt, A, Bp, Cp, cfg.ssm_chunk)
    y = y + xi.reshape(b, s, h, p) * lp["D"].to(cd)[:, None]
    out = _gate_out(x, y.reshape(b, s, -1), z, lp, cfg, tp)
    if not prefill:
        return out
    w = cfg.ssm_conv
    return out, (S, xi0[:, -(w - 1):], Bp0[:, -(w - 1):], Cp0[:, -(w - 1):])


def mamba_decode_block(x, lp: dict, state, conv_cache: dict,
                       cfg: ModelConfig, tp=None):
    """x: (b, 1, d); state: (b, h, n, p); conv_cache: {"x", "B", "C"}
    each (b, w-1, c). Returns (x', state', conv caches'). With ``tp``,
    this rank's heads: its state (b, h/m, n, p) and x conv columns."""
    b = x.shape[0]
    h, p = _heads(cfg, tp), cfg.ssm_head_dim
    cd = x.dtype
    xn = L.rmsnorm(x, lp["ssm_norm"], cfg.norm_eps)[:, 0]        # (b, d)
    z = xn @ lp["wz"].to(cd)
    xi = xn @ lp["wx"].to(cd)
    Bp = xn @ lp["wB"].to(cd)
    Cp = xn @ lp["wC"].to(cd)
    dt = xn @ lp["wdt"].to(cd)
    xi, cx = conv_step(xi, conv_cache["x"], lp["conv_x"].to(cd))
    Bp, cB = conv_step(Bp, conv_cache["B"], lp["conv_B"].to(cd))
    Cp, cC = conv_step(Cp, conv_cache["C"], lp["conv_C"].to(cd))
    xi = F.silu(xi.float()).to(cd)
    Bp = F.silu(Bp.float()).to(cd)
    Cp = F.silu(Cp.float()).to(cd)
    dt = _softplus(dt, lp["dt_bias"])
    A = -torch.exp(lp["A_log"].float())
    y, state = ssd_decode_step(xi.reshape(b, h, p), dt, A, Bp, Cp, state)
    y = y + xi.reshape(b, h, p) * lp["D"].to(cd)[:, None]
    out = _gate_out(x, y.reshape(b, 1, -1), z[:, None], lp, cfg, tp)
    return out, state, {"x": cx, "B": cB, "C": cC}


def _stacked(params: dict) -> dict:
    return {k: params[k] for k in SSM_LAYER_KEYS if k in params}


def forward(params: dict, cfg: ModelConfig, tokens, tp=None):
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    x = T.run_layers(x, _stacked(params),
                     lambda x, lp: mamba_block(x, lp, cfg, tp=tp), cfg.remat)
    return T.final_logits(x, params, cfg, tp)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, rules=None):
    """The mean loss of this rank's rows; under ``rules`` with a ``model``
    extent above 1, tensor-parallel."""
    tp = tp_context(cfg, rules)
    return L.xent_loss(forward(params, cfg, batch["tokens"], tp),
                       batch["labels"], T.vocab_tp(tp))


CONV_KEYS = (("conv_x", "x"), ("conv_B", "B"), ("conv_C", "C"))


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    din, gn, w = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_conv
    lgl = ("layers", "batch", None, "ssm_inner")
    return {
        "state": ParamSpec((cfg.num_layers, batch, h, n, p),
                           ("layers", "batch", "ssm_inner", None, None),
                           init="zeros"),
        "conv_x": ParamSpec((cfg.num_layers, batch, w - 1, din), lgl,
                            init="zeros", dtype=cfg.compute_dtype),
        "conv_B": ParamSpec((cfg.num_layers, batch, w - 1, gn),
                            ("layers", "batch", None, None),
                            init="zeros", dtype=cfg.compute_dtype),
        "conv_C": ParamSpec((cfg.num_layers, batch, w - 1, gn),
                            ("layers", "batch", None, None),
                            init="zeros", dtype=cfg.compute_dtype),
    }


def prefill_layers(x, layers, cfg: ModelConfig, tp=None):
    """Mamba layers over the prompt, each keeping its cache entries:
    (x, [per layer (state, conv_x tail, conv_B tail, conv_C tail)])."""
    entries = []
    for lp in layers:
        x, entry = mamba_block(x, lp, cfg, prefill=True, tp=tp)
        entries.append(entry)
    return x, entries


def ssm_cache(entries: list, length: int) -> dict:
    """The cache dict from per-layer entries, stacked on a layer axis."""
    names = ("state",) + tuple(name for name, _ in CONV_KEYS)
    cache = {name: torch.stack([e[i] for e in entries])
             for i, name in enumerate(names)}
    cache["length"] = length
    return cache


def decode_layers(x, layers, cache: dict, first: int, cfg, tp=None):
    """Mamba decode through ``layers``, the cache's layers ``first`` on;
    each layer's state and conv caches are written back in place."""
    for j, lp in enumerate(layers):
        i = first + j
        conv = {c: cache[name][i] for name, c in CONV_KEYS}
        x, S, conv = mamba_decode_block(x, lp, cache["state"][i], conv, cfg,
                                        tp)
        cache["state"][i] = S
        for name, c in CONV_KEYS:
            cache[name][i] = conv[c]
    return x


def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int,
            rules=None):
    """Run the prompt through SSD, keeping each layer's final state and
    conv tails (the state does not grow with ``max_seq``); under
    ``rules`` with a ``model`` extent above 1, this rank's heads and
    vocab columns."""
    del max_seq
    tp = tp_context(cfg, rules)
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    x, entries = prefill_layers(x, T.serving_layers(_stacked(params)), cfg,
                                tp)
    return (ssm_cache(entries, tokens.shape[1]),
            T.final_logits(x[:, -1:], params, cfg, tp))


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token,
                rules=None):
    tp = tp_context(cfg, rules)
    x = L.embed_tokens(params["embed"], token,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    x = decode_layers(x, T.serving_layers(_stacked(params)), cache, 0, cfg,
                      tp)
    return (T.final_logits(x, params, cfg, tp),
            dict(cache, length=cache["length"] + 1))
