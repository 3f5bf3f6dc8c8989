"""Mamba2 / SSD (state-space duality) blocks, the attention-free LM family:
the port of ``repro.models.ssm``'s training path.

The chunked SSD algorithm (arXiv:2405.21060): a quadratic path inside each
chunk, and a linear recurrence over the chunks' states. The short causal
conv on x, B and C is depthwise, as unrolled taps.

One departure from the reference: ``ssd_chunked`` masks the intra-chunk
decay exponent *before* the exponential. The reference takes
``exp(cum_q - cum_k)`` over the whole chunk and masks the product after;
above the diagonal that exponent is positive, and once a chunk's summed
|dt * A| passes about 88 it overflows to inf, and inf * 0 is NaN. Where the
reference is finite both give the same values; where it is NaN (the
published chunk of 256 at full width) the port stays finite.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
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


def mamba_block(x, lp: dict, cfg: ModelConfig):
    """Full-sequence block. x: (b, s, d) -> (b, s, d)."""
    b, s, d = x.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    cd = x.dtype
    xn = L.rmsnorm(x, lp["ssm_norm"], cfg.norm_eps)
    z = xn @ lp["wz"].to(cd)
    xi = xn @ lp["wx"].to(cd)
    Bp = xn @ lp["wB"].to(cd)
    Cp = xn @ lp["wC"].to(cd)
    dt = xn @ lp["wdt"].to(cd)
    xi = causal_conv(xi, lp["conv_x"].to(cd))
    Bp = causal_conv(Bp, lp["conv_B"].to(cd))
    Cp = causal_conv(Cp, lp["conv_C"].to(cd))
    xi = F.silu(xi.float()).to(cd)
    Bp = F.silu(Bp.float()).to(cd)
    Cp = F.silu(Cp.float()).to(cd)
    # jax.nn.softplus is logaddexp(x, 0), with no threshold
    dt = dt.float() + lp["dt_bias"].float()
    dt = torch.logaddexp(dt, torch.zeros_like(dt))
    A = -torch.exp(lp["A_log"].float())
    y, _ = ssd_chunked(xi.reshape(b, s, h, p), dt, A, Bp, Cp, cfg.ssm_chunk)
    y = y + xi.reshape(b, s, h, p) * lp["D"].to(cd)[:, None]
    y = y.reshape(b, s, -1)
    y = L.rmsnorm(y * F.silu(z.float()).to(cd), lp["gate_norm"],
                  cfg.norm_eps)
    return x + y @ lp["w_out"].to(cd)


def _stacked(params: dict) -> dict:
    return {k: params[k] for k in SSM_LAYER_KEYS if k in params}


def forward(params: dict, cfg: ModelConfig, tokens):
    x = L.embed_tokens(params["embed"], tokens,
                       TORCH_DTYPES[cfg.compute_dtype])
    x = T.run_layers(x, _stacked(params),
                     lambda x, lp: mamba_block(x, lp, cfg), cfg.remat)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(x, params["unembed"])


def loss_fn(params: dict, cfg: ModelConfig, batch: dict):
    return L.xent_loss(forward(params, cfg, batch["tokens"]), batch["labels"])
