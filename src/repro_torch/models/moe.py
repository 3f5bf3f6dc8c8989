"""Mixture-of-Experts family (dbrx: 16e top-4; arctic: 128e top-2 + dense
residual), the port of ``repro.models.moe``: training, prefill and decode
(the cache is the dense family's).

Capacity routing as the JAX package computes it: the tokens are grouped
by dp rank (G = the dp extent, ``rules.axis_size("batch")``; G = 1 on one
rank), each group against its own capacity C. A process per rank holds
exactly its group (`repro_torch.data.synthetic.local_rows` gives it the
reference's group rows), so the dispatch is local: each token's top-k
experts get a position in that expert's capacity buffer (E, C, d) in
token order; positions at or past C drop (the token's slot contributes 0
and gets 0 gradient), the expert FFNs run as batched products over E, and
the results gather back weighted by the renormalised top-k gates. The
reference's fallback to G = 1 where the batch does not split over the
ranks is a ``ValueError`` in ``device_batch`` here.

The load-balance loss uses means over all G groups. Each rank all-reduces
its expert counts ``ce`` (no gradient) and computes ``E * sum(me_local *
ce_global)``: the mean over the ranks of that is the reference's value,
and so is the mean of its gradients, which the step takes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.dist.sharding import dp_axes
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ParamSpec

AUX_WEIGHT = 0.01               # the load-balance loss's weight


def param_specs(cfg: ModelConfig) -> dict:
    d, v, e, fm = cfg.d_model, cfg.vocab_size, cfg.num_experts, cfg.moe_d_ff
    nl = cfg.num_layers
    specs = {
        "embed": ParamSpec((v, d), ("vocab", "wemb"), init="normal"),
        "final_norm": ParamSpec((d,), ("unsharded",), init="ones"),
        "unembed": ParamSpec((d, v), ("wemb", "vocab")),
    }
    dense = T.layer_param_specs(cfg, nl)
    if not cfg.dense_residual:
        for k in ("w_gate", "w_up", "w_down"):    # experts replace dense FFN
            dense.pop(k)
    specs.update(dense)
    specs.update({
        "router": ParamSpec((nl, d, e), ("layers", "wemb", "unsharded")),
        "we_gate": ParamSpec((nl, e, d, fm), ("layers", "expert", "wemb", None)),
        "we_up": ParamSpec((nl, e, d, fm), ("layers", "expert", "wemb", None)),
        "we_down": ParamSpec((nl, e, fm, d), ("layers", "expert", None, "wemb")),
    })
    return specs


MOE_EXTRA_KEYS = ("router", "we_gate", "we_up", "we_down")


def top_k(probs, k: int):
    """The ``k`` largest along the last axis, largest first and, among
    equal values, the lower index first (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens in one group."""
    return max(int(cfg.capacity_factor * tokens * cfg.top_k
                   / cfg.num_experts), 4)


def moe_ffn(x, lp: dict, cfg: ModelConfig, rules=None):
    """x: (b, s, d), this rank's token group -> (y, aux_loss).
    Capacity-routed top-k experts."""
    b, s, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    Tn = b * s
    C = capacity(cfg, Tn)
    G = 1 if rules is None else rules.axis_size("batch")

    xt = x.reshape(Tn, d)
    logits = (xt @ lp["router"].to(x.dtype)).float()             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, K)                                  # (T, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance aux loss (global means).
    me = probs.mean(dim=0)
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    if G > 1:
        dist.all_reduce(counts, group=rules.mesh.group_over(
            dp_axes(rules.mesh)))
    ce = counts / (G * Tn * K)
    aux = E * torch.sum(me * ce)

    flat_e = idx.reshape(Tn * K)                                 # (TK,)
    oh = F.one_hot(flat_e, E)                                    # (TK, E)
    pos = (torch.cumsum(oh, dim=0) - oh).gather(1, flat_e[:, None])[:, 0]
    keep = pos < C                                               # else drop
    slot = torch.where(keep, flat_e * C + pos, 0)

    x_rep = xt.repeat_interleave(K, dim=0)                       # (TK, d)
    buf = xt.new_zeros(E * C, d).index_put((slot[keep],), x_rep[keep])
    buf = buf.reshape(E, C, d)

    h = torch.bmm(buf, lp["we_gate"].to(x.dtype))
    u = torch.bmm(buf, lp["we_up"].to(x.dtype))
    h = F.silu(h.float()).to(x.dtype) * u
    y_e = torch.bmm(h, lp["we_down"].to(x.dtype))                # (E, C, d)

    y_tok = torch.where(keep[:, None], y_e.reshape(E * C, d)[slot], 0)
    y = (y_tok.reshape(Tn, K, d) * gate[..., None].to(x.dtype)).sum(dim=1)
    return y.reshape(b, s, d), aux


def moe_mlp(x, lp: dict, cfg: ModelConfig, rules=None):
    """The FFN half of a MoE block with its pre-norm and residual: the
    routed experts, plus the dense SwiGLU beside them where
    ``cfg.dense_residual`` (arctic). Returns (x, aux)."""
    xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    y, aux = moe_ffn(xn, lp, cfg, rules)
    if cfg.dense_residual:
        y = y + L.mlp_swiglu(xn, lp)
    return x + y, aux


def moe_block(x, lp: dict, cfg: ModelConfig, positions, *, causal=True,
              rules=None):
    return moe_mlp(T.attn_block(x, lp, cfg, positions, causal=causal), lp,
                   cfg, rules)


def _stacked(params: dict, cfg: ModelConfig) -> dict:
    keys = [k for k in T.LAYER_KEYS if k in params] + list(MOE_EXTRA_KEYS)
    return {k: params[k] for k in keys}


def forward(params: dict, cfg: ModelConfig, tokens, rules=None):
    """Logits and the aux loss averaged over the layers; ``rules`` group
    the tokens by dp rank (the module docstring)."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, cd)
    positions = torch.arange(s, device=tokens.device).expand(b, s)

    def one_layer(carry, lp):
        x, aux_sum = carry
        y, aux = moe_block(x, lp, cfg, positions, rules=rules)
        return y.to(x.dtype), aux_sum + aux

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = T.run_layers((x, aux0), _stacked(params, cfg), one_layer,
                          cfg.remat)
    return T.final_logits(x, params, cfg), aux / cfg.num_layers


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            aux_weight: float = AUX_WEIGHT, rules=None):
    logits, aux = forward(params, cfg, batch["tokens"], rules)
    return L.xent_loss(logits, batch["labels"]) + aux_weight * aux


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return T.cache_specs(cfg, batch, max_seq)


def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int):
    cd = TORCH_DTYPES[cfg.compute_dtype]
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, cd)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    ks, vs = [], []
    for lp in T.layers_of(_stacked(params, cfg)):
        x, (k, v) = T.attn_block(x, lp, cfg, positions, prefill=True)
        x, _ = moe_mlp(x, lp, cfg)
        ks.append(k)
        vs.append(v)
    cache = {"k": T.stack_padded(ks, max_seq),
             "v": T.stack_padded(vs, max_seq), "length": s}
    return cache, T.final_logits(x[:, -1:], params, cfg)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token):
    """One token for each of the b rows: the experts route b tokens, so
    their capacity is ``capacity(cfg, b)`` (at least 4)."""
    pos = cache["length"]
    x = L.embed_tokens(params["embed"], token,
                       TORCH_DTYPES[cfg.compute_dtype])
    for i, lp in enumerate(T.layers_of(_stacked(params, cfg))):
        x = T.decode_attn(x, lp, cache["k"][i], cache["v"][i], pos, cfg)
        x, _ = moe_mlp(x, lp, cfg)
    return T.final_logits(x, params, cfg), dict(cache, length=pos + 1)
