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

The dispatch has no shape that depends on the data, so the dry run traces
it on meta tensors: the expert counts are the one-hot rows summed (not
``bincount``), every slot is written into a buffer of E * C + 1 rows, a
dropped one into the spare last row, which is cut away, and each slot is
read back under ``torch.where`` (no boolean-mask indexing).

The load-balance loss uses means over all G groups. Each rank all-reduces
its expert counts ``ce`` (no gradient) and computes ``E * sum(me_local *
ce_global)``: the mean over the ranks of that is the reference's value,
and so is the mean of its gradients, which the step takes.

Expert parallelism. Training under ``rules`` whose ``model`` extent m is
above 1 runs the block tensor-parallel (`repro_torch.dist
.tensor_parallel`): the attention, the dense residual and the vocab as the
dense family's, and the experts cut over ``model`` where E divides m (the
reference's ``("layers", "expert", "wemb", None)``): model rank r holds
experts [r E/m, (r + 1) E/m). Every model rank routes every token of its
group alike (the global E, positions and C, so the same slots drop as in
the reference), fills its (E/m, C, d) buffer with its own experts' slots
alone, runs the three products on it, combines their outputs by their
gates into a partial (b, s, d), and the partials are summed over the
group (``reduce_from_model``, the row-parallel pattern). The tokens into
the buffer and the gates of the combine pass ``copy_to_model``; the
router's input, the probabilities and the aux loss do not (their
gradient is whole on every rank already). Where E does not divide m the
experts are whole and the layer calls no collective. The reference's
compiled step re-aligns the capacity buffer with an all-to-all; this form
has none, and matches the reference's numbers, not XLA's choice of
collective. Serving under such ``rules`` runs the same layers over
``model`` (the attention and the cache as the dense family's, the
experts and the dense residual as in training), each dp rank's tokens
one group against its own capacity, as the reference groups them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import TORCH_DTYPES
from repro_torch.dist import tensor_parallel as TP
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


def tp_context(cfg: ModelConfig, rules):
    """The tensor-parallel context of ``rules`` for ``cfg``'s leaves (None
    without rules or at ``model`` extent 1)."""
    return TP.context(rules, param_specs(cfg))


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


def _route(xt, lp: dict, cfg: ModelConfig, G: int, rules):
    """The router of ``xt`` (T, d), identical on every model rank: the
    renormalised top-k gates (T, K), each slot's expert ``flat_e`` and its
    position ``pos`` in that expert's buffer (T*K,), in token order, and
    the load-balance loss. The counts come from the one-hot rows, whose
    shape does not depend on the data (``bincount``'s does)."""
    Tn, E, K = xt.shape[0], cfg.num_experts, cfg.top_k
    logits = (xt @ lp["router"].to(xt.dtype)).float()            # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, K)                                  # (T, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_e = idx.reshape(Tn * K)                                 # (TK,)
    oh = F.one_hot(flat_e, E)                                    # (TK, E)
    pos = (torch.cumsum(oh, dim=0) - oh).gather(1, flat_e[:, None])[:, 0]

    # Switch-style load-balance aux loss (global means)
    me = probs.mean(dim=0)
    counts = oh.sum(dim=0).float()
    if G > 1:
        dist.all_reduce(counts, group=rules.mesh.group_over(
            dp_axes(rules.mesh)))
    ce = counts / (G * Tn * K)
    aux = E * torch.sum(me * ce)
    return gate, flat_e, pos, aux


def _experts(xt, lp: dict, flat_e, pos, first: int, n: int, C: int):
    """Experts ``[first, first + n)`` of the routed slots: each slot whose
    expert is one of them and whose position is below ``C`` written into
    a buffer of ``n * C`` rows (every other slot into one spare row past
    them, then cut away, so it takes no gradient), the three products,
    and each slot's output read back (0 for the other slots): (T*K, d)."""
    d, K = xt.shape[1], flat_e.shape[0] // xt.shape[0]
    mine = (flat_e >= first) & (flat_e < first + n) & (pos < C)
    slot = (flat_e - first) * C + pos
    x_rep = xt.repeat_interleave(K, dim=0)                       # (TK, d)
    buf = xt.new_zeros(n * C + 1, d).index_put(
        (torch.where(mine, slot, n * C),), x_rep)
    buf = buf[:n * C].reshape(n, C, d)

    h = torch.bmm(buf, lp["we_gate"].to(xt.dtype))
    u = torch.bmm(buf, lp["we_up"].to(xt.dtype))
    h = F.silu(h.float()).to(xt.dtype) * u
    y_e = torch.bmm(h, lp["we_down"].to(xt.dtype))               # (n, C, d)
    return torch.where(mine[:, None],
                       y_e.reshape(n * C, d)[torch.where(mine, slot, 0)], 0)


def moe_ffn(x, lp: dict, cfg: ModelConfig, rules=None, tp=None):
    """x: (b, s, d), this rank's token group -> (y, aux_loss).
    Capacity-routed top-k experts; with ``tp`` cutting the experts over
    ``model``, this rank's experts only (the module docstring)."""
    b, s, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    Tn = b * s
    C = capacity(cfg, Tn)
    G = 1 if rules is None else rules.axis_size("batch")

    xt = x.reshape(Tn, d)
    gate, flat_e, pos, aux = _route(xt, lp, cfg, G, rules)
    ep = tp is not None and tp.is_cut("we_gate")
    if ep:
        # the token stream and the gates are whole here but feed only
        # this rank's experts: their gradients are summed over the group
        n = E // tp.size
        y_tok = _experts(TP.copy_to_model(xt, tp), lp, flat_e, pos,
                         tp.rank * n, n, C)
        gate = TP.copy_to_model(gate, tp)
    else:
        y_tok = _experts(xt, lp, flat_e, pos, 0, E, C)
    y = (y_tok.reshape(Tn, K, d) * gate[..., None].to(x.dtype)).sum(dim=1)
    if ep:
        y = TP.reduce_from_model(y, tp)
    return y.reshape(b, s, d), aux


def moe_mlp(x, lp: dict, cfg: ModelConfig, rules=None, tp=None):
    """The FFN half of a MoE block with its pre-norm and residual: the
    routed experts, plus the dense SwiGLU beside them where
    ``cfg.dense_residual`` (arctic); with ``tp``, both over ``model``.
    Returns (x, aux)."""
    xn = L.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    y, aux = moe_ffn(xn, lp, cfg, rules, tp)
    if cfg.dense_residual:
        y = y + L.mlp(xn, lp, cfg, tp)
    return x + y, aux


def moe_block(x, lp: dict, cfg: ModelConfig, positions, *, causal=True,
              rules=None, tp=None):
    return moe_mlp(T.attn_block(x, lp, cfg, positions, causal=causal,
                                tp=tp), lp, cfg, rules, tp)


def _stacked(params: dict, cfg: ModelConfig) -> dict:
    keys = [k for k in T.LAYER_KEYS if k in params] + list(MOE_EXTRA_KEYS)
    return {k: params[k] for k in keys}


def forward(params: dict, cfg: ModelConfig, tokens, rules=None, tp=None):
    """Logits and the aux loss averaged over the layers; ``rules`` group
    the tokens by dp rank, ``tp`` runs the layers over ``model`` (the
    module docstring)."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], tokens, cd, T.vocab_tp(tp))
    positions = torch.arange(s, device=tokens.device).expand(b, s)

    def one_layer(carry, lp):
        x, aux_sum = carry
        y, aux = moe_block(x, lp, cfg, positions, rules=rules, tp=tp)
        return y.to(x.dtype), aux_sum + aux

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = T.run_layers((x, aux0), _stacked(params, cfg), one_layer,
                          cfg.remat)
    return T.final_logits(x, params, cfg, tp), aux / cfg.num_layers


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            aux_weight: float = AUX_WEIGHT, rules=None):
    """The mean loss of this rank's rows; under ``rules`` with a ``model``
    extent above 1, tensor-parallel."""
    tp = tp_context(cfg, rules)
    logits, aux = forward(params, cfg, batch["tokens"], rules, tp)
    return L.xent_loss(logits, batch["labels"], T.vocab_tp(tp)) \
        + aux_weight * aux


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return T.cache_specs(cfg, batch, max_seq)


def prefill(params: dict, cfg: ModelConfig, tokens, max_seq: int,
            rules=None):
    """The prompt's cache and last logits; under ``rules`` with a
    ``model`` extent above 1, tensor-parallel (the module docstring)."""
    cd = TORCH_DTYPES[cfg.compute_dtype]
    b, s = tokens.shape
    tp = tp_context(cfg, rules)
    group = rules if tp is not None else None
    x = L.embed_tokens(params["embed"], tokens, cd, T.vocab_tp(tp))
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    fill = T.PrefillCache(x, cfg, max_seq, rules, tp)
    for lp in T.serving_layers(_stacked(params, cfg)):
        x, (k, v) = T.attn_block(x, lp, cfg, positions, prefill=True, tp=tp)
        x, _ = moe_mlp(x, lp, cfg, group, tp)
        fill.add(k, v)
    return fill.cache(), T.final_logits(x[:, -1:], params, cfg, tp)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, token,
                rules=None):
    """One token for each of the b rows: the experts route b tokens, so
    their capacity is ``capacity(cfg, b)`` (at least 4)."""
    tp = tp_context(cfg, rules)
    group = rules if tp is not None else None
    pos = cache["length"]
    x = L.embed_tokens(params["embed"], token,
                       TORCH_DTYPES[cfg.compute_dtype], T.vocab_tp(tp))
    first = T.cache_first(cache, tp)
    for i, lp in enumerate(T.serving_layers(_stacked(params, cfg))):
        x = T.decode_attn(x, lp, cache["k"][i], cache["v"][i], pos, cfg, tp,
                          first)
        x, _ = moe_mlp(x, lp, cfg, group, tp)
    return T.final_logits(x, params, cfg, tp), dict(cache, length=pos + 1)
