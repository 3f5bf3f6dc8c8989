"""Tensor parallelism over the ``model`` mesh axis: the explicit form of
what the reference's GSPMD inserts for the specs of all seven families
(moe's experts: `repro_torch.models.moe`; the SSM's ``ssm_inner``:
`repro_torch.models.ssm`).

Each rank of a ``model`` group holds ``1/m`` of every leaf whose spec cuts
it over ``model`` (`repro_torch.dist.sharding.NamedSharding`) and computes
the part of each layer that its leaves carry. Five autograd Functions
over ``mesh.group("model")`` join the parts:

=====================  =======================  ===========================
Function               forward                  backward
=====================  =======================  ===========================
``copy_to_model``      identity                 all-reduce (sum)
``reduce_from_model``  all-reduce (sum)         identity
``sum_over_model``     all-reduce (sum)         all-reduce (sum)
``gather_from_model``  all-gather along a dim   reduce-scatter along it
``gather_rows``        all-gather along a dim   this rank's slice
=====================  =======================  ===========================

``sum_over_model`` is for a sum of the ranks' parts that every rank then
uses on its own slice (the SSM's gated norm over the whole ``d_inner``):
the loss depends on each rank's part through every rank's slice, so the
gradient of the part is the sum of the ranks' gradients of the total.

A column-parallel product (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``,
the logits) takes its input through ``copy_to_model``; a row-parallel one
(``wo``, ``w_down``) ends in ``reduce_from_model``. A leaf whose cut does
not fall where the layer needs it (a kv head cut inside, ``wq`` and ``wo``
of the sequence-sharded attention) is gathered first, and a leaf the spec
leaves whole but the layer uses only in part passes ``copy_to_model``, so
that its gradient is summed over the ranks that used a part of it.
Everything else whole over ``model`` (the norms, every fallback) is
computed the same on every model rank from gradients that are already
whole, and needs no sum.

`vocab_embed` and `vocab_xent` are the vocab-parallel embedding and cross
entropy: a rank looks up the tokens of its vocab range (zero elsewhere,
then summed), and the loss takes the max, the sum of exponentials and the
target logit over the group. `context` is None where there is nothing to
split (no rules, or a ``model`` extent of 1): the layers then run their
plain code and call no collective. Each Function is the identity on a
group of one rank, and calls no collective there either.

Serving adds two pieces (no gradient): `flash_decode_combine` joins the
decode attention's per-rank partials over a KV cache cut on ``kv_seq``
(each rank holds a contiguous block of positions), and `vocab_argmax`
is the greedy token of vocab-parallel logits.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

class ModelParallel:
    """One rank's view of its ``model`` group: ``size`` ranks, this one at
    ``rank``; ``cut`` names the leaves the specs cut over ``model``."""

    def __init__(self, mesh, cut):
        self.mesh = mesh
        self.group = mesh.group("model")
        self.size = mesh.shape["model"]
        self.rank = mesh.coordinate("model")
        self.cut = frozenset(cut)

    def is_cut(self, name: str) -> bool:
        return name in self.cut


def context(rules, specs: dict):
    """The `ModelParallel` of ``rules`` for leaves of ``specs`` (a
    ``{name: ParamSpec}`` dict), or None where ``model`` has extent 1."""
    if rules is None or rules.mesh.shape.get("model", 1) == 1:
        return None
    cut = [k for k, ps in specs.items()
           if "model" in rules.spec(*ps.logical, dims=ps.shape)]
    return ModelParallel(rules.mesh, cut)


def _all_reduce(x, tp, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=tp.group)
    return x


def _all_gather(x, dim: int, tp):
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((tp.size * front.shape[0],) + front.shape[1:])
    dist.all_gather_into_tensor(out, front, group=tp.group)
    return out.movedim(0, dim)


def _reduce_scatter(x, dim: int, tp):
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // tp.size,) + front.shape[1:])
    dist.reduce_scatter_tensor(out, front, group=tp.group)
    return out.movedim(0, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        # contiguous: a leaf used whole outside a layer stack (the hybrid's
        # shared block) takes this as its gradient, and AdamW reads it flat
        return _reduce_scatter(g, ctx.dim, ctx.tp).contiguous(), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp, ctx.n = dim, tp, x.shape[dim]
        return _all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n), None, None


def copy_to_model(x, tp):
    """Identity forward; the gradient summed over the model group."""
    return x if tp.size == 1 else _Copy.apply(x, tp)


def reduce_from_model(x, tp):
    """``x`` summed over the model group; the gradient passed as it is."""
    return x if tp.size == 1 else _Reduce.apply(x, tp)


def sum_over_model(x, tp):
    """``x`` summed over the model group, and the gradient summed over it
    too: for a total that every rank goes on to use with its own slice."""
    return x if tp.size == 1 else _Sum.apply(x, tp)


def gather_from_model(x, dim: int, tp):
    """The model group's slices of a leaf joined along ``dim``; the
    gradient reduce-scattered back onto this rank's slice."""
    return x if tp.size == 1 else _Gather.apply(x, dim % x.dim(), tp)


def gather_rows(x, dim: int, tp):
    """Each rank's rows joined along ``dim``; the gradient, which every
    rank holds whole, cut back to this rank's rows."""
    return x if tp.size == 1 else _GatherRows.apply(x, dim % x.dim(), tp)


def whole(w, name: str, dim: int, tp):
    """Leaf ``name`` whole on every rank, for a layer that uses it in
    part: gathered along ``dim`` where the spec cuts it, else passed
    through `copy_to_model` (each rank's gradient is a part of the sum)."""
    if tp.is_cut(name):
        return gather_from_model(w, dim, tp)
    return copy_to_model(w, tp)


def vocab_embed(embed, tokens, compute_dtype, tp):
    """The embedding lookup with ``embed`` this rank's rows of the vocab:
    the tokens in its range looked up, zero elsewhere, summed over the
    group (one rank holds each token's row, so the sum is exact)."""
    n = embed.shape[0]
    idx = tokens - tp.rank * n
    inside = (idx >= 0) & (idx < n)
    x = F.embedding(idx.clamp(0, n - 1), embed).to(compute_dtype)
    x = x.masked_fill(~inside[..., None], 0)
    return reduce_from_model(x, tp)


def vocab_xent(logits, labels, tp):
    """Mean next-token cross entropy of vocab-parallel logits (this rank's
    columns): the row max, the sum of exponentials and the target logit
    over the group, in f32."""
    logits = logits.float()
    n = logits.shape[-1]
    mx = logits.detach().amax(dim=-1)
    if tp.size > 1:
        mx = _all_reduce(mx, tp, dist.ReduceOp.MAX)
    sumexp = reduce_from_model(
        torch.exp(logits - mx[..., None]).sum(dim=-1), tp)
    idx = labels - tp.rank * n
    inside = (idx >= 0) & (idx < n)
    ll = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    ll = reduce_from_model(ll.masked_fill(~inside, 0), tp)
    return torch.mean(mx + torch.log(sumexp) - ll)


def flash_decode_combine(m, l, o, tp):
    """The attention output from per-part partials of a softmax over
    disjoint blocks of positions (the flash-decode combine): ``m`` the
    block's row max, ``l`` its sum of ``exp(s - m)``, ``o`` (``m``'s shape
    and one more dim) its unnormalised ``p @ v``, all f32. The parts are
    the ranks of ``tp``'s group (one all-reduce MAX of ``m`` and one sum
    all-reduce of ``exp(m - M) * l`` and ``exp(m - M) * o`` together), or,
    with ``tp`` None, stacked along dim 0 in this process. A part whose
    block is wholly masked holds ``m`` at the layers' finite ``_NEG``, so
    its factor ``exp(m - M)`` is exactly 0 and it adds nothing. Returns
    the f32 output."""
    if tp is None:
        mx = m.amax(dim=0)
    else:
        mx = _all_reduce(m, tp, dist.ReduceOp.MAX)
    a = torch.exp(m - mx)
    part = torch.cat([(a * l)[..., None], a[..., None] * o], dim=-1)
    tot = part.sum(dim=0) if tp is None else _all_reduce(part, tp)
    return tot[..., 1:] / tot[..., :1]


def vocab_argmax(logits, tp):
    """The index of the first maximum along the last dim of logits whose
    last dim is this rank's block of the vocab (``jnp.argmax``'s tie rule:
    the lowest global index): the blocks gathered over the group in rank
    order, then ``torch.argmax``. ``tp`` None: the logits are whole."""
    if tp is not None:
        logits = _all_gather(logits, -1 % logits.dim(), tp)
    return torch.argmax(logits, dim=-1)


def gather_columns(parts: list, tp) -> list:
    """Each rank's columns of several tensors (the last dims of ``parts``,
    equal leading dims) joined in rank order, in one all-gather: the
    tensors whole on every rank. No gradient."""
    sizes = [t.shape[-1] for t in parts]
    buf = torch.cat(parts, dim=-1)
    out = _all_gather(buf[None], 0, tp)               # (m, ..., sum)
    return [torch.cat(list(piece.unbind(0)), dim=-1)
            for piece in out.split(sizes, dim=-1)]
