"""The port's fixed-shape MoE dispatch (`repro_torch.models.moe`) on the
CPU: bit for bit the mask-indexed dispatch it replaced (kept below as the
oracle), forward and backward, with and without drops; traceable on meta
tensors; and split over model ranks, each rank's experts' part summing to
the whole.
"""
import ast
import inspect

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs as TC
from repro_torch.models import moe

torch.set_num_threads(2)   # leave cores to the other test workers


def masked_dispatch(x, lp, cfg):
    """The dispatch before it had fixed shapes: the counts by
    ``bincount``, the kept slots selected by boolean-mask indexing."""
    b, s, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    Tn = b * s
    C = moe.capacity(cfg, Tn)
    xt = x.reshape(Tn, d)
    logits = (xt @ lp["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = moe.top_k(probs, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    counts = torch.bincount(idx.reshape(-1), minlength=E).float()
    ce = counts / (Tn * K)
    aux = E * torch.sum(me * ce)
    flat_e = idx.reshape(Tn * K)
    oh = F.one_hot(flat_e, E)
    pos = (torch.cumsum(oh, dim=0) - oh).gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, 0)
    x_rep = xt.repeat_interleave(K, dim=0)
    buf = xt.new_zeros(E * C, d).index_put((slot[keep],), x_rep[keep])
    buf = buf.reshape(E, C, d)
    h = torch.bmm(buf, lp["we_gate"].to(x.dtype))
    u = torch.bmm(buf, lp["we_up"].to(x.dtype))
    h = F.silu(h.float()).to(x.dtype) * u
    y_e = torch.bmm(h, lp["we_down"].to(x.dtype))
    y_tok = torch.where(keep[:, None], y_e.reshape(E * C, d)[slot], 0)
    y = (y_tok.reshape(Tn, K, d) * gate[..., None].to(x.dtype)).sum(dim=1)
    return y.reshape(b, s, d), aux


def _inputs(cfg, dtype, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)
    lp = {"router": rnd(d, e, scale=0.3),
          "we_gate": rnd(e, d, f, scale=d ** -0.5),
          "we_up": rnd(e, d, f, scale=d ** -0.5),
          "we_down": rnd(e, f, d, scale=f ** -0.5)}
    return rnd(2, 16, d).to(dtype), lp, rnd(2, 16, d)


def _run(fn, x, lp, r, cfg, dtype):
    x = x.clone().requires_grad_(True)
    lp = {k: v.clone().to(dtype).requires_grad_(True) for k, v in lp.items()}
    y, aux = fn(x, lp, cfg)
    grads = torch.autograd.grad((y.float() * r).sum() + aux,
                                [x, *lp.values()])
    return y, aux, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,factor", [("dbrx-132b", 0.25),
                                         ("dbrx-132b", 1.25),
                                         ("arctic-480b", 0.5)])
def test_dispatch_is_bitwise_the_masked_one(arch, factor, dtype):
    """Outputs, aux loss and the gradients of x and of every leaf equal
    the mask-indexed dispatch's bit for bit, also where most slots drop
    (capacity factor 0.25: 4 slots an expert for 64)."""
    cfg = TC.get(arch).reduced(capacity_factor=factor)
    x, lp, r = _inputs(cfg, dtype)
    want = _run(masked_dispatch, x, lp, r, cfg, dtype)
    got = _run(lambda x, lp, c: moe.moe_ffn(x, lp, c), x, lp, r, cfg,
               dtype)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, a, b in zip(["x", *lp], got[2], want[2]):
        assert torch.equal(a, b), name
    if factor == 0.25:
        dropped = (got[0].reshape(32, -1) == 0).all(-1)
        assert dropped.any() and not dropped.all()


def test_dispatch_traces_on_meta():
    """No shape of the dispatch depends on the data: it runs on meta
    tensors, forward and backward, at the shapes of the real run."""
    cfg = TC.get("arctic-480b").reduced()
    x, lp, _ = _inputs(cfg, torch.float32, device="meta")
    x.requires_grad_(True)
    for v in lp.values():
        v.requires_grad_(True)
    y, aux = moe.moe_ffn(x, lp, cfg)
    assert y.shape == x.shape and y.device.type == "meta"
    grads = torch.autograd.grad(y.sum() + aux, [x, *lp.values()])
    assert [g.shape for g in grads] == [x.shape] + [v.shape
                                                    for v in lp.values()]


def test_module_calls_no_bincount_and_no_mask_index():
    """``moe.py`` calls no ``bincount``, and indexes no tensor by a
    comparison (the boolean masks it forms go to ``torch.where``)."""
    tree = ast.parse(inspect.getsource(moe))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr != "bincount"
        if isinstance(node, ast.Subscript):
            assert not isinstance(node.slice, (ast.Compare, ast.BoolOp))


@pytest.mark.parametrize("m", [2, 4])
def test_expert_split_sums_to_the_whole(m):
    """Each of m model ranks' experts, written, run and read back alone
    (zero for every other slot), sums to the whole layer's slots, and
    every kept slot is produced by exactly one rank."""
    cfg = TC.get("dbrx-132b").reduced(capacity_factor=0.5)
    x, lp, _ = _inputs(cfg, torch.float32)
    xt = x.reshape(-1, cfg.d_model)
    _, flat_e, pos, _ = moe._route(xt, lp, cfg, 1, None)
    E, C = cfg.num_experts, moe.capacity(cfg, xt.shape[0])
    whole = moe._experts(xt, lp, flat_e, pos, 0, E, C)
    n = E // m
    parts = [moe._experts(xt, {k: v if k == "router" else v[r * n:(r + 1) * n]
                               for k, v in lp.items()},
                          flat_e, pos, r * n, n, C) for r in range(m)]
    assert torch.equal(sum(parts), whole)
    nonzero = torch.stack([(p != 0).any(-1) for p in parts]).sum(0)
    assert torch.equal(nonzero, (whole != 0).any(-1).long())
    assert ((pos >= C) == ~(whole != 0).any(-1)).all()
