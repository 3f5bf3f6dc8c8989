"""The flash-attention backward wrapper (`ops.flash_attention_bwd`) on the
CPU and on meta tensors: the plain version on the CPU, bit for bit; the
kernel's route, shapes and recorded work on meta (the dry run); the
checks it makes before a launch; its launch counter. The kernel itself
runs only on the card (``chip_smoke.py``'s phase 2 holds it against the
plain version there).
"""
import math

import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import (causal_pairs, flash_bwd_work,
                                                 route)
from repro_torch.models.layers import FlashAttention

torch.set_num_threads(2)   # leave cores to the other test workers

# (b, sq, skv, h, kv, d, causal, q_offset)
CASES = [(2, 16, 16, 4, 4, 8, True, 0),
         (1, 24, 24, 4, 2, 16, True, 0),       # GQA 2:1, ragged tiles
         (2, 12, 12, 3, 3, 8, False, 0),
         (1, 8, 20, 4, 1, 16, False, 0),       # sq != skv, GQA 4:1
         (1, 8, 32, 2, 2, 8, True, 24),        # the last rows at q_offset
         (1, 8, 32, 2, 1, 8, True, 5)]         # rows that end before the keys


def _inputs(case, dtype, device="cpu", seed=0):
    b, sq, skv, h, kv, d, causal, off = case
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(dtype).to(device)
    q, k, v = rnd(b, sq, h, d, s=0.5), rnd(b, skv, kv, d, s=0.5), \
        rnd(b, skv, kv, d)
    do = rnd(b, sq, h, d)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CASES)
def test_flash_bwd_on_the_cpu_is_the_plain_version_bitwise(case, dtype):
    q, k, v, do = _inputs(case, dtype)
    causal, off = case[6], case[7]
    o, lse = ops.flash_attention(q, k, v, causal, off)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, off)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, off)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, w)


def test_flash_attention_autograd_takes_the_wrapper():
    """`FlashAttention`'s backward is the wrapper's: on the CPU the plain
    version's gradients, bit for bit."""
    case = CASES[1]
    q, k, v, do = _inputs(case, torch.bfloat16)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    FlashAttention.apply(qa, ka, va, True, 0).backward(do)
    o, lse = ops.flash_attention(q, k, v, True)
    for g, w in zip((qa.grad, ka.grad, va.grad),
                    ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 80, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.float32, 64, "mma"),
    (torch.float32, 128, "mma"), (torch.bfloat16, 20, "mma")])
def test_flash_bwd_route_picks_the_kernel_by_dtype_and_head_dim(dtype, d,
                                                                want):
    """bf16 at gpt2's 64, the ViT's 80 and the 128 of the other configs
    take the kernel, which records its work on meta; f32 and the other
    bf16 head dims take the plain version, whose products are ordinary
    operations on meta and record no kernel work."""
    assert route(dtype, d) == want
    q, k, v, do = _inputs((1, 16, 16, 2, 2, d, True, 0), dtype, "meta")
    o, lse = torch.empty_like(q), torch.empty((1, 2, 16), device="meta")
    seen = []
    build._work_sinks.append(lambda *a: seen.append(a))
    try:
        ops.flash_attention_bwd(q, k, v, o, lse, do, True)
    finally:
        build._work_sinks.pop()
    assert [a[0] for a in seen] == (["flash_attention_bwd"]
                                    if want == "wgmma" else [])


@pytest.mark.parametrize("shape,causal,flops,nbytes", [
    # gpt2-1.5b: one microbatch of 4 x 1024, 25 heads of 64, causal
    ((4, 1024, 25, 25, 64), True, 10 * 4 * 25 * 64 * 1024 * 1025 // 2,
     2 * 4 * 2 * 4 * 1024 * 25 * 64 + 8 * 4 * 25 * 1024),
    # vit-h-14: one microbatch of 32 x 256 patches, 16 heads of 80, full
    ((32, 256, 16, 16, 80), False, 10 * 32 * 16 * 80 * 256 * 256,
     2 * 4 * 2 * 32 * 256 * 16 * 80 + 8 * 32 * 16 * 256)])
def test_flash_bwd_on_meta_returns_the_shapes_and_records_the_work(
        shape, causal, flops, nbytes):
    b, s, h, kv, d = shape
    q = torch.empty((b, s, h, d), device="meta", dtype=torch.bfloat16)
    k = torch.empty((b, s, kv, d), device="meta", dtype=torch.bfloat16)
    v, o, do = torch.empty_like(k), torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty((b, h, s), device="meta")
    seen = []
    build._work_sinks.append(lambda *a: seen.append(a))
    try:
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    finally:
        build._work_sinks.pop()
    for g, x in zip((dq, dk, dv), (q, k, v)):
        assert g.device.type == "meta"
        assert g.shape == x.shape and g.dtype == x.dtype
    assert seen == [("flash_attention_bwd", flops, nbytes)]
    assert flash_bwd_work(q, k, causal) == (flops, nbytes)
    pairs = causal_pairs(s, s) if causal else s * s
    assert flops == 2.5 * 4 * b * h * d * pairs
    if shape[1] == 1024:     # the bound the benchmark's metric reads
        assert math.isclose(flops, 3.36e10, rel_tol=1e-3)
        assert math.isclose(nbytes, 105.7e6, rel_tol=1e-3)


def _bad(what):
    """Valid meta inputs of a bf16 d-64 backward with one fault."""
    b, s, h, d = 1, 16, 2, 64
    q = torch.empty((b, s, h, d), device="meta", dtype=torch.bfloat16)
    args = dict(q=q, k=torch.empty_like(q), v=torch.empty_like(q),
                o=torch.empty_like(q),
                lse=torch.empty((b, h, s), device="meta"),
                do=torch.empty_like(q))
    if what == "noncontiguous do":
        args["do"] = torch.empty((b, s, d, h), device="meta",
                                 dtype=torch.bfloat16).transpose(2, 3)
    elif what == "noncontiguous q":
        args["q"] = torch.empty((b, h, s, d), device="meta",
                                dtype=torch.bfloat16).transpose(1, 2)
    elif what == "o shape":
        args["o"] = torch.empty((b, s + 1, h, d), device="meta",
                                dtype=torch.bfloat16)
    elif what == "do dtype":
        args["do"] = torch.empty_like(q, dtype=torch.float32)
    elif what == "lse shape":
        args["lse"] = torch.empty((b, s, h), device="meta")
    elif what == "lse dtype":
        args["lse"] = torch.empty((b, h, s), device="meta",
                                  dtype=torch.bfloat16)
    elif what == "kv heads":
        args["k"] = args["v"] = torch.empty((b, s, 3, d), device="meta",
                                            dtype=torch.bfloat16)
    elif what == "k dtype":
        args["k"] = torch.empty_like(q, dtype=torch.float32)
    return args


@pytest.mark.parametrize("what", ["noncontiguous do", "noncontiguous q",
                                  "o shape", "do dtype", "lse shape",
                                  "lse dtype", "kv heads", "k dtype",
                                  "q_offset"])
def test_flash_bwd_raises_on_what_the_kernel_does_not_take(what):
    args = _bad(what)
    off = -1 if what == "q_offset" else 0
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention_bwd(args["q"], args["k"], args["v"], args["o"],
                                args["lse"], args["do"], True, off)


def test_flash_bwd_mismatch_raises_on_the_cpu_too():
    q, k, v, do = _inputs(CASES[0], torch.float32)
    o, lse = ops.flash_attention(q, k, v, True)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, o, lse[:, :, :-1], do, True)
    with pytest.raises(ValueError, match="do"):
        ops.flash_attention_bwd(q, k, v, o, lse, do[:, :-1], True)


def test_flash_bwd_counter_is_in_ops_counters():
    """The backward's launch counter is read and reset with the others; a
    run on the CPU launches nothing."""
    assert "flash_attention_bwd" in ops.COUNTERS
    ops.reset_launch_counts()
    q, k, v, do = _inputs(CASES[0], torch.bfloat16)
    o, lse = ops.flash_attention(q, k, v, True)
    ops.flash_attention_bwd(q, k, v, o, lse, do, True)
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    ops.COUNTERS["flash_attention_bwd"].add()
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    ops.reset_launch_counts()
    assert ops.launch_counts()["flash_attention_bwd"] == 0
