"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode and its oracles.

Tolerances: AdamW and flash attention at f32 to rtol 1e-5 / atol 1e-6
(the JAX package computes ``b1 ** step`` on its device, the port once on
the host, and the two frameworks sum in other orders); bf16 outputs to one
bf16 rounding step; the pack is exact.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bucket_pack import pack_leaves
from repro.models.layers import _flash_fwd_core

from repro_torch.convert import to_numpy, to_tensor
from repro_torch.kernels import bucket_pack as tbp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import MAX_PACK_LEAVES, LaunchCounter
from repro_torch.kernels.flash_attention import route

torch.set_num_threads(2)   # leave cores to the other test workers

RNG = np.random.default_rng(11)
HYPERS = [dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.0),
          dict(b1=0.8, b2=0.95, eps=1e-6, wd=0.2)]


def _adamw_inputs(shape, pdtype):
    p = jnp.asarray(RNG.standard_normal(shape), pdtype)
    g = jnp.asarray(RNG.standard_normal(shape), jnp.float32)
    m = jnp.asarray(RNG.standard_normal(shape), jnp.float32)
    v = jnp.asarray(np.abs(RNG.standard_normal(shape)), jnp.float32)
    return p, g, m, v


@pytest.mark.parametrize("hyp", HYPERS)
@pytest.mark.parametrize("pdtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(128,), (1000,), (257, 129), (4, 33, 7),
                                   (128 * 256,), (3, 128, 128)])
def test_fused_adamw_matches_pallas(shape, pdtype, hyp):
    p, g, m, v = _adamw_inputs(shape, pdtype)
    po, mo, vo = jops.fused_adamw(p, g, m, v, 5.0, 3e-4, **hyp)
    tp, tg, tm, tv = (to_tensor(np.asarray(x)) for x in (p, g, m, v))
    ops.fused_adamw_(tp, tg, tm, tv, ref.adamw_scalars(5, 3e-4, **hyp))
    np.testing.assert_allclose(to_numpy(tp), np.asarray(po, np.float32),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_numpy(tm), np.asarray(mo), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(to_numpy(tv), np.asarray(vo), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_fused_adamw_flat_matches_jax_oracle(scale):
    """The flat form folds the clip scale in, as ``ops.fused_adamw_flat``."""
    p, g, m, v = _adamw_inputs((515,), jnp.float32)
    po, mo, vo = jops.fused_adamw_flat(p, g, m, v, 3.0, 1e-3, scale)
    tp, tg, tm, tv = (to_tensor(np.asarray(x)) for x in (p, g, m, v))
    ops.fused_adamw_(tp, tg, tm, tv, ref.adamw_scalars(3, 1e-3), scale)
    np.testing.assert_allclose(to_numpy(tp), np.asarray(po), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to_numpy(tm), np.asarray(mo), rtol=1e-5,
                               atol=1e-7)


def test_fused_adamw_wrapper_is_the_plain_version_in_place():
    """On the CPU the wrapper writes exactly ``adamw_ref``'s result into its
    inputs, and launches no kernel."""
    counter = ops.COUNTERS["fused_adamw"].value
    p, g, m, v = (torch.from_numpy(RNG.standard_normal(777).astype(np.float32))
                  for _ in range(4))
    v = v.abs()
    s = ref.adamw_scalars(7, 2e-3)
    want = ref.adamw_ref(p, g, m, v, s, 0.5)
    ops.fused_adamw_(p, g, m, v, s, 0.5)
    for got, w in zip((p, m, v), want):
        assert torch.equal(got, w)
    assert ops.COUNTERS["fused_adamw"].value == counter


def test_adamw_scalars_are_f32_and_match_jax():
    s = ref.adamw_scalars(5, 3e-4, b1=0.9, b2=0.95)
    for x in s:
        assert float(np.float32(x)) == x
    bc1 = float(1.0 - 0.9 ** jnp.float32(5.0))
    assert s.bc1 == pytest.approx(bc1, rel=1e-6)
    assert s.omb2 == float(np.float32(1.0 - 0.95))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,d", [(2, 128, 2, 16), (1, 256, 4, 32),
                                     (2, 64, 2, 8), (1, 64, 1, 64),
                                     (1, 64, 2, 128), (1, 64, 2, 20),
                                     (1, 64, 2, 80), (1, 64, 2, 96),
                                     (1, 32, 1, 256)])
def test_flash_attention_matches_pallas(b, s, h, d, causal):
    q, k, v = (jnp.asarray(RNG.standard_normal((b, s, h, d)), jnp.float32)
               * sc for sc in (0.3, 0.3, 1.0))
    o_j = jops.flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    _, lse_j = _flash_fwd_core(q, k, v, causal, 0)
    o, lse = ops.flash_attention(*(to_tensor(np.asarray(x)) for x in (q, k, v)),
                                 causal)
    np.testing.assert_allclose(to_numpy(o), np.asarray(o_j), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(to_numpy(lse), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_bf16_matches_pallas():
    b, s, h, d = 1, 128, 2, 32
    q, k, v = (jnp.asarray(RNG.standard_normal((b, s, h, d)), jnp.bfloat16)
               * sc for sc in (0.3, 0.3, 1.0))
    o_j = jops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    o, _ = ops.flash_attention(*(to_tensor(np.asarray(x)) for x in (q, k, v)),
                               True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(o), np.asarray(o_j, np.float32),
                               rtol=0.05, atol=0.05)


def test_flash_attention_bf16_d80_matches_pallas():
    """bf16 at vit-h-14's head_dim 80, which the card runs on the wgmma
    kernel zero-filled to its 128-wide instance."""
    b, s, h, d = 1, 64, 2, 80
    q, k, v = (jnp.asarray(RNG.standard_normal((b, s, h, d)), jnp.bfloat16)
               * sc for sc in (0.3, 0.3, 1.0))
    o_j = jops.flash_attention(q, k, v, causal=True, block_q=32, block_k=32)
    o, _ = ops.flash_attention(*(to_tensor(np.asarray(x)) for x in (q, k, v)),
                               True)
    assert o.dtype == torch.bfloat16 and route(o.dtype, d) == "wgmma"
    np.testing.assert_allclose(to_numpy(o), np.asarray(o_j, np.float32),
                               rtol=0.05, atol=0.05)


def test_flash_attention_uneven_blocks_matches_pallas():
    """Pallas with 64-row q and 32-row kv blocks (the CUDA kernel's tiles)."""
    b, s, h, d = 1, 128, 1, 16
    q, k, v = (jnp.asarray(RNG.standard_normal((b, s, h, d)), jnp.float32)
               * sc for sc in (0.5, 0.5, 1.0))
    o_j = jops.flash_attention(q, k, v, causal=True, block_q=64, block_k=32)
    o, _ = ops.flash_attention(*(to_tensor(np.asarray(x)) for x in (q, k, v)),
                               True)
    np.testing.assert_allclose(to_numpy(o), np.asarray(o_j), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_gqa_reads_kv_by_head_index():
    """Unexpanded kv (kv heads dividing h) equals the JAX package's
    ``expand_kv`` followed by attention."""
    b, s, h, kv, d = 2, 64, 8, 2, 16
    q = jnp.asarray(RNG.standard_normal((b, s, h, d)), jnp.float32) * 0.3
    k = jnp.asarray(RNG.standard_normal((b, s, kv, d)), jnp.float32) * 0.3
    v = jnp.asarray(RNG.standard_normal((b, s, kv, d)), jnp.float32)
    ke, ve = jnp.repeat(k, h // kv, axis=2), jnp.repeat(v, h // kv, axis=2)
    o_j, lse_j = _flash_fwd_core(q, ke, ve, True, 0)
    o, lse = ops.flash_attention(*(to_tensor(np.asarray(x)) for x in (q, k, v)),
                                 True)
    np.testing.assert_allclose(to_numpy(o), np.asarray(o_j), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(to_numpy(lse), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_causal_is_top_left():
    """With sq < skv, row i sees keys 0..i (the kernel's and the model's
    mask), not the bottom-right alignment of ``repro.kernels.ref``."""
    q = torch.randn(1, 4, 1, 8)
    k = torch.randn(1, 8, 1, 8)
    v = torch.randn(1, 8, 1, 8)
    o, _ = ops.flash_attention(q, k, v, True)
    o0, _ = ops.flash_attention(q[:, :1], k[:, :1], v[:, :1], False)
    torch.testing.assert_close(o[:, :1], o0, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
@pytest.mark.parametrize("n", [128, 1000, 12345, 128 * 300])
def test_bucket_pack_matches_pallas_pack_leaves(n, dtype):
    shapes = [(n,), (3, 4), (7,), (2, 2, 2)]
    if dtype == jnp.int32:
        leaves = [jnp.asarray(RNG.integers(-100, 100, s), dtype)
                  for s in shapes]
    else:
        leaves = [jnp.asarray(RNG.standard_normal(s), dtype) for s in shapes]
    total = sum(x.size for x in leaves)
    padded = total + (-total) % 128
    want = np.asarray(pack_leaves(leaves, padded))
    tl = [to_tensor(np.asarray(x)) for x in leaves]
    offs = np.cumsum([0] + [t.numel() for t in tl[:-1]]).tolist()
    out = torch.zeros(padded, dtype=tl[0].dtype)
    ops.pack_bucket([t.reshape(-1) for t in tl], offs, out)
    got = to_numpy(out)
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    back = jref.bucket_unpack_ref(jnp.asarray(want[:total]),
                                  [x.shape for x in leaves])
    for a, t in zip(back, tl):
        np.testing.assert_array_equal(np.asarray(a).astype(got.dtype),
                                      to_numpy(t))


def test_bucket_pack_rejects_what_the_kernel_does_not_take():
    out = torch.zeros(10)
    with pytest.raises(TypeError):
        ops.pack_bucket([torch.zeros(3, dtype=torch.bfloat16)], [0], out)
    with pytest.raises(ValueError):
        ops.pack_bucket([torch.zeros(6)], [5], out)
    with pytest.raises(ValueError):
        ops.pack_bucket([torch.zeros(4, 2).t()], [0], out)


def test_launch_counter_counts_and_resets():
    c = LaunchCounter()
    c.add()
    c.add()
    assert c.value == 2
    c.reset()
    assert c.value == 0


def test_optimizer_functions_match_jax():
    """``adamw_leaf``/``adamw_flat`` (plain versions), ``global_norm`` and
    the cosine schedule against the JAX package's."""
    from repro.optim import functional as jf
    from repro.optim import schedules as js
    from repro_torch.optim import functional as tf
    from repro_torch.optim import schedules as ts
    p, g, m, v = _adamw_inputs((300,), jnp.float32)
    tp, tg, tm, tv = (to_tensor(np.asarray(x)) for x in (p, g, m, v))
    cases = ((jf.adamw_leaf(p, g, m, v, 4.0, jf.OptimizerConfig(), 1e-3),
              tf.adamw_leaf(tp, tg, tm, tv, 4, tf.OptimizerConfig(), 1e-3)),
             (jf.adamw_flat(p, g, m, v, 4.0, jf.OptimizerConfig(), 1e-3, 0.5),
              tf.adamw_flat(tp, tg, tm, tv, 4, tf.OptimizerConfig(), 1e-3,
                            0.5)))
    for want, got in cases:
        for a, b in zip(got, want):
            np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    assert float(tf.global_norm({"g": tg, "m": tm})) == pytest.approx(
        float(jf.global_norm({"g": g, "m": m})), rel=1e-5)
    jlr, tlr = js.cosine_schedule(1e-3, 10, 100), ts.cosine_schedule(1e-3, 10,
                                                                     100)
    for step in (0, 3, 10, 40, 100, 130):
        assert tlr(step) == pytest.approx(float(jlr(step)), rel=1e-6)


# every padded width and its neighbours, the wgmma edges (multiples of 8
# up to 128) and vit-h-14's 80
ROUTE_HEAD_DIMS = [8, 16, 32, 64, 128, 1, 2, 3, 7, 9, 15, 17, 20, 24, 31,
                   33, 48, 63, 65, 72, 80, 96, 100, 112, 120, 127, 129, 136,
                   160, 192, 200, 255, 256]


@pytest.mark.parametrize("d", ROUTE_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_route_picks_the_kernel_by_dtype_and_head_dim(dtype, d):
    """The route table: bf16 at a multiple of 8 from 8 to 128 takes the
    wgmma kernel; f32 at any d from 1 to 256, and bf16 at every other d up
    to 256, the mma.sync kernel."""
    wgmma = dtype == torch.bfloat16 and d % 8 == 0 and 8 <= d <= 128
    assert route(dtype, d) == ("wgmma" if wgmma else "mma")


def test_flash_route_rejects_other_dtypes_and_head_dims():
    for dtype, d in ((torch.float16, 64), (torch.bfloat16, 0),
                     (torch.float32, 0), (torch.bfloat16, 257),
                     (torch.float32, 257)):
        with pytest.raises(ValueError, match="1 <= head_dim <= 256"):
            route(dtype, d)


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits): to nearest, ties away
    from zero, by the low 13 bits, as ``cvt.rna.tf32.f32`` rounds."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a, b, passes):
    """a @ b on TF32 tensor cores with f32 accumulation: one pass (both
    operands rounded to TF32) or three (``csrc/flash_attention.cu``'s split,
    x = hi + lo, lo*hi + hi*lo + hi*hi)."""
    ahi, bhi = _tf32(a), _tf32(b)
    if passes == 1:
        return ahi @ bhi
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi


def _emulate_mma_flash(q, k, v, passes):
    """The mma.sync flash kernel's arithmetic on the CPU in f32, causal:
    TF32 products, an online softmax over its kv tiles (64 rows, 32 at
    d > 64) with exp2, the scale folded into the scores and a running max.
    Returns (o, lse) as the kernel lays them out."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    bk = 64 if d <= 64 else 32
    scale_log2 = 1.0 / math.sqrt(d) * math.log2(math.e)
    qh = q.transpose(1, 2)                                  # (b, h, s, d)
    kh = ref.expand_kv(k, h).transpose(1, 2)
    vh = ref.expand_kv(v, h).transpose(1, 2)
    mask = ref.causal_mask(sq, skv, q.device)
    m = torch.full((b, h, sq), -math.inf)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, skv, bk):
        s = _tf32_product(qh, kh[:, :, k0:k0 + bk].transpose(-1, -2), passes)
        s = s.masked_fill(~mask[:, k0:k0 + bk], -math.inf)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _tf32_product(
            p, vh[:, :, k0:k0 + bk], passes)
        m = m_new
    return ((acc / l[..., None]).transpose(1, 2),
            m * math.log(2.0) + torch.log(l))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_3xtf32_emulation_holds_the_f32_limit(d, record_property):
    """The precision case for the mma.sync kernel's design, on the CPU:
    three TF32 passes land within the card's f32 limit (o within 2e-5, lse
    within 1e-4, chip_smoke.FLASH_TOL) of the Pallas kernel; one TF32 pass
    is recorded (``one_pass_over_limit``), not asserted."""
    b, s, h, kv = 1, 256, 4, 2
    rng = np.random.default_rng(d)          # the recorded numbers repeat
    q, k, v = (jnp.asarray(rng.standard_normal(shape), jnp.float32) * sc
               for shape, sc in (((b, s, h, d), 0.3), ((b, s, kv, d), 0.3),
                                 ((b, s, kv, d), 1.0)))
    ke, ve = jnp.repeat(k, h // kv, axis=2), jnp.repeat(v, h // kv, axis=2)
    o_j = np.asarray(jops.flash_attention(q, ke, ve, causal=True,
                                          block_q=64, block_k=64))
    _, lse_j = _flash_fwd_core(q, ke, ve, True, 0)
    tq, tk, tv = (to_tensor(np.asarray(x)) for x in (q, k, v))
    o3, lse3 = _emulate_mma_flash(tq, tk, tv, passes=3)
    np.testing.assert_allclose(to_numpy(o3), o_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(to_numpy(lse3), np.asarray(lse_j), rtol=0,
                               atol=1e-4)
    o1, _ = _emulate_mma_flash(tq, tk, tv, passes=1)
    over = {name: float(np.abs(to_numpy(o) - o_j).max() / 2e-5)
            for name, o in (("three", o3), ("one", o1))}
    record_property("three_passes_over_limit", over["three"])
    record_property("one_pass_over_limit", over["one"])
    print(f"d={d}: worst |o - Pallas| over the 2e-5 limit: three TF32 passes "
          f"{over['three']:.4f}, one pass {over['one']:.2f}")


def test_flash_attention_bf16_d128_on_cpu_is_the_plain_version():
    """bf16 at head_dim 128, which the card runs on the tensor-core
    kernel, runs the plain version on the CPU and counts no launch."""
    q, k, v = (torch.from_numpy(RNG.standard_normal((1, 48, 4, 128))
                                .astype(np.float32)).to(torch.bfloat16) * sc
               for sc in (0.3, 0.3, 1.0))
    before = ops.launch_counts()
    o, lse = ops.flash_attention(q, k[:, :, :2], v[:, :, :2], True)
    want_o, want_lse = ref.flash_attention_ref(q, k[:, :, :2], v[:, :, :2],
                                               True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert ops.launch_counts() == before


def _emulate_pack(plans, leaves, out_nbytes):
    """What the pack kernel writes, block by block: each block takes its
    range of 16-byte chunks, finds the leaf of its first chunk by the
    kernel's binary search and walks through the leaves the range covers.
    Returns the bytes written and how many times each byte was written."""
    out = np.zeros(out_nbytes, np.uint8)
    writes = np.zeros(out_nbytes, np.int64)
    for plan in plans:
        first, n = plan.first, len(plan.rows)
        assert n <= MAX_PACK_LEAVES and len(first) == n + 1
        for block in range(plan.blocks()):
            c_begin = block * tbp.CHUNKS_PER_BLOCK
            c_end = min(c_begin + tbp.CHUNKS_PER_BLOCK, first[n])
            lo, hi = 0, n - 1
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if first[mid] <= c_begin:
                    lo = mid
                else:
                    hi = mid - 1
            covered = 0
            leaf = lo
            while leaf < n and first[leaf] < c_end:
                src, dst, nbytes = plan.rows[leaf]
                t = leaves[plan.leaves[leaf]]
                assert src == t.data_ptr()
                data = t.reshape(-1).view(torch.uint8).numpy()
                a = max(c_begin, first[leaf]) - first[leaf]
                e = min(c_end, first[leaf + 1]) - first[leaf]
                lo_b, hi_b = a * tbp.CHUNK, min(e * tbp.CHUNK, nbytes)
                out[dst + lo_b:dst + hi_b] = data[lo_b:hi_b]
                writes[dst + lo_b:dst + hi_b] += 1
                covered += e - a
                leaf += 1
            assert covered == c_end - c_begin     # no block idles
    return out, writes


def _pack_case(n_leaves, dtype, seed):
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(1, 3000, n_leaves)]
    sizes[0] += 4096 * 3                     # a leaf over several blocks
    if dtype == torch.int32:
        leaves = [torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32))
                  for n in sizes]
    else:
        leaves = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                  .to(dtype) for n in sizes]
    gaps = rng.integers(0, 5, n_leaves)      # misaligned offsets
    offs = (np.cumsum([0] + sizes[:-1]) + np.cumsum(gaps)).tolist()
    return leaves, [int(o) for o in offs], int(offs[-1] + sizes[-1] + 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("n_leaves", list(range(1, 10)))
def test_bucket_pack_launch_plan_writes_every_byte_once(n_leaves, dtype):
    leaves, offs, total = _pack_case(n_leaves, dtype, 100 * n_leaves)
    item = leaves[0].element_size()
    plans = tbp.launch_plan(leaves, offs, item)
    assert len(plans) == 1
    got, writes = _emulate_pack(plans, leaves, total * item)
    want = ref.bucket_pack_ref(leaves, offs,
                               torch.zeros(total, dtype=dtype))
    want_bytes = want.view(torch.uint8).numpy()
    inside = np.zeros(total * item, bool)
    for t, off in zip(leaves, offs):
        inside[off * item:(off + t.numel()) * item] = True
    assert np.all(writes[inside] == 1) and np.all(writes[~inside] == 0)
    np.testing.assert_array_equal(got, want_bytes)


def test_bucket_pack_launch_plan_splits_at_128_leaves():
    leaves = [torch.arange(i % 7 + 1, dtype=torch.float32) for i in range(200)]
    offs = np.cumsum([0] + [t.numel() for t in leaves[:-1]]).tolist()
    total = sum(t.numel() for t in leaves)
    plans = tbp.launch_plan(leaves, offs, 4)
    assert [len(p.rows) for p in plans] == [128, 72]
    assert [i for p in plans for i in p.leaves] == list(range(200))
    got, writes = _emulate_pack(plans, leaves, total * 4)
    assert np.all(writes == 1)
    np.testing.assert_array_equal(
        got.view(np.float32), torch.cat(leaves).numpy())


def test_bucket_pack_launch_plan_drops_empty_leaves():
    leaves = [torch.zeros(0), torch.ones(5), torch.zeros(0)]
    plans = tbp.launch_plan(leaves, [0, 0, 5], 4)
    assert len(plans) == 1 and plans[0].leaves == [1]
    assert plans[0].first == [0, 2] and plans[0].rows[0][1:] == (0, 20)
    assert tbp.launch_plan([torch.zeros(0)], [0], 4) == []
