"""The port's int8 + error-feedback codec and compressed channel against the
JAX package's, on the same numpy inputs.

Tolerance: none for the codec. Quantized payloads, scales, dequantized
values, error-feedback residuals (over several steps) and wire bytes must
be equal bit for bit, including an all-zero leaf and subnormal values
(both packages count them as zero). The compressed shadow must equal the
port's own trainer applying the same dequantized stream bit for bit, and
the JAX compressed shadow to the packages' AdamW tolerance (rtol 1e-5,
atol 1e-6, as in tests/test_torch_shadow.py: the JAX package takes
``b1 ** step`` on its device, the port once on the host).
"""
import numpy as np
import pytest
import torch

import repro.core.channel as jch
import repro.core.shadow as jsh
import repro.dist.compression as jcp
from repro.core.buckets import layout_for_tree as j_layout
from repro.optim import OptimizerConfig as JOpt

from repro_torch.core import channel as tch
from repro_torch.core import shadow as tsh
from repro_torch.core.buckets import layout_for_tree as t_layout
from repro_torch.dist import compression as tcp
from repro_torch.optim.functional import (OptimizerConfig, TrainState,
                                          apply_updates)

torch.set_num_threads(2)   # leave cores to the other test workers

SHAPES = {"a_embed": (64, 16), "b_norm": (16,), "c_w": (3, 16, 24),
          "d_out": (24, 64), "e_zero": (40,), "f_tiny": (33,)}
CAP = 4096


def _bits(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _leaf(rng, kind, n):
    if kind == "zero":
        return np.zeros(n, np.float32)
    if kind == "tiny":             # subnormal, around tiny, and one normal
        g = rng.standard_normal(n).astype(np.float32) * np.float32(2e-38)
        g[::5] = np.float32(1e-45)
        g[1] = np.float32(1e-30)
        return g
    if kind == "huge":
        return (rng.standard_normal(n) * 1e30).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    g[::7] = 0.0
    g[3::11] *= np.float32(1e-3)
    return g


@pytest.mark.parametrize("kind", ["normal", "zero", "tiny", "huge"])
def test_quantize_leaf_bitwise_jax_over_steps(kind):
    rng = np.random.default_rng(0)
    ej = np.zeros(257, np.float32)
    et = torch.zeros(257)
    for _ in range(5):
        g = _leaf(rng, kind, 257)
        jq, js, ej = jcp.quantize_leaf(g, ej)
        tq, ts, et = tcp.quantize_leaf(torch.from_numpy(g), et)
        assert _bits(jq) == _bits(tq.numpy())
        assert _bits(np.float32(js)) == _bits(ts.numpy())
        assert _bits(ej) == _bits(et.numpy())
        assert _bits(jcp.dequantize_leaf(jq, js)) == \
            _bits(tcp.dequantize_leaf(tq, ts).numpy())


def _grads(seed, steps=4):
    rng = np.random.default_rng(seed)
    kinds = {"e_zero": "zero", "f_tiny": "tiny"}
    return [{k: _leaf(rng, kinds.get(k, "normal"),
                      int(np.prod(s))).reshape(s) * np.float32(0.01)
             for k, s in SHAPES.items()} for _ in range(steps)]


def _layouts():
    like = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    jl = j_layout(like, cap_bytes=CAP)
    tl = t_layout({k: torch.from_numpy(v) for k, v in like.items()},
                  cap_bytes=CAP)
    assert [[(s.name, s.offset) for s in b.slots] for b in jl.buckets] == \
        [[(s.name, s.offset) for s in b.slots] for b in tl.buckets]
    return jl, tl


def _flats(layout, grads):
    out = {}
    for b in layout.buckets:
        out[b.bucket_id] = np.concatenate(
            [grads[s.name].reshape(-1) for s in b.slots])
    return out


def test_stateless_flat_pair_bitwise_jax():
    jl, tl = _layouts()
    flats = _flats(jl, _grads(1, 1)[0])
    for jb, tb in zip(jl.buckets, tl.buckets):
        jq, js = jcp.quantize_flat_stateless(jb, flats[jb.bucket_id])
        tq, ts = tcp.quantize_flat_stateless(
            tb, torch.from_numpy(flats[tb.bucket_id]))
        assert _bits(jq) == _bits(tq.numpy())
        assert _bits(js) == _bits(ts.numpy())
        assert _bits(jcp.dequantize_flat_stateless(jb, jq, js)) == \
            _bits(tcp.dequantize_flat_stateless(tb, tq, ts).numpy())


def test_compressor_flats_and_residuals_bitwise_jax_over_steps():
    jl, tl = _layouts()
    jc, tc = jcp.Compressor(), tcp.Compressor()
    assert tc.ef is None
    for grads in _grads(2, 5):
        flats = _flats(jl, grads)
        jd = jc.compress_flats(jl, flats)
        td = tc.compress_flats(tl, {b: torch.from_numpy(f.copy())
                                    for b, f in flats.items()})
        for bid in jd:
            assert _bits(jd[bid]) == _bits(td[bid].numpy()), bid
        for k in SHAPES:
            assert _bits(jc.ef[k]) == _bits(tc.ef[k].numpy()), k
    assert tc.wire_bytes_total == jc.wire_bytes_total
    assert tc.raw_bytes_total == jc.raw_bytes_total
    assert tc.ratio == jc.ratio > 3.5


def _run_jax(params, stream, n_nodes):
    layout = j_layout(params, cap_bytes=CAP)
    cl = jsh.ShadowCluster(layout, JOpt(), n_nodes=n_nodes)
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    cl.bootstrap(params, zeros, zeros, 0)
    ch = jch.CompressedChannel(jch.InProcessChannel())
    ch.open(layout)
    got = []
    for i, g in enumerate(stream):
        ch.send(jch.StepEvent(step=i + 1, grads=g, lr=1e-3))
        for d in ch.poll():
            got.append((d.wire_bytes,
                        {b: np.asarray(f) for b, f in d.flats.items()}))
            cl.on_delivery(d)
    parts = list(ch.last_send_parts)
    return cl.consolidate(), got, parts


def _run_port(params, stream, n_nodes, async_mode, max_lag_steps=None):
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    layout = t_layout(tparams, cap_bytes=CAP)
    cl = tsh.ShadowCluster(layout, OptimizerConfig(), n_nodes=n_nodes,
                           async_mode=async_mode, device="cpu",
                           max_lag_steps=max_lag_steps)
    zeros = {k: torch.zeros(v.shape) for k, v in params.items()}
    cl.bootstrap(tparams, zeros, zeros, 0)
    ch = tch.CompressedChannel(tch.InProcessChannel())
    ch.open(layout)
    got = []
    for i, g in enumerate(stream):
        ch.send(tch.StepEvent(step=i + 1, lr=1e-3, grads={
            k: torch.from_numpy(v) for k, v in g.items()}))
        for d in ch.poll():
            got.append((d.wire_bytes,
                        {b: f.clone() for b, f in d.flats.items()}))
            cl.on_delivery(d)
    parts = list(ch.last_send_parts)
    out = cl.consolidate(timeout=30)
    cl.shutdown()
    return out, got, parts, ch


@pytest.mark.parametrize("async_mode,lag", [(False, None), (True, 2)])
def test_compressed_shadow_against_jax_and_the_ports_trainer(async_mode, lag):
    stream = _grads(3, 4)
    rng = np.random.default_rng(4)
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()}
    want, wdel, wparts = _run_jax(params, stream, 2)
    got, tdel, tparts, ch = _run_port(params, stream, 2, async_mode, lag)
    assert tparts == wparts == ["quantize", "send"]
    assert ch.name == "compressed[inprocess]"
    # the delivered stream: bitwise, with the same wire bytes
    assert [w for w, _ in tdel] == [w for w, _ in wdel]
    for (_, tf), (_, jf) in zip(tdel, wdel):
        for bid in jf:
            assert _bits(tf[bid].numpy()) == _bits(jf[bid]), bid
    # the shadow: bitwise the port's trainer on the same dequantized stream
    state = TrainState(
        params={k: torch.from_numpy(v.copy()) for k, v in params.items()},
        mu={k: torch.zeros(s) for k, s in SHAPES.items()},
        nu={k: torch.zeros(s) for k, s in SHAPES.items()}, step=0)
    tl = t_layout(state.params, cap_bytes=CAP)
    for _, flats in tdel:
        deq = {s.name: flats[b.bucket_id][s.offset:s.offset + s.size]
               .reshape(s.shape) for b in tl.buckets for s in b.slots}
        apply_updates(state, deq, OptimizerConfig(), 1e-3)
    assert got["step"] == state.step == len(stream)
    for tree in ("params", "mu", "nu"):
        for k, t in getattr(state, tree).items():
            assert torch.equal(got[tree][k], t), (tree, k)
            np.testing.assert_allclose(t.numpy(), np.asarray(want[tree][k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{tree}[{k}]")


def test_compressed_channel_takes_device_flats_and_forwards_revival():
    ch = tch.CompressedChannel()
    assert ch.device_flats and not getattr(tch.InProcessChannel(),
                                           "device_flats", False)
    revived = []
    inner = tch.InProcessChannel()
    inner.revive_all = lambda: revived.append(True)
    inner.kill_shadow_node = lambda n: revived.append(n)
    ch = tch.CompressedChannel(inner)
    ch.revive_all()
    ch.kill_shadow_node(1)
    assert revived == [True, 1]


def test_compressed_train_run_books_quantize():
    """The loop hands the compressed channel its capture; the quantize is
    booked as its own stage and the shadow follows the compressed stream
    to the trainer's step."""
    from repro_torch import configs as TC
    from repro_torch.train.loop import train
    state, stats = train(TC.get("tinyllama-1.1b").reduced(), steps=3,
                         batch=2, seq=16, device="cpu",
                         channel=tch.CompressedChannel())
    ck = stats.checkpointer
    assert list(ck.stall_stages) == ["quantize", "send", "inline-apply"]
    assert ck.shadow.consolidate()["step"] == state.step == 3
    assert ck.channel.compressor.ratio > 3.5
    assert len(stats.capture_times) == 3


# -- the leaf-tree path ----------------------------------------------------------

def test_compress_tree_bitwise_jax_over_steps():
    """``init_error_feedback`` then four ``compress_tree`` steps: the
    dequantized tree, the residuals and the wire bytes bitwise the JAX
    package's (zero and subnormal leaves included)."""
    jef = jcp.init_error_feedback({k: np.zeros(s, np.float32)
                                   for k, s in SHAPES.items()})
    tef = tcp.init_error_feedback({k: torch.zeros(s)
                                   for k, s in SHAPES.items()})
    for k in SHAPES:
        assert tef[k].dtype == torch.float32
        assert _bits(tef[k].numpy()) == _bits(jef[k])
    for g in _grads(11):
        jdeq, jef, jwire = jcp.compress_tree(g, jef)
        tdeq, tef, twire = tcp.compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, tef)
        assert twire == jwire == sum(v.size + 4 for v in g.values())
        assert set(tdeq) == set(jdeq) == set(tef) == set(SHAPES)
        for k in SHAPES:
            assert _bits(tdeq[k].numpy()) == _bits(jdeq[k]), k
            assert _bits(tef[k].numpy()) == _bits(jef[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_ratio_equals_jax(dtype):
    import ml_dtypes
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    tree = {k: np.zeros(s, np_dt) for k, s in SHAPES.items()}
    ttree = {k: torch.zeros(s, dtype=getattr(torch, dtype))
             for k, s in SHAPES.items()}
    assert tcp.compression_ratio(ttree) == jcp.compression_ratio(tree)
    assert 1.5 < tcp.compression_ratio(ttree) < 4.0
