"""The yardstick's arithmetic at known shapes: model FLOPs, the flash
kernel's operations and bytes, and the device-trace reading."""
import json

import pytest

from bench import flops, trace

GPT2 = dict(family="dense", num_layers=2, d_model=8, num_heads=2,
            num_kv_heads=2, head_dim=4, d_ff=16, vocab_size=10)
VIT = dict(GPT2, family="vit", head_dim=5, num_patches=6)


def test_bench_step_flops_by_hand():
    tr = dict(batch=3, seq=4, microbatches=1)
    per_layer = 2 * 8 * 8 + 2 * 8 * 8 + 2 * 8 * 16      # q,o; k,v; up,down
    weights = 6 * (2 * per_layer + 8 * 10) * 3 * 4
    attn = 3 * 4 * 2 * 4 * (4 * 5 // 2) * 3 * 2          # causal: 10 pairs
    assert flops.step_model_flops(GPT2, tr) == weights + attn
    vit = dict(VIT)
    weights = 6 * (2 * (2 * 8 * 10 + 2 * 8 * 10 + 2 * 8 * 16) * 3 * 6
                   + 8 * 10 * 3)                           # head once a row
    attn = 3 * 4 * 2 * 5 * 36 * 3 * 2                      # full: 36 pairs
    assert flops.step_model_flops(vit, dict(tr, seq=6)) == weights + attn


def test_bench_flash_counts_published_head_dim_and_causal_half():
    tr = dict(batch=4, seq=256, microbatches=2)
    vit = dict(VIT, num_heads=16, num_kv_heads=16, head_dim=80,
               num_patches=256)
    ops, nbytes = flops.flash_launch(vit, tr)
    assert ops == 4 * 2 * 16 * 80 * 256 * 256             # d 80, not 128
    assert nbytes == 2 * 2 * 256 * 80 * 64 + 4 * 2 * 16 * 256
    dense = dict(vit, family="dense")
    causal, _ = flops.flash_launch(dense, tr)
    assert causal == 4 * 2 * 16 * 80 * (256 * 257 // 2)
    assert flops.bound_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert flops.bound_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_bench_union_and_gaps_on_hand_made_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)]
    assert trace.union_s(iv) == pytest.approx(3.0)
    assert trace.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert trace.gaps(iv, 0.5, 3.5) == [(2.0, 3.0)]


def test_bench_profile_from_a_chrome_trace(tmp_path):
    us = 1e6

    def ev(name, cat, t0, t1, tid=1, corr=None, stream=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": t0 * us,
             "dur": (t1 - t0) * us, "tid": tid, "pid": 1, "args": {}}
        if corr is not None:
            e["args"]["correlation"] = corr
        if stream is not None:
            e["args"]["stream"] = stream
        return e
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [ev("cudaLaunchKernel", "cuda_runtime", 0.9, 0.95, corr=1),
              ev(spin, "kernel", 1.0, 1.0, corr=1, stream=7),
              ev(spin, "kernel", 3.0, 3.0, corr=8, stream=7),
              ev(spin, "kernel", 5.0, 5.0, corr=9, stream=7),
              ev("flash_fwd_kernel_wgmma", "kernel", 0.5, 1.5, stream=7),
              ev("Memcpy DtoH", "gpu_memcpy", 2.25, 3.0, stream=7),
              ev("cudaLaunchKernel", "cuda_runtime", 1.9, 1.95, corr=5),
              ev("adamw_kernel<float>", "kernel", 2.0, 2.5, corr=5,
                 stream=7),
              ev("adamw_kernel<float>", "kernel", 5.5, 5.6, stream=13),
              ev("cudaStreamSynchronize", "cuda_runtime", 3.0, 4.5),
              ev("cudaLaunchKernel", "cuda_runtime", 4.6, 4.7, tid=2)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    p = trace.from_chrome_trace(path)
    assert p.wall_s == pytest.approx(4.0) and p.main_tid == 1
    assert p.main_stream == 7 and p.marks == [1.0, 3.0, 5.0]
    assert p.busy_s() == pytest.approx(0.5 + 1.0)          # clipped at 1.0
    # each stretch between two markers: wall, and busy clipped to it
    assert p.iterations() == [(pytest.approx(2.0), pytest.approx(1.5)),
                              (pytest.approx(2.0), pytest.approx(0.0))]
    assert p.kernel_times("adamw_kernel", stream=7) == [pytest.approx(0.5)]
    assert len(p.kernel_times("adamw_kernel")) == 2     # every stream
    assert p.kernel_times("flash_fwd_kernel") == [pytest.approx(1.0)]
    gaps = dict((k, v) for k, v in p.idle_gaps())
    assert gaps["host, before adamw_kernel<float>"] == pytest.approx(0.5)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(2.0)  # open at 4
    assert len(gaps) == 2                  # thread 2's call is not the host's
    assert p.device_ops()[0][0] == "Memcpy DtoH"
