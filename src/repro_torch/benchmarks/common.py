"""Shared helpers of the benchmark twins, the port of ``benchmarks/common.py``.

``bench_config`` gives the JAX harness's CPU-host sizes (a state of the
~100 MB class); ``card_config`` gives a published config with only its
depth cut, the size the twins run at on the card. There is no
``smoke_env``: the port has no mesh yet.
"""
from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch import configs as C


def bench_config(arch: str, **over):
    cfg = C.get(arch)
    kw = dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
              head_dim=64, d_ff=1024, vocab_size=8192, microbatches=1,
              attn_q_chunk=64, attn_kv_chunk=128)
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=2, moe_d_ff=512)
    if cfg.ssm_state:
        kw.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=32)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=64)
    if cfg.num_patches:
        kw.update(num_patches=16)
    kw.update(over)
    return replace(cfg, name=cfg.name + "-bench", **kw)


def card_config(arch: str, layers: int | None = None, **over):
    """``arch``'s published config at full width, cut to ``layers`` (all of
    them if None), with ``over``'s fields replaced."""
    if layers:
        over["num_layers"] = layers
    return replace(C.get(arch), **over)


def timeit(fn, *args, reps=3, warmup=1, device=None):
    """Median seconds of ``fn(*args)`` over ``reps`` calls after
    ``warmup``: between ``torch.cuda.synchronize()`` calls on the card, by
    the host clock around the call on the CPU."""
    cuda = torch.device(device or "cpu").type == "cuda"

    def call():
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
        return out
    for _ in range(warmup):
        call()
    ts = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def csv_row(name: str, us_per_call: float, derived: str) -> tuple:
    """Print one harness row; returns it as ``(name, us_per_call,
    derived)``."""
    print(f"{name},{us_per_call:.1f},{derived}")
    return name, us_per_call, derived


def cli_device(argv=None) -> str:
    """``--device {cuda,cpu}`` of a twin run as a script (default cuda)."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv).device


def out_path(path: str) -> str:
    """``path`` with its directory made (the ``--json`` reports default to
    ``build/``, which git ignores)."""
    import os
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return path


def checkpointer_for(name: str, state, opt, device):
    """The figure benchmarks' systems by name: Checkmate with a 2-node
    async shadow bootstrapped from ``state`` on ``device``, or a
    copy-persist baseline checkpointing every step (CheckFreq tunes its
    own frequency)."""
    from repro_torch.core import checkpoint as ck
    if name == "checkmate":
        from repro_torch.core.buckets import layout_for_tree
        from repro_torch.core.shadow import ShadowCluster
        shadow = ShadowCluster(layout_for_tree(state.params), opt,
                               n_nodes=2, async_mode=True, device=device)
        shadow.bootstrap(state.params, state.mu, state.nu, state.step)
        return ck.CheckmateCheckpointer(shadow)
    return {"no_checkpoint": ck.NoCheckpointer,
            "sync": lambda: ck.SyncCheckpointer(1),
            "async": lambda: ck.AsyncCheckpointer(1),
            "torch_dcp": lambda: ck.ShardedAsyncCheckpointer(1, n_shards=4),
            "gemini": lambda: ck.GeminiLikeCheckpointer(1),
            "checkfreq": ck.CheckFreqCheckpointer}[name]()


def run_record(name: str, cfg, batch: int, seq: int, stats, ck) -> dict:
    """What a figure benchmark's training run did, for the checks that
    read it (checkpoints, stall stages, steps run, step time)."""
    return {"system": name, "arch": cfg.name, "family": cfg.family,
            "layers": cfg.num_layers, "microbatches": cfg.microbatches,
            "batch": batch, "seq": seq, "steps_run": stats.steps,
            "recoveries": stats.recoveries,
            "checkpoints": ck.n_checkpoints,
            "tuned_freq": getattr(ck, "tuned_freq", None),
            "stall_stages": sorted(ck.stall_stages),
            "stall_total_s": ck.stall_total,
            "steady_iter_s": stats.steady_iter, "losses": stats.losses}
