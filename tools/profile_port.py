"""Where a training step's, or a serving run's, device time goes in the
PyTorch/CUDA port.

    python3 tools/profile_port.py                    # the main path
    python3 tools/profile_port.py --family whisper vit   # phase 8's runs
    python3 tools/profile_port.py --serve dense zamba2   # phase 9's runs

Runs the main path of ``chip_smoke.py`` (tinyllama-1.1b, all 22 layers, with
its ``MAIN_RUN``: global batch 8 x seq 2048 through an in-process channel
into a 2-node async shadow on the card), or with ``--family`` each named
run of its phase 8 (``FAMILY_CELLS``: the config as cut there, batch 4 in 2
microbatches, through the same channel and shadow), warms up for 2 steps,
then records 2 steps with ``torch.profiler``. Prints one JSON line per run:
wall ms per step, device busy ms (the union of kernel and copy intervals
over all streams) and idle share, device time by category, and the
kernels that take the most device time. With ``--serve`` each named run of
its phase 9 (``serve_cells()``: the config, batch and prompt there, f32
params cast by ``serving_params``, bf16 compute) prefills once unprofiled,
then records one prefill and, after WARMUP decode steps, DECODE_STEPS
greedy decode steps, with the same summary for each and the kernels
launched per step (a decode step whose wall exceeds its busy time by far
is paced by the host). Needs one GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402

WARMUP, STEPS = 2, 2
DECODE_STEPS = 8

CATEGORIES = (                 # first match wins, on the lower-cased name
    ("flash_fwd (port kernel)", ("flash_fwd_kernel",)),
    ("adamw (port kernel)", ("adamw_kernel",)),
    ("bucket_pack (port kernel)", ("pack_kernel",)),
    ("matmul (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "nvjet")),
    ("copy host<->device", ("memcpy htod", "memcpy dtoh")),
    ("copy device", ("memcpy dtod", "memset")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other (elementwise, reductions, softmax)"


def union_ms(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def profile_run(label: str, cfg, run: dict) -> dict:
    """Profile ``train(cfg, **run)``'s steps WARMUP+1..WARMUP+STEPS."""
    from repro_torch.core.channel import InProcessChannel
    from repro_torch.train.loop import train

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def hook(step, state, stats):
        if step == WARMUP:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif step == WARMUP + STEPS:
            torch.cuda.synchronize()
            window["t1"] = time.perf_counter()
            prof.stop()

    _, stats = train(cfg, steps=WARMUP + STEPS, channel=InProcessChannel(),
                     step_hook=hook, device="cuda", **run)
    stats.checkpointer.shadow.shutdown()

    return {"run": label, "card": card(), "layers": cfg.num_layers,
            "steps": STEPS,
            **summarize(prof, (window["t1"] - window["t0"]) * 1e3, STEPS),
            "iter_ms": [t * 1e3 for t in stats.iter_times]}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def summarize(prof, wall_ms: float, n: int) -> dict:
    """Per step of ``n`` profiled: wall, device busy (the union of kernel
    and copy intervals) and idle share, device time by category, the top
    kernels, and the device events (kernels and copies) launched."""
    by_name = defaultdict(float)
    intervals = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] += dur / 1e3
        intervals.append((e.time_range.start, e.time_range.end))
    if not intervals:
        raise SystemExit("profile_port: the profiler recorded no device time")
    by_cat = defaultdict(float)
    for name, ms in by_name.items():
        by_cat[category(name)] += ms
    wall = wall_ms / n
    busy = union_ms(intervals) / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy / wall,
        "device_events_per_step": len(intervals) / n,
        "device_ms_per_step_by_category": {
            k: v / n for k, v in sorted(by_cat.items(),
                                        key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [(name[:90], ms / n)
                                    for name, ms in top],
    }


def profile_serve(label: str) -> dict:
    """Profile phase 9's run ``label``: one prefill, then DECODE_STEPS
    greedy decode steps after WARMUP."""
    from repro_torch.launch.serve import max_seq_for
    from repro_torch.models import registry
    from repro_torch.train.step import build_decode_step, serving_params
    _, _, b, prompt, steps = chip_smoke.serve_cells()[label]
    cfg = chip_smoke.serve_cfg(label)
    params = serving_params(cfg, registry.init_params(cfg, seed=0,
                                                      device="cuda"))
    toks, extra = chip_smoke.serve_inputs(cfg, b, prompt, torch.bfloat16,
                                          "cuda")
    max_seq = max_seq_for(cfg, prompt, steps)
    registry.prefill(params, cfg, toks, max_seq, **extra)      # warm-up
    out = {"run": label, "card": card(), "layers": cfg.num_layers,
           "batch": b, "prompt": prompt}

    def profiled(fn, n):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prof.stop()
        return result, summarize(prof, (t1 - t0) * 1e3, n)

    (cache, logits), out["prefill"] = profiled(
        lambda: registry.prefill(params, cfg, toks, max_seq, **extra), 1)
    decode = build_decode_step(cfg)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(WARMUP):
        tok, cache = decode(params, cache, tok)

    def run():
        t, c = tok, cache
        for _ in range(DECODE_STEPS):
            t, c = decode(params, c, t)
        return t
    _, out["decode"] = profiled(run, DECODE_STEPS)
    del params, cache
    return out


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: needs a GPU")
    from repro_torch import configs
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(json.dumps(profile_run("main", configs.get("tinyllama-1.1b"),
                                     chip_smoke.MAIN_RUN)))
        return
    if argv[0] == "--serve":
        cells = chip_smoke.serve_cells()
        if not set(argv[1:]) <= set(cells):
            raise SystemExit(f"usage: profile_port.py --serve [LABEL ...], "
                             f"LABEL in {list(cells)}")
        for label in argv[1:] or cells:
            print(json.dumps(profile_serve(label)), flush=True)
            chip_smoke._free()
        return
    if argv[0] != "--family" or not set(argv[1:]) <= set(
            chip_smoke.FAMILY_CELLS):
        raise SystemExit(f"usage: profile_port.py [--family LABEL ...], "
                         f"LABEL in {list(chip_smoke.FAMILY_CELLS)}")
    for label in argv[1:] or chip_smoke.FAMILY_CELLS:
        run = dict(batch=chip_smoke.FAMILY_BATCH,
                   seq=chip_smoke.FAMILY_CELLS[label][2], shadow_nodes=2,
                   shadow_async=True)
        print(json.dumps(profile_run(label, chip_smoke.family_cfg(label),
                                     run)), flush=True)
        chip_smoke._free()


if __name__ == "__main__":
    main()
