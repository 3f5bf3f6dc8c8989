"""Durability plane cost: delta bytes and trainer stall on GPT-2 1.5B's
per-layer leaf tree, the port of ``benchmarks/durability_timing.py``.

The tiered persistence layer (`repro_torch.durability`) claims two
numbers, and ``--json`` (`run_json`) gates both:

* **delta bytes << full-state bytes** — an int8 compressed flush epoch
  moves a fraction of the f32 base sweep;
* **flush adds 0.0 trainer stall** — flushing runs on the per-node
  `FlushWorker` threads, so the checkpointer's stall ledger
  (``stall_stages``) holds no flush, durability or tier stage.

A raw-policy restore must also be bitwise ``consolidate()``. ``--json``
writes ``build/BENCH_durability.json`` (the JAX package's report at the
repo root is its own) and exits nonzero if a gate fails; the default mode
prints the harness CSV rows. The shadow runs on ``device`` (the card
unless ``"cpu"``), the tier under a temporary directory. On the card the
tree has its published width, 4 of 48 layers (``CARD_TREE``), and the
gradients are made there; on the CPU it is the JAX module's
dimension-scaled tree.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import csv_row, out_path
from repro_torch.benchmarks import shadow_timing
from repro_torch.benchmarks.shadow_timing import (grad_steps,
                                                  gpt2_1_5b_leaf_tree)
from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.channel import StepEvent
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.shadow import ShadowCluster
from repro_torch.device import resolve
from repro_torch.durability import (DurableShadow, FlushPolicy, LocalDiskTier,
                                    restore_from_tiers)
from repro_torch.obs.stalls import KNOWN_STAGES
from repro_torch.optim.functional import OptimizerConfig

FLUSH_STAGE_WORDS = ("flush", "durability", "tier")
# the tree on the card: shadow_timing's at its published width, 4 of 48
# layers (each raw epoch writes the whole 2.5 GB state to disk)
CARD_TREE = dict(shadow_timing.CARD_TREE, n_layers=4)


def _drive(params, layout, steps, opt, policy, root, device, n_nodes=2):
    """One checkpointed run with a durability plane attached. Returns
    (stall_stages, tier, dur, consolidated, flush_wall_s)."""
    shadow = ShadowCluster(layout, opt, n_nodes=n_nodes, device=device)
    tier = LocalDiskTier(root)
    dur = DurableShadow([tier], policy).attach(shadow)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    shadow.bootstrap(params, zeros, zeros, 0)
    del zeros
    ck = CheckmateCheckpointer(shadow, durability=dur)
    t_flush = 0.0
    for step, grads in enumerate(grad_steps(params, steps, device),
                                 start=1):
        ck.on_step(StepEvent(step=step, grads=grads, lr=1e-3))
        t0 = time.perf_counter()
        dur.drain()                      # background worker time, measured
        t_flush += time.perf_counter() - t0
    ckpt = shadow.consolidate(timeout=120)
    stages = dict(ck.stall_stages)
    ck.finalize()
    shadow.shutdown()
    return stages, tier, dur, ckpt, t_flush


def _tree(device, tree):
    if tree is None:
        tree = CARD_TREE if device.type == "cuda" else {}
    return tree, gpt2_1_5b_leaf_tree(**tree, device=device)


def run_json(out: str = "build/BENCH_durability.json", steps: int = 6,
             device=None, tree: dict | None = None) -> tuple[int, dict]:
    """(exit code, report); the report is also written to ``out``.
    ``tree`` overrides the leaf tree's dimensions."""
    device = resolve(device)
    opt = OptimizerConfig(lr=1e-3)
    tree, params = _tree(device, tree)
    layout = layout_for_tree(params)         # default DDP 25 MB cap
    state_bytes = 3 * layout.total_bytes     # params + mu + nu, f32
    fails: list[str] = []

    with tempfile.TemporaryDirectory(prefix="bench-dur-raw-") as root:
        raw_stages, raw_tier, raw_dur, ckpt, raw_flush_s = _drive(
            params, layout, steps, opt, FlushPolicy(), root, device)
        raw_epoch_bytes = raw_tier.put_bytes_total / max(
            1, raw_dur.epochs_started)
        t0 = time.perf_counter()
        restored = restore_from_tiers([raw_tier], layout, n_nodes=2)
        restore_s = time.perf_counter() - t0
        if restored["step"] != steps:
            fails.append(f"raw restore landed at {restored['step']}, "
                         f"trainer is at {steps}")
        bitwise = True
        for part in ("params", "mu", "nu"):
            for k in ckpt[part]:
                if not torch.equal(restored[part][k].cpu(),
                                   ckpt[part][k].cpu()):
                    fails.append(f"raw restore differs from consolidate "
                                 f"at {part}[{k}]")
                    bitwise = False
                    break
        del restored, ckpt

    with tempfile.TemporaryDirectory(prefix="bench-dur-q-") as root:
        # one f32 base epoch, then int8 diff deltas all the way
        q_stages, q_tier, q_dur, _, q_flush_s = _drive(
            params, layout, steps, opt,
            FlushPolicy(compress=True, rebase_every=steps + 1), root,
            device)
        ents = q_tier.entries()
        base_bytes = sum(e.nbytes for e in ents if e.kind == "base")
        delta_epochs = sorted({e.epoch for e in ents if e.kind == "delta"})
        epoch_delta = [sum(e.nbytes for e in ents
                           if e.kind == "delta" and e.epoch == ep)
                       for ep in delta_epochs]
        delta_mean = float(np.mean(epoch_delta)) if epoch_delta else 0.0

    # -- gates ---------------------------------------------------------------
    if not delta_epochs:
        fails.append("compressed run produced no delta epochs")
    if delta_mean >= state_bytes / 3:
        fails.append(f"compressed delta epoch moves {delta_mean / 1e6:.2f} "
                     f"MB, not << the {state_bytes / 1e6:.2f} MB full "
                     "state (int8 diffs should be ~4x smaller)")
    for label, stages in (("raw", raw_stages), ("compressed", q_stages)):
        flushy = [s for s in stages
                  if any(w in s.lower() for w in FLUSH_STAGE_WORDS)]
        if flushy:
            fails.append(f"{label} run booked trainer stall on flush "
                         f"stages {flushy}: flushing must be free")
        unknown = [s for s in stages if s not in KNOWN_STAGES]
        if unknown:
            fails.append(f"{label} run booked stall on stages {unknown} "
                         f"outside the ledger vocabulary {KNOWN_STAGES}")

    report = {
        "arch": "gpt2-1.5b (per-layer leaf structure)",
        "tree": dict(tree),
        "device": str(device),
        "steps": steps,
        "n_buckets": len(layout.buckets),
        "state_bytes": state_bytes,
        "raw": {
            "epoch_bytes_mean": raw_epoch_bytes,
            "flush_wall_s_total": raw_flush_s,
            "stall_stages": raw_stages,
            "restore_s": restore_s,
            "restore_bitwise": bitwise,
        },
        "compressed": {
            "base_bytes": base_bytes,
            "delta_epoch_bytes_mean": delta_mean,
            "delta_vs_state": delta_mean / state_bytes,
            "flush_wall_s_total": q_flush_s,
            "stall_stages": q_stages,
        },
        "flush_stall_s": 0.0 if not fails else None,
    }
    with open(out_path(out), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    for msg in fails:
        print(f"FAIL: {msg}", file=sys.stderr)
    report["fails"] = fails
    return (1 if fails else 0), report


def run(device=None, tree: dict | None = None) -> list[tuple]:
    """CSV rows for the benchmark harness: 4 steps on the tree trimmed to
    8 layers (on the CPU; the card's tree otherwise)."""
    device = resolve(device)
    opt = OptimizerConfig(lr=1e-3)
    if tree is None and device.type == "cpu":
        tree = {"n_layers": 8}
    tree, params = _tree(device, tree)
    layout = layout_for_tree(params)
    state_bytes = 3 * layout.total_bytes
    steps, rows = 4, []
    for label, policy in (("raw", FlushPolicy()),
                          ("int8", FlushPolicy(compress=True,
                                               rebase_every=5))):
        with tempfile.TemporaryDirectory(prefix="bench-dur-") as root:
            stages, tier, dur, _, flush_s = _drive(
                params, layout, steps, opt, policy, root, device)
            epoch_bytes = tier.put_bytes_total / max(1, dur.epochs_started)
            rows.append(csv_row(f"durability.{label}",
                                flush_s / steps * 1e6,
                                f"epoch_bytes={epoch_bytes:.0f} "
                                f"state_bytes={state_bytes} "
                                f"stall_stages={sorted(stages)}"))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", action="store_true",
                    help="delta-size + zero-flush-stall gates; write "
                         "build/BENCH_durability.json")
    ap.add_argument("--out", default="build/BENCH_durability.json")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.json:
        sys.exit(run_json(args.out, steps=args.steps,
                          device=args.device)[0])
    run(device=args.device)
