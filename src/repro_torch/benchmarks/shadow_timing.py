"""Fig 7: can the shadow keep up? Batch-size sweep — iteration time vs the
shadow's optimizer time, and the least shadow-node count (§6.3); the port
of ``benchmarks/shadow_timing.py``.

``run()``: on the card (the default) gpt2-1.5b and vit-h-14 at full width,
cut to ``CARD_LAYERS`` layers, each global batch in as many of the
config's microbatches as divide it; on the CPU the JAX module's
``bench_config`` sizes.

``--json`` (`run_json`) compares the flat wire-layout apply (one fused
optimizer pass per bucket, ``ShadowCluster(flat=True)``) with the per-leaf
path on GPT-2 1.5B's per-layer leaf tree (`gpt2_1_5b_leaf_tree`: 12
tensors a layer plus embeddings, the shape a DDP bucketer sees), bucketed
at the default 25 MB cap, and writes ``build/BENCH_shadow.json``. On the
card the tree has its published width (d 1600, vocab 50257, 1024
positions) and ``CARD_JSON_LAYERS`` of its 48 layers, and the gradients
reach the shadow as flats already on the card, so the time is the
update's and not the host-to-device copy both paths share; on the CPU the
JAX module's dimension-scaled tree. It also plans the bucket-sharded
fleet for arctic-480b (`costmodel.shadow_plan_for_config`, metadata only:
nothing model-sized is allocated), which must be sharded (>= 8 nodes)
with each node's resident state within the budget, and times the same
tree sharded across that many nodes: the slowest node's apply per step
(the fleet's critical path) must beat the single-node apply. Finally the
bounded-lag cluster's catch-up under a throttled applier is held against
the unbounded one. It exits nonzero if a gate fails.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.benchmarks.common import (bench_config, card_config,
                                           csv_row, out_path, run_record)
from repro_torch.core.buckets import (alloc_flat, bucket_dtype,
                                      layout_for_tree, pack_bucket_into)
from repro_torch.core.channel import Delivery, InProcessChannel, StepEvent
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.shadow import ShadowCluster, plan_shadow_nodes
from repro_torch.device import resolve
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_state

ARCHS = ("gpt2-1.5b", "vit-h-14")
BATCHES = (2, 8, 16)
SEQ, STEPS = 64, 5
CARD_LAYERS = 2
# the --json tree on the card: published width, 12 of 48 layers
CARD_TREE = dict(d=1600, vocab=50257, pos=1024, n_layers=12)


def cells(device) -> list:
    """[(cfg, batch, seq)] that `run` trains."""
    out = []
    for arch in ARCHS:
        if device.type == "cuda":
            cfg = card_config(arch, CARD_LAYERS)
        else:
            cfg = bench_config(arch)
        for batch in BATCHES:
            out.append((replace(cfg, microbatches=math.gcd(
                batch, cfg.microbatches)), batch, SEQ))
    return out


def run(device=None, init_state=None, record: list | None = None
        ) -> list[tuple]:
    """One row per (model, batch). ``init_state(cfg, seed, device)`` makes
    each run's initial state (default `make_train_state`); ``record``, if
    given, receives each run's `common.run_record` with the shadow's mean
    apply, the planned node count and the keep-up verdict."""
    device = resolve(device)
    opt = OptimizerConfig(lr=1e-3)
    rows = []
    for cfg, batch, seq in cells(device):
        s0 = (init_state or make_train_state)(cfg, 0, device)
        layout = layout_for_tree(s0.params)
        shadow = ShadowCluster(layout, opt, n_nodes=1, device=device)
        shadow.bootstrap(s0.params, s0.mu, s0.nu, 0)
        ck = CheckmateCheckpointer(shadow)
        state, stats = train(cfg, steps=STEPS, batch=batch, seq=seq,
                             opt=opt, state=s0, checkpointer=ck,
                             device=device)
        st = shadow.stats()
        n_min, _ = plan_shadow_nodes(layout, opt, stats.steady_iter,
                                     state.params, device=device)
        del s0, state
        shadow.shutdown()
        keeps_up = st.mean_apply_s < stats.steady_iter
        rows.append(csv_row(f"fig7.{cfg.name}.b{batch}",
                            stats.steady_iter * 1e6,
                            f"iter={stats.steady_iter * 1e3:.0f}ms "
                            f"opt_step={st.mean_apply_s * 1e3:.1f}ms "
                            f"min_nodes={n_min} keeps_up={keeps_up}"))
        if record is not None:
            rec = run_record("checkmate", cfg, batch, seq, stats, ck)
            rec.update(mean_apply_s=st.mean_apply_s, min_nodes=n_min,
                       keeps_up=keeps_up)
            record.append(rec)
    return rows


def gpt2_1_5b_leaf_tree(d: int = 128, vocab: int = 6272, pos: int = 128,
                        n_layers: int = 48, device=None
                        ) -> dict[str, torch.Tensor]:
    """GPT-2 1.5B's per-layer leaf structure (the DDP capture-side view),
    dimension-scaled by default (~12.5x down from d=1600) as the JAX
    module's. On the CPU the values are the JAX module's (numpy, seed 0);
    on the card they are drawn there from a seeded generator."""
    device = resolve(device)
    shapes = {"wte.w": (vocab, d), "wpe.w": (pos, d)}
    for i in range(n_layers):
        pre = f"h{i}."
        shapes.update({
            pre + "ln1.w": (d,), pre + "ln1.b": (d,),
            pre + "attn.qkv.w": (d, 3 * d),
            pre + "attn.qkv.b": (3 * d,),
            pre + "attn.proj.w": (d, d), pre + "attn.proj.b": (d,),
            pre + "ln2.w": (d,), pre + "ln2.b": (d,),
            pre + "mlp.fc.w": (d, 4 * d), pre + "mlp.fc.b": (4 * d,),
            pre + "mlp.proj.w": (4 * d, d), pre + "mlp.proj.b": (d,),
        })
    shapes.update({"lnf.w": (d,), "lnf.b": (d,)})
    return _random_tree(shapes, 0, 0.02, device)


def _random_tree(shapes: dict, seed: int, scale: float, device,
                 gen=None) -> dict:
    """Normal leaves times ``scale``: numpy's stream from ``seed`` on the
    CPU (the JAX module's values); on the card, ``gen`` (or a generator
    seeded ``seed``) there."""
    if device.type == "cpu":
        rng = gen or np.random.default_rng(seed)
        return {k: torch.from_numpy(
            (rng.standard_normal(s).astype(np.float32) * scale))
            for k, s in shapes.items()}
    gen = gen or torch.Generator(device=device).manual_seed(seed)
    return {k: torch.randn(s, generator=gen, device=device) * scale
            for k, s in shapes.items()}


def grad_steps(params: dict, n: int, device, seed: int = 7):
    """``n`` gradient trees (0.01-scaled normals) made one at a time: on
    the CPU the JAX module's list, in its order."""
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    gen = (np.random.default_rng(seed) if device.type == "cpu"
           else torch.Generator(device=device).manual_seed(seed))
    for _ in range(n):
        yield _random_tree(shapes, seed, 0.01, device, gen=gen)


def _deliver(layout, step: int, grads: dict) -> Delivery:
    """One step's gradients packed into wire-layout flats on their own
    device (the bucket-pack kernel on the card), as a delivery."""
    dev = next(iter(grads.values())).device
    flats = {b.bucket_id: pack_bucket_into(
        b, grads, alloc_flat(b.size, bucket_dtype(b), dev))
        for b in layout.buckets}
    return Delivery(step=step, lr=1e-3, grad_scale=1.0, flats=flats,
                    layout=layout)


def _time_paths(layout, params, n_steps, opt, device):
    """Per-step apply seconds of the flat and the per-leaf cluster, each
    step delivered to both in turn (so both see the same machine
    conditions); the first apply is excluded."""
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    shadows = {}
    for mode, flat in (("flat", True), ("legacy", False)):
        shadows[mode] = ShadowCluster(layout, opt, n_nodes=1, flat=flat,
                                      apply_times_maxlen=n_steps + 1,
                                      device=device)
        shadows[mode].bootstrap(params, zeros, zeros, 0)
    for step, grads in enumerate(grad_steps(params, n_steps, device),
                                 start=1):
        d = _deliver(layout, step, grads)
        for mode in ("flat", "legacy"):
            shadows[mode].on_delivery(d)
    out = {}
    for mode in ("flat", "legacy"):
        times = list(shadows[mode].nodes[0].apply_times)[1:]
        out[mode] = {"mean_apply_s": float(np.mean(times)),
                     "max_apply_s": float(np.max(times)),
                     "steps": len(times)}
        shadows[mode].shutdown()
    return out


def _sharded_entry(params, n_steps, opt, device) -> tuple[dict, list[str]]:
    """Plan the arctic-480b shadow fleet (metadata only) and time the leaf
    tree sharded across that many nodes against one node, both on a 1 MB
    bucket layout so every node of the fleet owns shards. The sharded
    figure of merit is the critical path: the slowest node's apply per
    step. Returns the report entry and the gates that failed."""
    from repro_torch import configs
    from repro_torch.core.costmodel import ShadowBudget, shadow_plan_for_config

    budget = ShadowBudget()
    plan = shadow_plan_for_config(configs.get("arctic-480b"), budget=budget)

    layout = layout_for_tree(params, cap_bytes=1 << 20)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    clusters = {
        "single": ShadowCluster(layout, opt, n_nodes=1, device=device,
                                apply_times_maxlen=n_steps + 1),
        "sharded": ShadowCluster(layout, opt, n_nodes=plan.n_nodes,
                                 device=device,
                                 apply_times_maxlen=n_steps + 1),
    }
    for c in clusters.values():
        c.bootstrap(params, zeros, zeros, 0)
    for step, grads in enumerate(grad_steps(params, n_steps, device),
                                 start=1):
        d = _deliver(layout, step, grads)
        for c in clusters.values():
            c.on_delivery(d)
    # slowest owner per step == the distributed fleet's step time; the
    # first apply is excluded
    per_node = [list(n.apply_times)[1:] for n in clusters["sharded"].nodes
                if n.apply_times]
    steps = min(len(t) for t in per_node)
    critical = [max(t[s] for t in per_node) for s in range(steps)]
    single_mean_s = float(np.mean(
        list(clusters["single"].nodes[0].apply_times)[1:]))
    for c in clusters.values():
        c.shutdown()

    entry = {
        "arch": "arctic-480b",
        "plan": {"n_nodes": plan.n_nodes, "ram_bound": plan.ram_bound,
                 "nic_bound": plan.nic_bound, "n_buckets": plan.n_buckets,
                 "grad_bytes": plan.grad_bytes,
                 "state_bytes": plan.state_bytes,
                 "bytes_per_node_max": plan.bytes_per_node_max,
                 "gbps_per_node_max": plan.gbps_per_node_max,
                 "usable_ram_per_node": budget.usable_ram},
        "timing": {"workload": "gpt2-1.5b leaf tree (1 MB buckets)",
                   "n_nodes": plan.n_nodes,
                   "n_timing_buckets": len(layout.buckets),
                   "owners_with_shards": len(per_node),
                   "critical_path_mean_s": float(np.mean(critical)),
                   "critical_path_max_s": float(np.max(critical)),
                   "single_node_mean_s": single_mean_s,
                   "speedup_vs_single": single_mean_s
                   / float(np.mean(critical)),
                   "steps": steps},
    }
    fails = []
    if plan.n_nodes < 8:
        fails.append(f"arctic-480b plan is {plan.n_nodes} nodes; the "
                     "frontier fleet must be genuinely sharded (>= 8)")
    if plan.bytes_per_node_max > budget.usable_ram:
        fails.append("per-node peak RSS proxy "
                     f"({plan.bytes_per_node_max / 1e9:.1f} GB) exceeds "
                     f"usable RAM ({budget.usable_ram / 1e9:.1f} GB)")
    if float(np.mean(critical)) >= single_mean_s:
        fails.append("sharded critical path "
                     f"({np.mean(critical) * 1e3:.2f} ms) is not faster "
                     f"than the single-node apply "
                     f"({single_mean_s * 1e3:.2f} ms)")
    return entry, fails


def _overlapped_entry(opt, device, steps: int = 10, delay_s: float = 0.01,
                      max_lag: int = 3) -> tuple[dict, list[str]]:
    """Overlapped multi-step apply under a throttled applier: the
    bounded-lag cluster (batched K-step catch-up) against the unbounded
    one-delivery-per-wakeup path. Both are throttled alike, so the figure
    of merit is the backlog's shape: the bounded cluster holds its queue
    at the bound and drains in O(K) applies at consolidate, where the
    other backlogs O(steps)."""
    def drive(max_lag_steps):
        tree = gpt2_1_5b_leaf_tree(n_layers=4, device=device)
        layout = layout_for_tree(tree, cap_bytes=1 << 20)
        shadow = ShadowCluster(layout, opt, n_nodes=2, async_mode=True,
                               max_lag_steps=max_lag_steps, device=device)
        for node in shadow.nodes:       # throttle the update itself so
            orig = node._apply          # batched replays pay it per step
            node._apply = (lambda *a, _o=orig:
                           (time.sleep(delay_s), _o(*a))[1])
        zeros = {k: torch.zeros_like(v) for k, v in tree.items()}
        shadow.bootstrap(tree, zeros, zeros, 0)
        grads = next(grad_steps(tree, 1, device, seed=3))
        chan = InProcessChannel()
        chan.open(layout)
        for step in range(1, steps + 1):
            chan.send(StepEvent(step=step, grads=grads, lr=1e-3))
            for d in chan.poll():
                shadow.on_delivery(d)
        chan.close()
        t0 = time.perf_counter()
        ck = shadow.consolidate(timeout=120)
        drain_s = time.perf_counter() - t0
        st = shadow.stats()
        shadow.shutdown()
        if ck["step"] != steps:
            raise RuntimeError(f"consolidated at {ck['step']}, not {steps}")
        return {"max_queue_depth": st.max_queue_depth,
                "batched_applies": st.batched_applies,
                "max_batch": st.max_batch,
                "lag_waits": st.lag_waits,
                "lag_wait_s": st.lag_wait_s,
                "drain_s": drain_s}

    bounded = drive(max_lag)
    unbounded = drive(None)
    entry = {
        "workload": f"async shadow, throttled applier "
                    f"({delay_s * 1e3:.0f} ms/apply), {steps} steps",
        "max_lag_steps": max_lag,
        "bounded": bounded,
        "unbounded": unbounded,
    }
    fails = []
    if bounded["max_queue_depth"] > max_lag:
        fails.append(f"bounded-lag queue reached "
                     f"{bounded['max_queue_depth']}, past the bound "
                     f"{max_lag}")
    if unbounded["max_queue_depth"] <= max_lag:
        fails.append("the throttled sequential path never backlogged past "
                     "the bound — the comparison is vacuous")
    if bounded["batched_applies"] < 1:
        fails.append("no multi-step batched catch-up replay ran on the "
                     "bounded-lag path")
    if bounded["drain_s"] >= unbounded["drain_s"]:
        fails.append(f"bounded-lag drain ({bounded['drain_s']:.3f}s) is "
                     f"not faster than the sequential backlog drain "
                     f"({unbounded['drain_s']:.3f}s)")
    return entry, fails


def run_json(out: str = "build/BENCH_shadow.json", steps: int = 8,
             device=None, tree: dict | None = None) -> tuple[int, dict]:
    """(exit code, report); the report is also written to ``out``.
    ``tree`` overrides the leaf tree's dimensions (`gpt2_1_5b_leaf_tree`
    keywords)."""
    device = resolve(device)
    opt = OptimizerConfig(lr=1e-3)
    if tree is None:
        tree = CARD_TREE if device.type == "cuda" else {}
    params = gpt2_1_5b_leaf_tree(**tree, device=device)
    layout = layout_for_tree(params)          # default DDP 25 MB cap

    timed = _time_paths(layout, params, steps + 1, opt, device)
    flat, legacy = timed["flat"], timed["legacy"]
    speedup = legacy["mean_apply_s"] / flat["mean_apply_s"]
    sharded, shard_fails = _sharded_entry(params, steps + 1, opt, device)
    overlapped, overlap_fails = _overlapped_entry(opt, device)
    report = {
        "arch": "gpt2-1.5b (per-layer leaf structure)",
        "tree": dict(tree),
        "device": str(device),
        "n_buckets": len(layout.buckets),
        "n_leaves": sum(len(b.slots) for b in layout.buckets),
        "state_bytes": layout.total_bytes,
        "flat": flat,
        "legacy": legacy,
        "speedup": speedup,
        "sharded": sharded,
        "overlapped": overlapped,
    }
    with open(out_path(out), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    fails = list(shard_fails) + list(overlap_fails)
    if flat["mean_apply_s"] >= legacy["mean_apply_s"]:
        fails.append("flat apply is not faster than the legacy per-leaf "
                     "path")
    for msg in fails:
        print(f"FAIL: {msg}", file=sys.stderr)
    report["fails"] = fails
    return (1 if fails else 0), report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", action="store_true",
                    help="flat-vs-per-leaf apply benchmark; write "
                         "build/BENCH_shadow.json and gate on flat being "
                         "faster")
    ap.add_argument("--out", default="build/BENCH_shadow.json")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.json:
        sys.exit(run_json(args.out, steps=args.steps,
                          device=args.device)[0])
    run(device=args.device)
