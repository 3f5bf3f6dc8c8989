"""Fig 8: the optimizer step's time falls about linearly as the shadow is
split across more nodes, the port of ``benchmarks/optimizer_scaling.py``.

The nodes share one device here; each node's apply is timed alone, as if
the nodes ran in parallel, and a step of the fleet costs its slowest
node's. On the card (the default) the model is gpt3-6.7b at full width
(d_model 4096, d_ff 16384, vocab 50257), cut to ``CARD_LAYERS`` of its 32
layers, and each apply receives its gradient buckets from pinned host
memory, as a capture delivers them; on the CPU it is the JAX module's
``bench_config`` cut.
"""
from __future__ import annotations

import time

import torch

from repro_torch.benchmarks.common import (bench_config, card_config,
                                           cli_device, csv_row)
from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.channel import InProcessChannel, StepEvent, to_host
from repro_torch.core.shadow import ShadowCluster
from repro_torch.device import resolve
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.step import make_train_state

NODES = (1, 2, 4, 8)
CARD_LAYERS = 2
REPS = 3


def default_config(device):
    if device.type == "cuda":
        return card_config("gpt3-6.7b", CARD_LAYERS)
    return bench_config("gpt3-6.7b", num_layers=6, d_model=512, d_ff=2048,
                        vocab_size=16384)


def run(device=None, cfg=None, init_state=None,
        clusters: list | None = None) -> list[tuple]:
    """One row per node count. ``init_state(cfg, seed, device)`` makes the
    initial state (default `make_train_state`); ``clusters``, if given,
    receives each `ShadowCluster`, left open."""
    device = resolve(device)
    cfg = cfg or default_config(device)
    opt = OptimizerConfig(lr=1e-3)
    s0 = (init_state or make_train_state)(cfg, 0, device)
    params = s0.params
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    layout = layout_for_tree(params)
    rows, base = [], None
    for nodes in NODES:
        shadow = ShadowCluster(layout, opt, n_nodes=nodes, device=device)
        shadow.bootstrap(params, zeros, zeros, 0)
        chan = InProcessChannel()
        chan.open(layout)
        chan.send(StepEvent(step=1, grads=grads, lr=1e-3))     # warmup
        for d in chan.poll():
            shadow.on_delivery(d)
        # each node's apply measured alone; the fleet's step is the max
        # over nodes (they run on separate machines in the paper)
        flats = to_host({b.bucket_id: torch.ones(b.size, device=device)
                         for b in layout.buckets})
        per_node = []
        for node in shadow.nodes:
            sub = {bid: flats[bid] for bid in node.bucket_ids}
            node.apply(2, 1e-3, sub)                 # per-node warmup
            reps = []
            for r in range(REPS):
                t0 = time.perf_counter()
                node.apply(3 + r, 1e-3, sub)        # ends in a sync
                reps.append(time.perf_counter() - t0)
            per_node.append(min(reps))
        t = max(per_node) if per_node else 0.0
        base = base or t
        rows.append(csv_row(f"fig8.nodes{nodes}", t * 1e6,
                            f"opt_step={t * 1e3:.1f}ms "
                            f"speedup={base / max(t, 1e-9):.2f}x"))
        del flats, sub
        if clusters is not None:
            clusters.append(shadow)
        else:
            shadow.shutdown()
            del shadow
    return rows


if __name__ == "__main__":
    run(device=cli_device())
