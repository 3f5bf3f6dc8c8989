"""End-to-end driver at the ~100M-parameter scale: a GPT-class model
trained with Checkmate per-iteration checkpointing and a mid-run injected
failure, recovered from the shadow cluster; the port of
``examples/train_100m.py``.

    python -m repro_torch.examples.train_100m [--steps 120] [--device cpu]

(~112M params; on the card a step takes milliseconds, on a CPU seconds —
scale --steps to taste. For a full config use repro_torch.launch.train.)
"""
from __future__ import annotations

import json
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.recovery import FailurePlan
from repro_torch.core.shadow import ShadowCluster
from repro_torch.device import resolve
from repro_torch.examples._cli import parser, require
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_state

STEPS, BATCH, SEQ, FAIL_AT = 120, 4, 128, 60


def config():
    return replace(configs.get("gpt2-1.5b"),
                   name="gpt2-100m", num_layers=12, d_model=768,
                   num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
                   vocab_size=16384, microbatches=1, attn_q_chunk=128)


def main(argv=None, init_state=None) -> dict:
    """``init_state(cfg, seed, device)`` makes the initial state (default
    `make_train_state`)."""
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--fail-at", type=int, default=FAIL_AT)
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = config()
    n = cfg.param_count()
    print(f"model: {cfg.name} — {n / 1e6:.1f}M params")

    opt = OptimizerConfig(lr=3e-4, weight_decay=0.1)
    lr_fn = cosine_schedule(3e-4, warmup=10, total=args.steps)

    state0 = (init_state or make_train_state)(cfg, 0, device)
    shadow = ShadowCluster(layout_for_tree(state0.params), opt, n_nodes=2,
                           async_mode=True, device=device)
    shadow.bootstrap(state0.params, state0.mu, state0.nu, 0)

    t0 = time.time()
    state, stats = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        opt=opt, lr_fn=lr_fn, state=state0,
        checkpointer=CheckmateCheckpointer(shadow),
        failure_plan=FailurePlan((args.fail_at,)), device=device)
    wall = time.time() - t0

    ckpt = shadow.consolidate()
    s = shadow.stats()
    exact = all(torch.equal(state.params[k], ckpt["params"][k].to(device))
                for k in state.params)
    report = {
        "params_M": round(n / 1e6, 1),
        "steps": stats.steps,
        "loss_first": round(stats.losses[0], 3),
        "loss_last": round(float(np.mean(stats.losses[-5:])), 3),
        "steady_iter_s": round(stats.steady_iter, 4),
        "recoveries": stats.recoveries,
        "checkpoints": ckpt["step"],
        "shadow_mean_apply_s": round(s.mean_apply_s, 4),
        "shadow_keeps_up": s.mean_apply_s < stats.steady_iter,
        "shadow_bit_identical": exact,
        "wall_s": round(wall, 1),
    }
    print(json.dumps(report, indent=2))
    shadow.shutdown()
    require(exact, "the shadow's checkpoint is bitwise the trainer's state")
    require(stats.losses[-1] < stats.losses[0],
            f"loss {stats.losses[0]} -> {stats.losses[-1]} did not fall")
    return dict(report, arch=cfg.name, batch=args.batch, seq=args.seq,
                steps_run=stats.steps, losses=stats.losses,
                recovered_at=stats.recovered_at)


if __name__ == "__main__":
    main()
