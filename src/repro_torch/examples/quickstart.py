"""Quickstart: train a small LM with Checkmate per-iteration checkpointing,
the port of ``examples/quickstart.py``.

Shows the three-plane wiring:
  training plane  -> the train step returns the gradients it applied,
  network plane   -> a PacketizedChannel packs buckets into MTU frames and
                     routes them through the simulated multicast fabric,
  shadow plane    -> shadow nodes replay the optimizer per iteration.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch import configs
from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.channel import PacketizedChannel
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.shadow import ShadowCluster
from repro_torch.device import resolve
from repro_torch.examples._cli import parser, require
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_state

STEPS, BATCH, SEQ = 20, 8, 64


def main(argv=None, init_state=None) -> dict:
    """``init_state(cfg, seed, device)`` makes the initial state (default
    `make_train_state`)."""
    args = parser(__doc__).parse_args(argv)
    device = resolve(args.device)
    cfg = configs.get("tinyllama-1.1b").reduced()   # tiny same-family config
    opt = OptimizerConfig(lr=1e-3)

    # Bootstrap the shadow cluster with the initial replica.
    state0 = (init_state or make_train_state)(cfg, 0, device)
    layout = layout_for_tree(state0.params)
    shadow = ShadowCluster(layout, opt, n_nodes=2, async_mode=True,
                           device=device)
    shadow.bootstrap(state0.params, state0.mu, state0.nu, 0)

    # Every gradient reaches the shadow plane through ONE channel: here the
    # full paper dataflow (buckets -> frames -> fabric -> reassembly).
    channel = PacketizedChannel(topology="rail-optimized",
                                n_dp_groups=2, ranks_per_group=4)
    state, stats = train(
        cfg, steps=STEPS, batch=BATCH, seq=SEQ, opt=opt,
        checkpointer=CheckmateCheckpointer(shadow, channel=channel),
        state=state0, device=device)

    ckpt = shadow.consolidate()
    s = shadow.stats()
    exact = all(torch.equal(state.params[k], ckpt["params"][k].to(device))
                for k in state.params)
    keeps_up = s.mean_apply_s < stats.mean_iter
    print(f"steps={stats.steps} loss {stats.losses[0]:.3f} -> "
          f"{stats.losses[-1]:.3f}")
    print(f"checkpoints (per-iteration): {ckpt['step']}")
    print(f"shadow lag={s.lag} mean_apply={s.mean_apply_s * 1e3:.1f}ms "
          f"(iter={stats.mean_iter * 1e3:.1f}ms) -> keeps up: {keeps_up}")
    print(f"shadow checkpoint bit-identical to training state: {exact}")
    shadow.shutdown()
    require(exact, "the shadow's checkpoint is bitwise the trainer's state")
    return {"arch": cfg.name, "steps": stats.steps, "steps_run": stats.steps,
            "batch": BATCH, "seq": SEQ, "losses": stats.losses,
            "checkpoints": ckpt["step"], "lag": s.lag,
            "keeps_up": keeps_up, "bit_identical": exact}


if __name__ == "__main__":
    main()
