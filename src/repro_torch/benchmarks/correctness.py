"""Fig 9: training recovered from the shadow converges identically to an
uninterrupted run (the loss curves overlap; the states are bit-equal), the
port of ``benchmarks/correctness.py``.

On the card (the default) the model is vit-h-14 at full width as its
config builds it (``family="vlm"``), cut to ``CARD_LAYERS`` layers; on the
CPU the JAX module's ``bench_config`` model. Both runs start from one
seed's state; the checkpointed one fails at steps 3, 5 and 8 and recovers
from a 2-node shadow each time.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import (bench_config, card_config,
                                           cli_device, csv_row)
from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.recovery import FailurePlan
from repro_torch.core.shadow import ShadowCluster
from repro_torch.device import resolve
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_state

STEPS, BATCH, SEQ, SEED = 10, 8, 64, 11
FAILURES = (3, 5, 8)
CARD_LAYERS = 2


def default_config(device):
    if device.type == "cuda":
        return card_config("vit-h-14", CARD_LAYERS)
    return bench_config("vit-h-14")       # the paper uses a vision model


def run(device=None, cfg=None, init_state=None, record: dict | None = None
        ) -> list[tuple]:
    """The three Fig 9 rows. ``init_state(cfg, seed, device)`` makes both
    runs' initial state (default `make_train_state`); ``record``, if
    given, receives the losses, recoveries, steps run and the verdict."""
    device = resolve(device)
    cfg = cfg or default_config(device)
    make = init_state or make_train_state
    opt = OptimizerConfig(lr=1e-3)

    state_a, stats_a = train(cfg, steps=STEPS, batch=BATCH, seq=SEQ,
                             opt=opt, seed=SEED, device=device,
                             state=make(cfg, SEED, device))
    s0 = make(cfg, SEED, device)
    shadow = ShadowCluster(layout_for_tree(s0.params), opt, n_nodes=2,
                           device=device)
    shadow.bootstrap(s0.params, s0.mu, s0.nu, 0)
    state_b, stats_b = train(cfg, steps=STEPS, batch=BATCH, seq=SEQ,
                             opt=opt, seed=SEED, state=s0, device=device,
                             checkpointer=CheckmateCheckpointer(shadow),
                             failure_plan=FailurePlan(FAILURES))
    shadow.shutdown()

    max_loss_diff = max(abs(a - b)
                        for a, b in zip(stats_a.losses, stats_b.losses))
    identical = all(torch.equal(state_a.params[k], state_b.params[k])
                    for k in state_a.params)
    if record is not None:
        record.update(arch=cfg.name, family=cfg.family,
                      layers=cfg.num_layers, microbatches=cfg.microbatches,
                      batch=BATCH, seq=SEQ,
                      losses_a=stats_a.losses, losses_b=stats_b.losses,
                      steps_run=stats_a.steps + stats_b.steps,
                      recoveries=stats_b.recoveries,
                      recovered_at=stats_b.recovered_at,
                      states_bit_identical=identical)
    return [csv_row("fig9.loss_curve_max_diff", 0.0, f"{max_loss_diff:.2e}"),
            csv_row("fig9.recoveries", 0.0, f"{stats_b.recoveries}"),
            csv_row("fig9.states_bit_identical", 0.0, str(identical))]


if __name__ == "__main__":
    run(device=cli_device())
