"""Fig 2: iteration time and checkpoint stall per system when checkpointing
EVERY iteration, the port of ``benchmarks/stalls.py``.

Paper claims to reproduce (relative): sync stalls worst (9.5x there);
async still stalls (same volume); sharding reduces it; Checkmate ~
no-ckpt. On the card (the default) the model is gpt3-xl at full width
(d_model 2048, 16 heads, d_ff 8192, vocab 50257), cut to ``CARD['layers']``
of its 24 layers, at batch 8 x seq 2048 for ``CARD['steps']`` steps; on
the CPU it is the JAX module's ``bench_config`` model and sizes.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (bench_config, card_config,
                                           checkpointer_for, cli_device,
                                           csv_row, run_record)
from repro_torch.device import resolve
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_state

STEPS, BATCH, SEQ = 6, 8, 128
CARD = dict(layers=2, steps=4, batch=8, seq=2048)
SYSTEMS = ("no_checkpoint", "checkmate", "sync", "async", "torch_dcp",
           "gemini")


def run(device=None, cfg=None, init_state=None,
        record: list | None = None) -> list[tuple]:
    """One row per system. ``init_state(cfg, seed, device)`` makes each
    run's initial state (default `make_train_state`); ``record``, if
    given, receives each run's `common.run_record`."""
    device = resolve(device)
    steps, batch, seq = STEPS, BATCH, SEQ
    if device.type == "cuda":
        steps, batch, seq = CARD["steps"], CARD["batch"], CARD["seq"]
        cfg = cfg or card_config("gpt3-xl", CARD["layers"])
    cfg = cfg or bench_config("gpt3-xl")
    opt = OptimizerConfig(lr=1e-3)
    rows, base_iter = [], None
    for name in SYSTEMS:
        s0 = (init_state or make_train_state)(cfg, 0, device)
        ck = checkpointer_for(name, s0, opt, device)
        state, stats = train(cfg, steps=steps, batch=batch, seq=seq,
                             opt=opt, checkpointer=ck, state=s0,
                             device=device)
        del s0, state
        it = stats.steady_iter
        stall = ck.stall_total / max(ck.n_checkpoints, 1)
        if name == "no_checkpoint":
            base_iter = it
        slowdown = (it + stall) / base_iter
        rows.append(csv_row(f"fig2.{name}", (it + stall) * 1e6,
                            f"iter={it * 1e3:.0f}ms "
                            f"stall={stall * 1e3:.0f}ms "
                            f"slowdown={slowdown:.2f}x"))
        if record is not None:
            record.append(run_record(name, cfg, batch, seq, stats, ck))
        if hasattr(ck, "shadow"):
            ck.shadow.shutdown()
    return rows


if __name__ == "__main__":
    run(device=cli_device())
