"""Fig 6: throughput x checkpoint count per system across the paper's model
families (vision, GPT LMs, a LLaMA), the port of
``benchmarks/throughput.py``.

The paper's claims checked here (as ratios on this device):
  * Checkmate checkpoints EVERY iteration with ~zero stall;
  * per-iteration copy-persist systems stall (1.3-6.5x at per-iteration);
  * CheckFreq checkpoints 5-34.5x less frequently than Checkmate.

On the card (the default) each model runs at full width, cut to its
``CARD_MODELS`` depth, batch and sequence (vit-h-14 as its config builds
it, ``family="vlm"``: its 256 patches before the text), each system for
its ``CARD_STEPS``; the copy-persist systems only at ``CARD_COPY_PERSIST``.
On the CPU every model and system runs ``STEPS`` at the JAX module's
``bench_config`` sizes.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (bench_config, card_config,
                                           checkpointer_for, cli_device,
                                           csv_row, run_record)
from repro_torch.device import resolve
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_state

STEPS = 8
MODELS = [("vit-h-14", 8, 0), ("gpt2-1.5b", 4, 128), ("gpt3-xl", 4, 128),
          ("llama2-7b", 4, 128)]
# on the card: (arch, batch, seq, layers); the batch is 8 for every model,
# a multiple of each published config's microbatches. llama2-7b runs 1
# layer (its 1-layer state is 5.6 GB)
CARD_MODELS = [("vit-h-14", 8, 128, 2), ("gpt2-1.5b", 8, 2048, 2),
               ("gpt3-xl", 8, 2048, 2), ("llama2-7b", 8, 2048, 1)]
SYSTEMS = ("no_checkpoint", "checkmate", "async", "gemini", "checkfreq")
# steps per system on the card: no-checkpoint and Checkmate steps are
# short, so 8 give a median of 7; each copy-persist step copies the whole
# state through pageable host memory, so async and gemini run 3;
# CheckFreq checkpoints its first 3 (profiled) steps, then runs 3 at the
# interval it tuned
CARD_STEPS = {"no_checkpoint": 8, "checkmate": 8, "async": 3, "gemini": 3,
              "checkfreq": 6}
# the models the copy-persist systems run at on the card: the vision
# model's state is 0.66 GB, an LM's 4-6 GB, seconds a checkpoint (PERF.md
# §6, one H100 80GB HBM3 at 700 W), and Fig 2 (`stalls`) runs those
# systems at gpt3-xl's card cut
CARD_COPY_PERSIST = ("vit-h-14",)


def run(device=None, models=None, init_state=None,
        record: list | None = None) -> list[tuple]:
    """One row per (model, system). ``models`` overrides the model list
    as [(cfg, batch, seq)]; ``init_state(cfg, seed, device)`` makes each
    run's initial state (default `make_train_state`); ``record``, if
    given, receives each run's `common.run_record`."""
    device = resolve(device)
    card = models is None and device.type == "cuda"
    if card:
        models = [(card_config(a, layers), b, s)
                  for a, b, s, layers in CARD_MODELS]
    if models is None:
        models = [(bench_config(a), b, s or 128) for a, b, s in MODELS]
    opt = OptimizerConfig(lr=1e-3)
    rows = []
    for cfg, batch, seq in models:
        for name in SYSTEMS:
            steps = CARD_STEPS[name] if card else STEPS
            if card and name not in ("no_checkpoint", "checkmate") \
                    and cfg.name not in CARD_COPY_PERSIST:
                continue
            s0 = (init_state or make_train_state)(cfg, 0, device)
            ck = checkpointer_for(name, s0, opt, device)
            state, stats = train(cfg, steps=steps, batch=batch, seq=seq,
                                 opt=opt, checkpointer=ck, state=s0,
                                 device=device)
            del s0, state
            steady = stats.iter_times[1:] or stats.iter_times
            tput = len(steady) / (sum(steady) + sum(stats.stall_times[1:]))
            rows.append(csv_row(f"fig6.{cfg.name}.{name}",
                                1e6 / max(tput, 1e-9),
                                f"tput={tput:.2f}it/s "
                                f"ckpts={ck.n_checkpoints} "
                                f"stall={ck.stall_total * 1e3:.0f}ms"))
            if record is not None:
                record.append(run_record(name, cfg, batch, seq, stats, ck))
            if hasattr(ck, "shadow"):
                ck.shadow.shutdown()
    return rows


if __name__ == "__main__":
    run(device=cli_device())
