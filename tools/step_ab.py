"""Time one family's train step in several checkouts, in turns, on one card.

    python3 tools/step_ab.py LABEL OLD NEW NEW OLD

``LABEL`` is a run of ``chip_smoke.py``'s phase 8 (``FAMILY_CELLS``:
granite, arctic, mamba2, ...) or ``fsdp``; each other argument is the
root of a checkout of this repository (for example ``git archive
<commit> | tar -x -C build/old``). For each, in the order given, a
subprocess imports that checkout's ``chip_smoke.py``, builds its kernels
(phase 1) and times a train step: for a family, the one-rank step at
phase 8's cut (``family_cfg``; batch 4 in 2 microbatches, bf16, seed 0,
no shadow); for ``fsdp``, rank 0's local step of arctic at phase 8's
width, 4 layers, with FSDP on a fake (4, 1) ("data", "model") world
(global batch 8 x 2048 in 2 microbatches: phase 4c's FSDP yardstick,
whose collectives move nothing), so that a checkout's FSDP schedule
shows in the peak. Two warm-up steps, then ``STEPS`` timed ones, each
ending in a sync. Prints one JSON line per run with the steps' ms, their
median, the peak bytes allocated over the timed steps above what was
allocated before the state was made (where a step ran out of device
memory, the peak it reached and the allocator's message), and the card's
name and power limit. Two versions are compared only within one call, run in turns
(old, new, new, old). Needs one GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

STEPS = 10

RUN = """
import contextlib, dataclasses, json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.optim.functional import OptimizerConfig
from repro_torch.train.step import build_train_step, make_train_state
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_build()
label, steps = sys.argv[2], int(sys.argv[3])
rules, world = None, contextlib.nullcontext()
if label == "fsdp":
    from repro_torch.dist.sharding import Mesh, ShardingRules
    from repro_torch.launch.mesh import fake_world
    cfg = dataclasses.replace(cs.family_cfg("arctic"), num_layers=4,
                              fsdp=True)
    size, seq, world = 8, cs.FAMILY_CELLS["arctic"][2], fake_world(4)
else:
    cfg = cs.family_cfg(label)
    size, seq = cs.FAMILY_BATCH, cs.FAMILY_CELLS[label][2]
with world:
    if label == "fsdp":
        rules = ShardingRules(Mesh.over_ranks((4, 1), ("data", "model")),
                              fsdp=True)
    base = torch.cuda.memory_allocated()
    state = make_train_state(cfg, 0, "cuda", rules)
    batch = device_batch(SyntheticStream(cfg, size, seq, seed=0)
                         .batch_at(0), "cuda", rules, cfg.microbatches)
    step = build_train_step(cfg, OptimizerConfig(), lambda s: 1e-3, rules)
    times, oom = [], None
    try:
        for i in range(2 + steps):
            if i == 2:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del out
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    peak = torch.cuda.max_memory_allocated() - base
print("step_ab " + json.dumps({"root": sys.argv[1], "label": label,
                               "ms": times[2:],
                               "median_ms": (statistics.median(times[2:])
                                             if times[2:] else None),
                               "peak_bytes": peak, "out_of_memory": oom,
                               "card": cs.card_name_power()}), flush=True)
"""


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__)
        return 2
    label, roots = argv[0], argv[1:]
    for root in roots:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", RUN, root, label,
                              str(STEPS)],
                             capture_output=True, text=True, cwd=root)
        lines = [l for l in out.stdout.splitlines()
                 if l.startswith("step_ab ")]
        if out.returncode or not lines:
            print(out.stdout[-3000:] + out.stderr[-3000:], file=sys.stderr)
            return out.returncode or 1
        print(lines[-1].removeprefix("step_ab "), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
