"""Time phases of ``chip_smoke.py`` in several checkouts, in turns, on one card.

    python3 tools/phase_ab.py PHASES OLD NEW NEW OLD

``PHASES`` is a comma-separated list of ``kernels`` (phase 2: every
kernel checked against its plain version, then timed), ``ranks`` (phase
4b, which opens a one-rank NCCL world and closes it), ``dryrun`` (phase
4c), ``families`` (phase 8), ``serving`` (phase 9) and ``benchmarks``
(phase 10); each other argument is the root of a checkout of this
repository (for example ``git archive <commit> | tar -x -C build/old``).
For each root, in the order given, a subprocess imports that checkout's
``chip_smoke.py``, builds its kernels (phase 1) and runs the named phases
in the script's order, each with every check it holds there. Prints one
JSON line per run with each phase's seconds and the card's name and
power limit; a run whose checks fail prints the end of its output and
ends the call. Compare two versions only within one call, run in turns
(old, new, new, old): a phase that grows in the new checkout adds that
much to the whole script. Needs one GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from repro_torch import configs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cfg, dev = configs.get("tinyllama-1.1b"), torch.device("cuda")


def kernels():
    errs = {"fused_adamw": cs.check_adamw(dev),
            "bucket_pack": cs.check_pack(dev), **cs.check_flash(dev)}
    cs.time_kernels(dev, cfg, errs)


run = {"kernels": kernels, "ranks": lambda: cs.phase_ranks(cfg),
       "dryrun": lambda: cs.phase_dryrun(cfg),
       "families": cs.phase_families, "serving": cs.phase_serving,
       "benchmarks": cs.phase_benchmarks}
secs, t0 = {}, time.perf_counter()
cs.phase_build()
secs["build"] = time.perf_counter() - t0
for name in sys.argv[2].split(","):
    t0 = time.perf_counter()
    run[name]()
    secs[name] = time.perf_counter() - t0
print("phase_ab " + json.dumps({"root": sys.argv[1], "seconds": secs,
                                "card": cs.card_name_power()}), flush=True)
"""

ORDER = ("kernels", "ranks", "dryrun", "families", "serving", "benchmarks")


def main(argv: list[str]) -> int:
    if len(argv) < 2 or not set(argv[0].split(",")) <= set(ORDER):
        print(__doc__)
        return 2
    phases = ",".join(p for p in ORDER if p in argv[0].split(","))
    for root in argv[1:]:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", RUN, root, phases],
                             capture_output=True, text=True, cwd=root)
        lines = [l for l in out.stdout.splitlines()
                 if l.startswith("phase_ab ")]
        if out.returncode or not lines:
            print(out.stdout[-3000:] + out.stderr[-3000:], file=sys.stderr)
            return out.returncode or 1
        print(lines[-1].removeprefix("phase_ab "), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
