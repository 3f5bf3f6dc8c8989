"""Time the port's kernels in several checkouts, in turns, on one card.

    python3 tools/kernel_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (for example
``git archive <commit> | tar -x -C build/old``). For each, in the order
given, a subprocess imports that checkout's ``chip_smoke.py``, builds its
kernels (phase 1), holds them against their plain versions (phase 2's
checks) and times them as phase 2 does (``time_kernels``: kernel, plain
version, bound and library call, at the main path's shapes and the extra
flash shapes). Prints one JSON line per run with the kernel ms and the
card's name and power limit. Two versions are compared only within one
call, run in turns (old, new, new, old). Needs one GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from repro_torch import configs
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
cs.phase_build()
errs = {"fused_adamw": cs.check_adamw(dev), "bucket_pack": cs.check_pack(dev),
        **cs.check_flash(dev)}
rows, extra, _ = cs.time_kernels(dev, configs.get("tinyllama-1.1b"), errs)
ms = {f"{r['name']}{r.get('shape', '')}": r["ms"] for r in rows}
ms.update({k: r["ms"] for k, r in extra.items()})
print("kernel_ab " + json.dumps({"root": sys.argv[1], "ms": ms,
                                 "card": cs.card_name_power()}), flush=True)
"""


def main(roots: list[str]) -> int:
    if not roots:
        print(__doc__)
        return 2
    for root in roots:
        root = os.path.abspath(root)
        out = subprocess.run([sys.executable, "-c", RUN, root],
                             capture_output=True, text=True, cwd=root)
        lines = [l for l in out.stdout.splitlines()
                 if l.startswith("kernel_ab ")]
        if out.returncode or not lines:
            print(out.stdout[-3000:] + out.stderr[-3000:], file=sys.stderr)
            return out.returncode or 1
        print(lines[-1].removeprefix("kernel_ab "), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
