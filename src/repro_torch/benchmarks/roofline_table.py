"""Format the port's ``dryrun_results.json`` (`repro_torch.launch.dryrun`)
into the roofline CSV table, the twin of the root
``benchmarks/roofline_table.py``: the same columns and the same text for
the same file.

    python -m repro_torch.benchmarks.roofline_table [PATH] [single|multi]

The port's numbers are a model at the H100's data-sheet peaks, computed
on the CPU from the traced step, not a measurement. Where the records
say how a cell holds the ``model`` axis (``"model"``: ``tp`` for a
tensor-parallel step, every family's since the ssm, hybrid, audio and
vit families joined; ``replicated`` for a step that computes each layer
whole on every model rank, as earlier records hold), the table adds that as
its last column; a file without the key prints the reference's text.
"""
from __future__ import annotations

import json
import sys


def run(path="dryrun_results.json", mesh="single"):
    with open(path) as f:
        rows = [r for r in json.load(f) if r.get("mesh") == mesh]
    layout = any("model" in r for r in rows)
    tail = ",model" if layout else ""
    print(f"# §Roofline table ({mesh}-pod) — seconds per step")
    print("arch,shape,status,compute_s,memory_s,collective_s,bound,"
          "useful_flops_ratio,mfu_at_roofline,hbm_bytes_per_dev_GB" + tail)
    for r in rows:
        tail = f",{r.get('model', '')}" if layout else ""
        if r["status"] != "ok":
            print(f"{r['arch']},{r['shape']},{r['status']},,,,,,," + tail)
            continue
        hbm = r.get("bytes_per_device_hbm", 0) / 1e9
        print(f"{r['arch']},{r['shape']},ok,"
              f"{r['compute_s']:.3f},{r['memory_s']:.3f},"
              f"{r['collective_s']:.3f},{r['bound']},"
              f"{r['useful_flops_ratio']:.2f},{r['mfu_at_roofline']:.4f},"
              f"{hbm:.1f}" + tail)

if __name__ == "__main__":
    run(*sys.argv[1:])
