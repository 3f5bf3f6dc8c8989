"""Readings that set a cell's limits, on the card at the cell's own size.
The benchmark's runs do not run this.

    python3 bench/control.py --workload gpt2-1.5b.checkmate \
        --program-seeds 11,12,13 --control-seeds 21,22,23

For each program seed: one run of the cell through the harness with a
window of one iteration (the compared numbers depend only on the first
three steps), its compared numbers. For each control seed: the
reference in f32, then the control (the reference with every matrix
product in float8) and two faults (the reference put in the program's
place: its loss and gradients over half of the rows; its state returned
unchanged from every step), each compared with the f32 reference as a
run of the program is. One JSON line
each; the process runs them one after the other on one card.
"""
import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    # the package from the root, and not this script's folder, whose
    # modules would shadow others of the same name (``trace``)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    from bench import compare, harness, spec
    from bench.reference.model import train_reference
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 1
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.program_seeds.split(",") if s]
    for seed in seeds:
        out = harness.run_cell(cell, seed, 0.0, False)
        print(json.dumps({"kind": "program", "seed": seed,
                          "correct": out["correct"],
                          "numbers": {k: c["value"] for k, c in
                                      out["checks"].items()}}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    model, traffic = cell.config["model"], cell.traffic
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        ref = train_reference(model, traffic, seed, "cuda")
        for kind, kw in (("fp8", {"precision": "fp8"}),
                         ("half_batch", {"rows": "half"}),
                         ("unchanged", {"update": False})):
            got = train_reference(model, traffic, seed, "cuda", **kw)
            print(json.dumps({"kind": kind, "seed": seed,
                              "numbers": compare.numbers(got, ref)}),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
