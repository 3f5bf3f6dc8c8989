"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 bench/run.py --workload gpt2-1.5b.checkmate --seed 7 \
        --seconds 30 --trace 0

Loads the cell from ``BENCHMARK.json``, sets up, measures for
``--seconds``, checks the run against the plain reference, and prints one
JSON line as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the compared numbers and their limits come last, under
``checks``, and again as the last lines of standard error. Exits with 1
and prints no result without enough CUDA devices, or where JAX or the
JAX package is loaded once the run is over.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def caches(root: str):
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port's own kernels build into ``build/repro_torch`` there."""
    base = os.path.join(root, "build", "bench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse_args(argv)
    caches(ROOT)
    # the package from the root, and not this script's folder, whose
    # modules would shadow others of the same name (``trace``)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
        p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch
    from bench import harness, spec
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 1
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"bench: loaded in this process: {bad}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check correct {out['correct']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
