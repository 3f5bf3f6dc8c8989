"""Chaos harness CLI, the port of ``python -m repro.harness``.

    python -m repro_torch.harness run --corpus golden [--bundle-dir DIR]
    python -m repro_torch.harness run --scenario gated-then-recovery
    python -m repro_torch.harness run --seed 1234 [--level channel|full]
    python -m repro_torch.harness sweep --n 8 [--seed BASE] [--bundle-dir DIR]
    python -m repro_torch.harness replay --seed 1234
    python -m repro_torch.harness replay --bundle chaos-bundles/foo.json

Every subcommand runs on the card unless ``--device cpu`` is given.

``run`` / ``sweep`` exit nonzero if any invariant is violated, writing a
minimal repro bundle per violating scenario when --bundle-dir is given.
``replay`` re-runs a bundle (or a sampled seed, twice) and exits zero iff
the outcome reproduces bit-identically — which is what makes every CI
chaos failure a one-integer local repro.

``--time-budget PATH`` additionally times every scenario and fails the
run if the total wall clock exceeds ``tolerance`` x the committed
baseline (``benchmarks/golden_budget.json``) — the guard that keeps the
golden corpus from quietly doubling as scenarios accrete. The baseline
file is the JAX package's, timed on a CPU: on the port it is a yardstick
with the same arithmetic, not a measurement of this package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.harness.corpus import GOLDEN
from repro_torch.harness.runner import replay_bundle, run_scenario
from repro_torch.harness.scenario import repro_seed, sample_scenario


def _check_time_budget(timings: dict, budget_path: str) -> int:
    """Compare measured wall clock against the committed baseline.

    The budget file maps scenario name -> baseline seconds plus a
    ``tolerance`` multiplier; the check fails only on the TOTAL (single
    scenarios jitter on shared CI runners), but prints any scenario
    individually past tolerance so the offender is named. Scenarios
    without a committed baseline are reported and excluded — add them to
    the budget file when they land.
    """
    with open(budget_path) as f:
        budget = json.load(f)
    tol = float(budget.get("tolerance", 2.0))
    baselines = budget["scenarios"]
    unbudgeted = sorted(set(timings) - set(baselines))
    if unbudgeted:
        print(f"# time-budget: no baseline for {', '.join(unbudgeted)} "
              f"(excluded — add to {budget_path})")
    covered = {n: t for n, t in timings.items() if n in baselines}
    for name, t in sorted(covered.items()):
        if t > tol * baselines[name]:
            print(f"# time-budget: {name} took {t:.1f}s "
                  f"(baseline {baselines[name]:.1f}s, x{tol:g} allowed)")
    total = sum(covered.values())
    allowed = tol * sum(baselines[n] for n in covered)
    verdict = "OK" if total <= allowed else "EXCEEDED"
    print(f"# time-budget: total {total:.1f}s / allowed {allowed:.1f}s "
          f"({len(covered)} budgeted scenario(s)) -> {verdict}")
    return 0 if total <= allowed else 1


def _run_many(scenarios, bundle_dir, device, budget_path=None) -> int:
    """Run each scenario; one the port cannot run yet (`run_scenario`
    raises NotImplementedError) is named as REFUSED and counts as not
    passed, so the exit code says the corpus did not all run."""
    failed = refused = 0
    timings: dict = {}
    for sc in scenarios:
        t0 = time.monotonic()
        try:
            result = run_scenario(sc, bundle_dir=bundle_dir, device=device)
        except NotImplementedError as e:
            refused += 1
            print(f"{'REFUSED':<8} {sc.name:<34} {sc.level:<7} {e}")
            continue
        timings[sc.name] = time.monotonic() - t0
        print(f"{result.describe()}  [{timings[sc.name]:.1f}s]")
        if not result.passed:
            failed += 1
            if result.bundle_path:
                print(f"         repro bundle -> {result.bundle_path}")
    n = len(scenarios)
    print(f"# {n - failed - refused}/{n} scenarios passed"
          + (f", {failed} FAILED" if failed else "")
          + (f", {refused} REFUSED (not ported)" if refused else ""))
    over = _check_time_budget(timings, budget_path) if budget_path else 0
    return 1 if (failed or refused or over) else 0


def _cmd_run(args) -> int:
    if args.scenario:
        if args.scenario not in GOLDEN:
            print(f"run: unknown scenario {args.scenario!r}; golden "
                  f"scenarios: {', '.join(sorted(GOLDEN))}", file=sys.stderr)
            return 2
        scenarios = [GOLDEN[args.scenario]]
    elif args.corpus:
        scenarios = list(GOLDEN.values())
    elif args.seed is not None:
        scenarios = [sample_scenario(args.seed, level=args.level)]
    else:
        print("run: pass --corpus golden, --scenario NAME, or --seed N",
              file=sys.stderr)
        return 2
    return _run_many(scenarios, args.bundle_dir, args.device,
                     budget_path=args.time_budget)


def _cmd_sweep(args) -> int:
    base = repro_seed() if args.seed is None else args.seed
    print(f"# sweep: {args.n} scenarios from base seed {base} "
          f"(replay any with: python -m repro_torch.harness replay --seed S"
          + (f" --level {args.level}" if args.level else "") + ")")
    scenarios = [sample_scenario(base + i, level=args.level)
                 for i in range(args.n)]
    return _run_many(scenarios, args.bundle_dir, args.device)


def _cmd_replay(args) -> int:
    if args.bundle:
        result, identical = replay_bundle(args.bundle, device=args.device)
        print(result.describe())
        verdict = ("reproduced bit-identically" if identical
                   else "DID NOT reproduce")
        print(f"# bundle {verdict}: {args.bundle}")
        return 0 if identical else 1
    if args.seed is None:
        print("replay: pass --bundle PATH or --seed N", file=sys.stderr)
        return 2
    sc = sample_scenario(args.seed, level=args.level)
    a = run_scenario(sc, device=args.device).bundle()
    b = run_scenario(sample_scenario(args.seed, level=args.level),
                     device=args.device).bundle()
    identical = a == b
    print(f"seed {args.seed} -> {sc.name}: "
          f"{len(a['violations'])} violation(s), replay "
          f"{'bit-identical' if identical else 'DIVERGED'}")
    return 0 if identical else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.harness",
        description="Deterministic chaos co-simulation harness "
                    "(the port of repro.harness)")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run golden corpus / named / sampled "
                                     "scenarios")
    run.add_argument("--corpus", choices=["golden"])
    run.add_argument("--scenario", help="golden scenario name")
    run.add_argument("--seed", type=int,
                     help="sample one random scenario from this seed")
    run.add_argument("--level", choices=["channel", "full"])
    run.add_argument("--bundle-dir",
                     help="write violation repro bundles here")
    run.add_argument("--time-budget", metavar="PATH",
                     help="committed wall-clock baseline JSON "
                          "(benchmarks/golden_budget.json); fail if the "
                          "total exceeds tolerance x baseline")
    run.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    run.set_defaults(fn=_cmd_run)

    sweep = sub.add_parser("sweep", help="run N seeded random scenarios")
    sweep.add_argument("--n", type=int, default=8)
    sweep.add_argument("--seed", type=int,
                       help="base seed (default: REPRO_SEED env var or 0)")
    sweep.add_argument("--level", choices=["channel", "full"])
    sweep.add_argument("--bundle-dir")
    sweep.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sweep.set_defaults(fn=_cmd_sweep)

    rep = sub.add_parser("replay", help="re-run a violation bundle or a "
                                        "sampled seed bit-identically")
    rep.add_argument("--bundle", help="path to a repro bundle JSON")
    rep.add_argument("--seed", type=int)
    rep.add_argument("--level", choices=["channel", "full"])
    rep.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rep.set_defaults(fn=_cmd_replay)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
