"""``python -m repro_torch.obs`` — trace / summary / diff for a run, the port
of ``python -m repro.obs``.

Subcommands:

* ``trace``   — run a harness scenario (golden name or sampled seed) or a
  reduced training config under a fully-enabled observability session and
  write the Chrome/Perfetto trace_event JSON (plus, optionally, the
  metrics snapshot).
* ``summary`` — same run selection, but print the one-screen metrics
  digest and the stall-attribution report instead of a trace file.
* ``diff``    — compare two metrics snapshot JSONs metric by metric.

Examples::

    PYTHONPATH=src python -m repro_torch.obs trace \
        --scenario packetized-rail-clean --device cpu
    PYTHONPATH=src python -m repro_torch.obs trace --seed 7 --device cpu \
        --out seed7.trace.json
    PYTHONPATH=src python -m repro_torch.obs summary --train tinyllama-1.1b \
        --steps 5 --device cpu --channel packetized
    PYTHONPATH=src python -m repro_torch.obs trace --train tinyllama-1.1b \
        --manual-clock --out run.trace.json
    PYTHONPATH=src python -m repro_torch.obs diff before.json after.json

Every run is on the card unless ``--device cpu`` is given.
``--manual-clock`` swaps the host wall clock for a deterministic logical
clock, so a fixed scenario exports a byte-identical trace every run.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import obs
from repro_torch.obs.publish import collect_run, render_digest
from repro_torch.obs.stalls import format_stall_report


def _add_run_args(ap: argparse.ArgumentParser):
    sel = ap.add_mutually_exclusive_group(required=True)
    sel.add_argument("--scenario",
                     help="golden scenario name (repro_torch.harness.GOLDEN)")
    sel.add_argument("--seed", type=int,
                     help="sample a random scenario from one integer")
    sel.add_argument("--train", metavar="ARCH",
                     help="run a reduced training config "
                          "(repro_torch.configs)")
    ap.add_argument("--level", default="channel",
                    choices=["channel", "full"],
                    help="stack depth for --seed sampling")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--channel", default="inprocess",
                    choices=["inprocess", "packetized"],
                    help="gradient transport for --train")
    ap.add_argument("--shadow-nodes", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--manual-clock", action="store_true",
                    help="deterministic logical host clock (golden traces)")


def _run_scenario(args, ob):
    from repro_torch.harness import GOLDEN, run_scenario, sample_scenario

    if args.scenario is not None:
        if args.scenario not in GOLDEN:
            sys.exit(f"unknown scenario {args.scenario!r}; golden names:\n  "
                     + "\n  ".join(sorted(GOLDEN)))
        sc = GOLDEN[args.scenario]
    else:
        sc = sample_scenario(args.seed, level=args.level)
    result = run_scenario(sc, device=args.device)
    ck = result.trace.checkpointer
    collect_run(ob.metrics, checkpointer=ck, channel=result.trace.channel)
    return sc.name, ck, result


def _run_train(args, ob):
    from repro_torch import configs
    from repro_torch.core.buckets import layout_for_tree
    from repro_torch.core.channel import InProcessChannel, PacketizedChannel
    from repro_torch.core.checkpoint import CheckmateCheckpointer
    from repro_torch.core.shadow import ShadowCluster
    from repro_torch.device import resolve
    from repro_torch.optim.functional import OptimizerConfig
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_state

    device = resolve(args.device)
    cfg = configs.get(args.train).reduced()
    opt = OptimizerConfig(name="adamw", lr=1e-3)
    s0 = make_train_state(cfg, 0, device)
    shadow = ShadowCluster(layout_for_tree(s0.params), opt,
                           n_nodes=args.shadow_nodes, device=device)
    shadow.bootstrap(s0.params, s0.mu, s0.nu, 0)
    if args.channel == "packetized":
        channel = PacketizedChannel(n_shadow_nodes=args.shadow_nodes)
    else:
        channel = InProcessChannel()
    ck = CheckmateCheckpointer(shadow, channel=channel)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, opt=opt,
          lr_fn=lambda _: 1e-3, checkpointer=ck, seed=0, state=s0,
          device=device)
    collect_run(ob.metrics, checkpointer=ck)
    return f"train-{cfg.name}", ck, None


def _run(args, ob):
    if args.train is not None:
        return _run_train(args, ob)
    return _run_scenario(args, ob)


def cmd_trace(args) -> int:
    clock = obs.ManualClock(0.0) if args.manual_clock else None
    with obs.enabled_session(clock=clock) as ob:
        name, ck, _ = _run(args, ob)
        out = args.out or f"{name}.trace.json"
        ob.tracer.write(out)
        n = len(ob.tracer.events())
        if args.metrics_out:
            ob.metrics.write_json(args.metrics_out)
    print(f"{name}: {n} trace events -> {out}")
    if args.metrics_out:
        print(f"{name}: metrics snapshot -> {args.metrics_out}")
    return 0


def cmd_summary(args) -> int:
    clock = obs.ManualClock(0.0) if args.manual_clock else None
    with obs.enabled_session(clock=clock) as ob:
        name, ck, result = _run(args, ob)
        snap = ob.metrics.snapshot()
    print(f"== {name} ==")
    if result is not None:
        print(result.describe())
    print(render_digest(snap))
    if ck is not None:
        print(format_stall_report(ck))
    return 0


def cmd_diff(args) -> int:
    with open(args.before) as f:
        before = json.load(f)
    with open(args.after) as f:
        after = json.load(f)
    rows = obs.diff_snapshots(before, after)
    if not rows:
        print("no metric changed")
        return 0
    w = max(len(r["metric"]) for r in rows)
    for r in rows:
        labels = ",".join(f"{k}={v}" for k, v in sorted(r["labels"].items()))
        print(f"{r['metric']:<{w}} {{{labels}}} "
              f"{r['before']} -> {r['after']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("trace", help="run + export Chrome trace JSON")
    _add_run_args(t)
    t.add_argument("--out", help="trace path (default <name>.trace.json)")
    t.add_argument("--metrics-out", help="also write the metrics snapshot")
    t.set_defaults(fn=cmd_trace)

    s = sub.add_parser("summary", help="run + print the metrics digest")
    _add_run_args(s)
    s.set_defaults(fn=cmd_summary)

    d = sub.add_parser("diff", help="diff two metrics snapshot JSONs")
    d.add_argument("before")
    d.add_argument("after")
    d.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
