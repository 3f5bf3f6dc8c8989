"""End-to-end training CLI with a choice of checkpointer, the port of
``repro.launch.train``.

    python -m repro_torch.launch.train --reduced --device cpu --steps 6 \
        --batch 4 --seq 32 --checkpointer checkmate --fail-at 3,5
    python -m repro_torch.launch.train --steps 5 --batch 8 --seq 2048 \
        --checkpointer sync --fail-at 4            # full width, on the card
    python -m repro_torch.launch.train --reduced --device cpu \
        --channel packetized --topology rail-optimized --compress
    python -m repro_torch.launch.train --arch mamba2-2.7b --reduced \
        --device cpu --steps 4 --batch 4 --seq 32 --fail-at 3

``--arch`` takes any of the 15 architectures of ``repro_torch.configs``
(every family: dense, moe, ssm, hybrid, audio, vlm). Prints a JSON report
(the JAX CLI's keys, the same for every family) and the one-screen metrics
digest. The flags are the JAX CLI's (``--channel {inprocess,packetized}``,
``--topology`` and ``--mesh {smoke,single,multi}`` included), except:
``--device {cuda,cpu}`` is new (default ``cuda``; it raises without a
GPU), and so are ``--max-lag-steps`` (the async shadow's lag bound) and
``--layers`` (the architecture cut to that depth at its full width).
``--optimizer`` is ``adamw``, ``adam`` or ``sgd``; any other name raises.

``--mesh smoke`` (the default) is the one-rank run. ``single`` and
``multi`` train over the production mesh (`launch.mesh
.make_production_mesh`: 256 or 512 ranks, one process per rank, as
``torchrun`` starts them; each process joins the group ``torchrun``
describes) with ``ShardingRules(mesh, fsdp=cfg.fsdp)``, the data-parallel
path of ``train(rules=)``: global rank 0 hosts the checkpointer (any
``--checkpointer``: a copy-persist baseline reads the whole state
gathered from every rank's slices) and prints the report; the other
ranks print nothing. In a world of another size (one process) they raise the
mesh's ``ValueError``.

`run` does the work and returns the report with the run's objects;
`main` prints them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass

CHECKPOINTERS = ("checkmate", "none", "sync", "async", "torch_dcp", "gemini",
                 "checkfreq")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the architecture to this many layers")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw",
                    help="adamw | adam | sgd")
    ap.add_argument("--checkpointer", default="checkmate",
                    choices=CHECKPOINTERS)
    ap.add_argument("--freq", type=int, default=1)
    ap.add_argument("--channel", default="inprocess",
                    choices=["inprocess", "packetized"],
                    help="gradient delivery transport for checkmate "
                         "(packetized = buckets -> frames -> fabric)")
    ap.add_argument("--topology", default="rail-optimized",
                    choices=["rail-optimized", "leaf-spine", "single"],
                    help="fabric topology for --channel packetized")
    ap.add_argument("--shadow-nodes", type=int, default=2)
    ap.add_argument("--shadow-async", action="store_true")
    ap.add_argument("--max-lag-steps", type=int, default=None,
                    help="bound on an async shadow's lag, in steps")
    ap.add_argument("--fail-at", default="",
                    help="comma-separated steps to inject failures at")
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--mesh", default="smoke",
                    choices=["smoke", "single", "multi"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the run "
                         "(enables the tracing session)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the end-of-run metrics snapshot JSON")
    return ap.parse_args(argv)


@dataclass
class Run:
    """One CLI run: the printed report and what produced it."""
    report: dict                  # None on a rank other than global rank 0
    state: object                 # the trainer's final TrainState
    stats: object                 # train.loop.LoopStats
    checkpointer: object
    snapshot: dict                # the metrics registry snapshot


def build_checkpointer(args: argparse.Namespace, state0, opt, device):
    """The checkpointer ``args`` selects; Checkmate's shadow is bootstrapped
    from ``state0`` on ``device``."""
    from repro_torch.core.buckets import layout_for_tree
    from repro_torch.core.channel import (CompressedChannel,
                                          InProcessChannel, PacketizedChannel)
    from repro_torch.core.checkpoint import (
        AsyncCheckpointer, CheckFreqCheckpointer, CheckmateCheckpointer,
        GeminiLikeCheckpointer, NoCheckpointer, ShardedAsyncCheckpointer,
        SyncCheckpointer)
    from repro_torch.core.shadow import ShadowCluster

    if args.checkpointer != "checkmate":
        return {
            "none": NoCheckpointer,
            "sync": lambda: SyncCheckpointer(args.freq),
            "async": lambda: AsyncCheckpointer(args.freq),
            "torch_dcp": lambda: ShardedAsyncCheckpointer(args.freq),
            "gemini": lambda: GeminiLikeCheckpointer(args.freq),
            "checkfreq": CheckFreqCheckpointer,
        }[args.checkpointer]()
    shadow = ShadowCluster(layout_for_tree(state0.params), opt,
                           n_nodes=args.shadow_nodes,
                           async_mode=args.shadow_async, device=device,
                           max_lag_steps=args.max_lag_steps)
    shadow.bootstrap(state0.params, state0.mu, state0.nu, state0.step)
    if args.channel == "packetized":
        channel = PacketizedChannel(topology=args.topology,
                                    n_shadow_nodes=args.shadow_nodes)
    else:
        channel = InProcessChannel()
    if args.compress:
        channel = CompressedChannel(channel)
    return CheckmateCheckpointer(shadow, channel=channel)


def run(argv=None) -> Run:
    """Parse ``argv``, train with the chosen checkpointer, build the
    report. The Checkmate shadow is shut down (its state stays readable)."""
    args = parse_args(argv)
    import torch.distributed as dist

    from repro_torch import configs, obs
    from repro_torch.core.recovery import FailurePlan
    from repro_torch.device import resolve
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.mesh import join_world, make_production_mesh
    from repro_torch.obs.publish import collect_run
    from repro_torch.optim.functional import OptimizerConfig
    from repro_torch.optim.schedules import cosine_schedule
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_state

    device = resolve(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    rules = None
    if args.mesh != "smoke":
        join_world(device)
        rules = ShardingRules(make_production_mesh(
            multi_pod=args.mesh == "multi", device=device), fsdp=cfg.fsdp)
    host = rules is None or dist.get_rank() == 0
    opt = OptimizerConfig(name=args.optimizer, lr=args.lr)
    lr_fn = cosine_schedule(args.lr, warmup=5, total=args.steps)
    state0 = make_train_state(cfg, args.seed, device) if host else None
    ck = build_checkpointer(args, state0, opt, device) if host else None
    # held in a list that train() empties: at a recovery train() drops the
    # lost state, and no reference here may keep it alive on the card.
    # Over ranks each rank starts from its slices of the same initial
    # state (train() cuts them), and rank 0's shadow from the whole of it.
    init = [state0 if rules is None else None]
    del state0
    shadow = getattr(ck, "shadow", None)

    plan = FailurePlan(tuple(int(x) for x in args.fail_at.split(",") if x))
    # --trace-out/--metrics-out turn the run's instrumentation on; the
    # digest works either way (a fresh registry publishes from the
    # subsystems' native counters at the end of the run)
    session = (obs.enabled_session() if args.trace_out or args.metrics_out
               else None)
    ob = session.__enter__() if session is not None else None
    t0 = time.time()
    try:
        state, stats = train(cfg, steps=args.steps, batch=args.batch,
                             seq=args.seq, opt=opt, lr_fn=lr_fn,
                             checkpointer=ck, failure_plan=plan,
                             seed=args.seed, state=init.pop(),
                             device=device, rules=rules)
        wall = time.time() - t0
        if not host:
            return Run(report=None, state=state, stats=stats,
                       checkpointer=None, snapshot=None)
        reg = ob.metrics if ob is not None else obs.MetricsRegistry()
        snap = collect_run(reg, checkpointer=ck)
        if args.trace_out:
            ob.tracer.write(args.trace_out)
        if args.metrics_out:
            reg.write_json(args.metrics_out)
    finally:
        if session is not None:
            session.__exit__(None, None, None)

    report = {
        "arch": cfg.name, "steps": stats.steps,
        "final_loss": stats.losses[-1] if stats.losses else None,
        "throughput_it_s": round(stats.throughput, 3),
        "mean_iter_s": round(stats.mean_iter, 4),
        "checkpoints": ck.n_checkpoints,
        "stall_total_s": round(ck.stall_total, 4),
        "failures": stats.failures, "recoveries": stats.recoveries,
        "wall_s": round(wall, 2),
    }
    if shadow is not None:
        report["channel"] = ck.channel.name
        if ck.skipped_steps:
            report["gated_steps"] = ck.skipped_steps
        s = shadow.stats()
        report["shadow"] = {
            "nodes": args.shadow_nodes, "lag": s.lag,
            "mean_apply_s": round(s.mean_apply_s, 4),
            "max_queue_depth": s.max_queue_depth,
        }
        shadow.shutdown()
    return Run(report=report, state=state, stats=stats, checkpointer=ck,
               snapshot=snap)


def main(argv=None) -> dict:
    """Run the CLI on ``argv`` (default: the command line), print the
    JSON report and the digest, and return the report."""
    from repro_torch.obs.publish import render_digest
    r = run(argv)
    if r.report is None:             # a rank other than global rank 0
        return None
    print(json.dumps(r.report, indent=2))
    print(render_digest(r.snapshot, ck=r.checkpointer))
    return r.report


if __name__ == "__main__":
    main()
