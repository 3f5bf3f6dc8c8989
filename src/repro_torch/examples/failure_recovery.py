"""Failure recovery (paper Fig 9): a run with injected failures, recovered
from the per-iteration shadow checkpoint, converges IDENTICALLY to an
uninterrupted run — bit for bit. The port of
``examples/failure_recovery.py``.

Failure injection goes through the chaos harness (`repro_torch.harness`):
a declarative Scenario drives train loop -> PacketizedChannel (buckets ->
frames -> fabric -> reassembly) -> shadow plane -> recovery, and the
invariant registry checks every step. The second failure is compounded:
the fabric loses step 11's capture mid-iteration (shadow-NIC cut), the
channel reports a gated delivery, and when training fails at step 12
recovery lands on the last FULLY captured step (10).

    python -m repro_torch.examples.failure_recovery [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.examples._cli import parser, require
from repro_torch.harness import (ChannelSpec, FabricFailure, FailureSchedule,
                                 Scenario, run_scenario)

SCENARIO = Scenario(
    name="failure-recovery-example", level="full",
    arch="llama3.2-3b", steps=16, batch=8, seq=64, seed=7,
    channel=ChannelSpec(kind="packetized", topology="rail-optimized",
                        n_dp_groups=2, ranks_per_group=4),
    schedule=FailureSchedule(
        train_fail_steps=(6, 12),
        fabric=(FabricFailure(step=11, kind="capture"),)))


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    device = resolve(args.device)
    result = run_scenario(SCENARIO, device=device)
    trace = result.trace
    stats, ck = trace.stats, trace.checkpointer

    same = all(torch.equal(trace.final["params"][k],
                           trace.ref_final["params"][k])
               for k in trace.ref_final["params"])
    print(f"run A losses: {[f'{l:.4f}' for l in trace.ref_losses[-4:]]}")
    print(f"run B losses: {[f'{l:.4f}' for l in stats.losses[-4:]]}")
    print(f"failures={stats.failures} recoveries={stats.recoveries} "
          f"recovered_at={stats.recovered_at} "
          f"gated_captures={ck.skipped_steps}")
    print(f"final states identical: {same}")
    print(f"invariants: "
          f"{'all passed' if result.passed else result.violations}")
    require(result.passed, f"invariants: {result.violations}")
    require(same, "the recovered run's final state is the uninterrupted "
                  "run's")
    require(stats.recoveries == 2, f"recoveries {stats.recoveries}")
    # fully-per-iteration recovery at 5; capture-gated recovery at 10
    require(stats.recovered_at == [5, 10],
            f"recovered at {stats.recovered_at}")
    require(ck.skipped_steps == [11], f"gated {ck.skipped_steps}")
    return {"arch": SCENARIO.arch, "batch": SCENARIO.batch,
            "seq": SCENARIO.seq,
            "steps_run": len(trace.ref_losses) + stats.steps,
            "ref_losses": trace.ref_losses, "losses": stats.losses,
            "failures": stats.failures, "recoveries": stats.recoveries,
            "recovered_at": stats.recovered_at,
            "gated_captures": ck.skipped_steps, "bit_identical": same,
            "passed": result.passed}


if __name__ == "__main__":
    main()
