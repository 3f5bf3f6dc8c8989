"""Fabric failure drills through the chaos harness, ending in a recovery
that is bit-identical to an uninterrupted run (paper §4 + Fig 9); the port
of ``examples/fabric_failures.py``.

    python -m repro_torch.examples.fabric_failures [--device cpu]

All failure injection rides the harness API — declarative Scenarios whose
`FabricFailure`s reach the event-driven simulator through the
PacketizedChannel, with the invariant registry checking every step:

  1. spine kill     -> ECMP reroutes; ring and capture both complete.
  2. uplink cut     -> same, at smaller blast radius.
  3. shadow NIC cut -> training unaffected, but that iteration's capture
     is incomplete; the channel surfaces it as a gated delivery and the
     shadow cluster skips the apply (contiguity preserved).
  4. gated capture + training failure (full stack): recovery consolidates
     one step earlier and the resumed run converges bit-identically.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.examples._cli import parser, require
from repro_torch.harness import (ChannelSpec, FabricFailure, FailureSchedule,
                                 Scenario, run_scenario)

RAIL = ChannelSpec(kind="packetized", topology="rail-optimized",
                   n_dp_groups=2, ranks_per_group=4)
DRILLS = {
    "spine kill": FabricFailure(step=2, kind="switch", target="spine0"),
    "uplink cut": FabricFailure(step=2, kind="link",
                                target=("leaf0", "spine0")),
    "shadow cut": FabricFailure(step=2, kind="capture"),
}
# the capture of iteration LOST is lost on every shadow NIC, and training
# fails at LOST + 1
LOST = 4
RECOVERY = Scenario(
    name="fabric-gated-recovery-example", level="full",
    arch="tinyllama-1.1b", steps=8, batch=2, seq=16, seed=5,
    channel=RAIL,
    schedule=FailureSchedule(
        train_fail_steps=(LOST + 1,),
        fabric=(FabricFailure(step=LOST, kind="capture"),)))


def fabric_of(result, step):
    """The FabricResult of ``step``'s delivery (channel-level runs poll
    one delivery per step)."""
    for rec in result.trace.records:
        for p in rec.polls:
            if p.step == step:
                return p.fabric
    raise KeyError(step)


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    device = resolve(args.device)
    drills = {}
    for label, failure in DRILLS.items():
        sc = Scenario(name=f"drill-{label.replace(' ', '-')}", seed=5,
                      steps=3, channel=RAIL,
                      schedule=FailureSchedule(fabric=(failure,)))
        result = run_scenario(sc, device=device)
        f = fabric_of(result, 2)
        print(f"{label:<12}: ok={result.passed} ring_ok={f.ring_completed} "
              f"capture_ok={f.reassembled_ok} rerouted={f.rerouted} "
              f"retx={f.retransmits} missing={f.missing_captures}")
        require(result.passed, f"{label}: {result.violations}")
        # training traffic never stalls
        require(f.ring_completed, f"{label}: the ring did not complete")
        drills[label] = {"passed": result.passed,
                         "ring_completed": f.ring_completed,
                         "reassembled_ok": f.reassembled_ok,
                         "rerouted": f.rerouted,
                         "retransmits": f.retransmits,
                         "missing_captures": f.missing_captures}

    # couple the capture loss to training: its delivery is gated and the
    # shadow apply skipped; the training failure at LOST+1 then recovers
    # from LOST-1, bit-identically to the reference run the harness
    # executes alongside
    result = run_scenario(RECOVERY, device=device)
    trace = result.trace
    same = all(torch.equal(trace.final["params"][k],
                           trace.ref_final["params"][k])
               for k in trace.ref_final["params"])
    print(f"recovery    : recovered_at={trace.stats.recovered_at} "
          f"gated={trace.checkpointer.skipped_steps} bit_identical={same}")
    require(result.passed, f"recovery: {result.violations}")
    require(same and trace.stats.recovered_at == [LOST - 1],
            f"recovered at {trace.stats.recovered_at}, bit-identical "
            f"{same}")
    require(trace.checkpointer.skipped_steps == [LOST],
            f"gated {trace.checkpointer.skipped_steps}")
    return {"drills": drills, "arch": RECOVERY.arch,
            "batch": RECOVERY.batch, "seq": RECOVERY.seq,
            "steps_run": len(trace.ref_losses) + trace.stats.steps,
            "recovered_at": trace.stats.recovered_at,
            "gated": trace.checkpointer.skipped_steps,
            "bit_identical": same, "passed": result.passed}


if __name__ == "__main__":
    main()
