"""Stall attribution: decompose every booked stall second by stage (the
port's copy of ``repro.obs.stalls``).

Checkpointers book stalls into an ordered per-stage ledger
(``BaseCheckpointer.stall_stages``) instead of one opaque float;
``stall_total`` is *defined* as the in-order sum of that ledger, so the
attribution here sums bit-exactly to the total by construction — no
float-reassociation slop.

Stage vocabulary (KNOWN_STAGES):

* ``send``              — synchronous time inside ``channel.send`` (pack +
                          hand-off; zero for the packetized path, which is
                          the paper's zero-overhead claim)
* ``quantize``          — gradient compression ahead of the wire
* ``inline-apply``      — trainer-thread shadow apply (sync ingest mode)
* ``apply-lag``         — trainer blocked on a bounded-lag shadow whose
                          backlog hit ``max_lag_steps`` (the only cost a
                          too-slow async applier may charge the trainer)
* ``resync``            — full-state re-replication after a desync
* ``consolidate-wait``  — waiting on shadow consolidation during recovery
* ``copy-persist``      — the copy-then-persist baselines' whole stall
* ``elastic-reshard``   — rebuilding channel + shadow plane onto a
                          reconfigured mesh after an elastic shrink
"""
from __future__ import annotations

KNOWN_STAGES = ("send", "quantize", "inline-apply", "apply-lag", "resync",
                "consolidate-wait", "copy-persist", "elastic-reshard")


def stall_attribution(ck) -> dict:
    """Per-stage stall seconds for one checkpointer, in booking order."""
    return dict(getattr(ck, "stall_stages", {}) or {})


def format_stall_report(ck, title: str = "stall attribution") -> str:
    """One-screen table: stage | seconds | share of total."""
    stages = stall_attribution(ck)
    total = getattr(ck, "stall_total", 0.0)
    lines = [f"{title}  (total {total:.6f}s over "
             f"{getattr(ck, 'n_checkpoints', 0)} checkpoints)"]
    if not stages:
        lines.append("  (no stalls booked)")
        return "\n".join(lines)
    width = max(len(s) for s in stages)
    for stage, sec in stages.items():
        pct = 100.0 * sec / total if total else 0.0
        lines.append(f"  {stage:<{width}}  {sec:12.6f}s  {pct:6.2f}%")
    return "\n".join(lines)


def publish_stalls(reg, ck, labels=None) -> None:
    """Mirror one checkpointer's stall ledger into the registry.

    Call once per run (counters are cumulative; re-publishing would
    double-book)."""
    labels = labels or {}
    c = reg.counter("checkpoint_stall_seconds_total",
                    "Booked stall seconds by stage")
    for stage, sec in stall_attribution(ck).items():
        c.inc(sec, stage=stage, **labels)
