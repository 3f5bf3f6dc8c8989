"""Publish subsystem state into a `MetricsRegistry`, and render a digest —
the port's copy of ``repro.obs.publish``.

The instrumented hot paths update cheap native counters in place
(`ShadowNode` apply stats, checkpointer stall ledgers); these publishers
mirror that state into labeled registry metrics *once per run* so every
number ends up behind a single exposition surface. Duck-typed on attribute
presence, so any channel/checkpointer/shadow combination (or a bare subset)
publishes cleanly.

The JAX package's fabric and PFC counters (frames, loss events, pause
time, fabric time) and their digest rows are left out until the fabric is
ported.
"""
from __future__ import annotations

from repro_torch.obs.stalls import format_stall_report, publish_stalls


def _unwrap_channels(channel):
    """The channel plus its ``.inner`` chain (Compressed->InProcess)."""
    out = []
    while channel is not None and channel not in out:
        out.append(channel)
        channel = getattr(channel, "inner", None)
    return out


def publish_checkpointer(reg, ck, labels=None) -> None:
    labels = labels or {}
    reg.counter("checkpoints_total", "Captures that completed").inc(
        getattr(ck, "n_checkpoints", 0), **labels)
    reg.counter("checkpoint_skipped_captures_total",
                "Captures gated off by injected failures").inc(
        getattr(ck, "skipped_captures", 0), **labels)
    resyncs = getattr(ck, "resyncs", 0)      # checkmate keeps a step list
    if hasattr(resyncs, "__len__"):
        resyncs = len(resyncs)
    reg.counter("checkpoint_resyncs_total",
                "Full-state re-replications after desync").inc(
        resyncs, **labels)
    publish_stalls(reg, ck, labels=labels)


def publish_shadow(reg, shadow) -> None:
    """Shadow-cluster apply stats (per node + aggregate gauges)."""
    stats = shadow.stats()
    reg.gauge("shadow_apply_mean_seconds",
              "Mean per-node shadow apply time").set(stats.mean_apply_s)
    reg.gauge("shadow_apply_max_seconds",
              "Max single shadow apply time").set(stats.max_apply_s)
    reg.gauge("shadow_lag_steps",
              "Trainer step minus slowest shadow step").set(stats.lag)
    reg.gauge("shadow_queue_depth",
              "Peak pending async-ingest deliveries").set(
        stats.max_queue_depth)
    applies = reg.counter("shadow_applies_total", "Fused optimizer applies")
    for node in getattr(shadow, "nodes", []):
        applies.inc(getattr(node, "apply_count", 0),
                    node=getattr(node, "node_id", "?"))


def publish_channel(reg, channel) -> None:
    """Send accounting for a channel stack (outermost first), from the
    native ``totals`` of a channel that keeps them."""
    for ch in _unwrap_channels(channel):
        name = getattr(ch, "name", type(ch).__name__)
        totals = getattr(ch, "totals", None)
        if totals is None:
            continue
        reg.counter("channel_sends_total", "Gradient sends").inc(
            totals.sends, channel=name)
        reg.counter("channel_gated_total",
                    "Sends gated off by capture failures").inc(
            totals.gated, channel=name)
        reg.counter("channel_wire_bytes_total",
                    "Bytes put on the wire (incl. replication)").inc(
            totals.wire_bytes, channel=name)


def collect_run(reg, checkpointer=None, shadow=None, channel=None) -> dict:
    """Publish everything present, then return the registry snapshot."""
    if checkpointer is not None:
        publish_checkpointer(reg, checkpointer)
        if channel is None:
            channel = getattr(checkpointer, "channel", None)
        if shadow is None:
            shadow = getattr(checkpointer, "shadow", None)
    if channel is not None:
        publish_channel(reg, channel)
    if shadow is not None:
        publish_shadow(reg, shadow)
    return reg.snapshot()


def _val(snap, name, **labels):
    fam = snap.get("metrics", {}).get(name)
    if not fam:
        return None
    want = {k: str(v) for k, v in labels.items()}
    for s in fam["samples"]:
        if s["labels"] == want:
            return s.get("value", s.get("sum"))
    return None


def render_digest(snapshot: dict, ck=None) -> str:
    """One-screen end-of-run metrics digest sourced from a registry
    snapshot (the ``launch.train`` / ``repro_torch.obs summary``
    epilogue)."""
    lines = ["== run digest =="]

    def row(label, value, fmt="{}"):
        if value is not None:
            lines.append(f"  {label:<26} " + fmt.format(value))

    row("checkpoints", _val(snapshot, "checkpoints_total"))
    row("skipped captures",
        _val(snapshot, "checkpoint_skipped_captures_total"))
    row("resyncs", _val(snapshot, "checkpoint_resyncs_total"))
    row("shadow apply mean/max",
        (_val(snapshot, "shadow_apply_mean_seconds"),
         _val(snapshot, "shadow_apply_max_seconds"))
        if _val(snapshot, "shadow_apply_mean_seconds") is not None else None,
        "{0[0]:.6f}s / {0[1]:.6f}s")
    wire = snapshot.get("metrics", {}).get("channel_wire_bytes_total")
    if wire and wire["samples"]:
        row("bytes on wire", sum(s["value"] for s in wire["samples"]))
    stall_fam = snapshot.get("metrics", {}).get(
        "checkpoint_stall_seconds_total")
    if stall_fam and stall_fam["samples"]:
        lines.append("  stall attribution:")
        for s in stall_fam["samples"]:
            stage = s["labels"].get("stage", "?")
            lines.append(f"    {stage:<22} {s['value']:.6f}s")
    if ck is not None:
        lines.append(format_stall_report(ck))
    return "\n".join(lines)
