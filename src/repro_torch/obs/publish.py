"""Publish subsystem state into a `MetricsRegistry`, and render a digest —
the port's copy of ``repro.obs.publish``.

The instrumented hot paths update cheap native counters in place
(`FabricTotals`, `ShadowNode` apply stats, checkpointer stall ledgers);
these publishers mirror that state into labeled registry metrics *once per
run* so every number ends up behind a single exposition surface.
Duck-typed on attribute presence, so any channel/checkpointer/shadow
combination (or a bare subset) publishes cleanly.
"""
from __future__ import annotations

from repro_torch.obs.stalls import format_stall_report, publish_stalls


def _unwrap_channels(channel):
    """The channel plus its ``.inner`` chain (Compressed->Packetized etc.)."""
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
    """Wire/fabric accounting for a channel stack (outermost first), from
    the native ``totals`` of a channel that keeps them."""
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
        frames = reg.counter("fabric_frames_total",
                             "Frames by lifecycle stage")
        for kind in ("tx", "rx", "mirrored"):
            frames.inc(getattr(totals, f"frames_{kind}"), kind=kind)
        loss = reg.counter("fabric_loss_events_total",
                           "Loss/recovery events in the fabric")
        for kind in ("drops", "retransmits", "rerouted", "mirror_lost"):
            loss.inc(getattr(totals, kind), kind=kind)
        reg.counter("fabric_pfc_pauses_total", "PFC pause frames").inc(
            totals.pfc_pauses)
        reg.counter("fabric_pfc_resumes_total", "PFC resume frames").inc(
            totals.pfc_resumes)
        reg.counter("fabric_pfc_pause_seconds_total",
                    "Aggregate link-paused virtual time").inc(
            totals.pfc_pause_s)
        reg.counter("fabric_time_seconds_total",
                    "Simulated fabric time consumed").inc(
            totals.fabric_time_s)
        pause_g = reg.gauge("fabric_link_pfc_pause_seconds",
                            "Paused virtual time per link")
        pauses_c = reg.counter("fabric_link_pfc_pauses_total",
                               "Pause frames per link")
        for link, st in sorted(totals.link_pfc.items()):
            pause_g.set(st.get("pause_s", 0.0), link=link)
            pauses_c.inc(st.get("pauses", 0), link=link)


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
    frames = {k: _val(snapshot, "fabric_frames_total", kind=k)
              for k in ("tx", "rx", "mirrored")}
    if any(v is not None for v in frames.values()):
        lines.append("  {:<26} tx={} rx={} mirrored={}".format(
            "frames", *(frames[k] or 0 for k in ("tx", "rx", "mirrored"))))
    wire = snapshot.get("metrics", {}).get("channel_wire_bytes_total")
    if wire and wire["samples"]:
        row("bytes on wire", sum(s["value"] for s in wire["samples"]))
    row("fabric time", _val(snapshot, "fabric_time_seconds_total"),
        "{:.6f}s")
    row("pfc pause time",
        _val(snapshot, "fabric_pfc_pause_seconds_total"), "{:.6f}s")
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
