"""Packet/frame model for the gradient-replication data plane, the port's
copy of ``repro.net.packets``.

Frames carry: a 1-bit DSCP tag (§4.1), the per-channel shadow-stream
sequence number in a custom TCP option (§4.1.2), and the shadow node id the
switch uses to pick the mirror destination (§4.2.4).

For the event-driven fabric simulator (`repro_torch.net.simulator`) a frame
also records its DP group, a replica index (which of the ``replication_factor``
mirror copies it is), per-frame timestamps, and a coalescing count
``n_frames``: one ``Frame`` object may stand in for ``n_frames`` wire-level
MTU frames when simulating very large transfers, with all switch counters
scaled accordingly (byte totals and TX/RX ratios are exact either way).
"""
from __future__ import annotations

from dataclasses import dataclass, field

MTU = 4096                      # payload bytes per wire frame (jumbo-ish)


@dataclass(slots=True)
class Frame:
    """One simulated data-plane frame (or a coalesced run of them).

    Args:
        src: source training rank (global) or switch port id.
        dst: destination rank / shadow node id.
        payload_off: byte offset of this frame within its chunk.
        payload_len: payload bytes carried (``n_frames`` wire frames' worth).
        chunk: gradient chunk id (AllGather chunk index within the group).
        channel: collective channel id (per-channel shadow streams, §4.1.2).
        tcp_seq: sequence number of the original training-plane stream.
        tagged: DSCP replication bit (§4.1).
        shadow_seq: custom-TCP-option shadow-stream sequence (tagged only).
        shadow_node: shadow node id encoded for the switch (§4.2.4).
        mirrored: set on switch-replicated copies.
        dp_group: data-parallel group this frame's ring belongs to.
        replica: mirror copy index in ``range(replication_factor)``.
        n_frames: wire frames this object represents (counter weight).
        t_send: simulation time the frame first entered the fabric.
        t_arrive: simulation time of final delivery (-1 until delivered).
        retx: how many times this frame was retransmitted after loss.
        payload: optional real payload bytes (memoryview/bytes) attached by
            a frame-injection hook (`FabricSimulator(frame_tx_hook=...)`) so
            gradient channels can flow actual data through the fabric;
            mirrored copies share the same buffer (zero-copy replication).
    """
    src: int                    # training rank (or switch port)
    dst: int                    # destination rank / shadow node
    payload_off: int            # byte offset within the chunk
    payload_len: int
    chunk: int                  # gradient chunk id
    channel: int
    tcp_seq: int                # original stream sequence
    tagged: bool = False        # DSCP bit
    shadow_seq: int = -1        # custom TCP option (per-channel counter)
    shadow_node: int = -1       # encoded shadow node id
    mirrored: bool = False      # set on switch-replicated copies
    dp_group: int = 0
    replica: int = 0
    n_frames: int = 1
    t_send: float = -1.0
    t_arrive: float = -1.0
    retx: int = 0
    payload: object = None


def frames_for_chunk(src: int, dst: int, *, chunk: int, channel: int,
                     chunk_bytes: int, start_seq: int, tagged: bool,
                     shadow_seq0: int, shadow_node: int,
                     dp_group: int = 0,
                     quantum: int = 1) -> list[Frame]:
    """Segment one chunk transmission into MTU frames.

    Args:
        quantum: coalescing factor — emit one ``Frame`` per ``quantum`` MTU
            frames (``n_frames`` keeps exact wire-frame counts).  ``1``
            reproduces the wire exactly; large chunks can use a bigger
            quantum so event counts stay bounded.
    """
    frames = []
    off = 0
    seq = start_seq
    sseq = shadow_seq0
    step = MTU * max(quantum, 1)
    while off < chunk_bytes:
        ln = min(step, chunk_bytes - off)
        nf = (ln + MTU - 1) // MTU
        frames.append(Frame(src=src, dst=dst, payload_off=off, payload_len=ln,
                            chunk=chunk, channel=channel, tcp_seq=seq,
                            tagged=tagged,
                            shadow_seq=sseq if tagged else -1,
                            shadow_node=shadow_node if tagged else -1,
                            dp_group=dp_group, n_frames=nf))
        off += ln
        seq += ln
        sseq += ln
    return frames
