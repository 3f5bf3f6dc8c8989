"""Switch data plane (paper §4.3.2): stateless match-action processing, the
port's copy of ``repro.net.switch``.

Ingress: untagged packets get normal L2 forwarding; tagged packets are
assigned a multicast group and replicated by the PRE. Egress (for mirrored
copies): rewrite the TCP sequence number to the shadow-stream counter from
the custom option, and rewrite src/dst for the shadow node's TCP stream.
ACKs from shadow nodes are dropped (the switch emulates the TCP server).

In the multi-switch fabric simulator every leaf and spine instantiates its
own ``SwitchDataPlane`` (own counters); the multicast/mirror rules are only
installed — i.e. ``replicate=True`` — on the ingress leaf of each boundary
rank, matching where the control plane (§4.3.1) programs the match-action
table.  All counters are weighted by ``Frame.n_frames`` so coalesced frames
report exact wire-frame counts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.core.multicast import SwitchControlPlane
from repro_torch.net.packets import Frame


@dataclass
class SwitchCounters:
    rx_frames: int = 0
    tx_frames: int = 0
    mirrored_frames: int = 0
    dropped_acks: int = 0

    @property
    def tx_over_rx(self) -> float:
        return self.tx_frames / self.rx_frames if self.rx_frames else 0.0

    def merge(self, other: "SwitchCounters") -> "SwitchCounters":
        """Aggregate counters across switches (fabric-wide totals)."""
        return SwitchCounters(
            rx_frames=self.rx_frames + other.rx_frames,
            tx_frames=self.tx_frames + other.tx_frames,
            mirrored_frames=self.mirrored_frames + other.mirrored_frames,
            dropped_acks=self.dropped_acks + other.dropped_acks)

    def as_dict(self) -> dict:
        """Plain-dict view for metrics publication / JSON snapshots."""
        d = dataclasses.asdict(self)
        d["tx_over_rx"] = self.tx_over_rx
        return d


class SwitchDataPlane:
    """Match-action pipeline of one physical switch.

    Args:
        control: the fabric-wide control plane (match table + shadow map).
        rank_to_dp: maps a global source rank to its DP group; defaults to
            contiguous groups of ``control.ranks_per_group`` ranks.
        name: switch id for per-switch counter reporting ("sw0", "leaf3",
            "spine1", ...).
    """

    def __init__(self, control: SwitchControlPlane,
                 rank_to_dp=None, name: str = "sw0"):
        self.control = control
        self.name = name
        self.counters = SwitchCounters()
        self.rank_to_dp = rank_to_dp or (
            lambda r: r // control.ranks_per_group)

    def process(self, frame: Frame, replication_factor: int = 1,
                replicate: bool = True) -> list[Frame]:
        """One ingress frame -> egress frames (forward + mirrors).

        Args:
            replication_factor: mirror copies per tagged frame (Fig 10
                sweeps this); each copy gets a distinct ``replica`` index.
            replicate: False on switches where the multicast rule is not
                installed (spines / non-boundary leaves) — pure forwarding.
        """
        self.counters.rx_frames += frame.n_frames
        out = [frame]                            # normal L2 forward
        if replicate and frame.tagged and not frame.mirrored:
            dp = self.rank_to_dp(frame.src)
            group = self.control.lookup(dp, frame.src)
            if group is not None:
                for rep in range(replication_factor):
                    out.append(dataclasses.replace(
                        frame,
                        dst=frame.shadow_node,
                        # egress rewrite: shadow-stream sequence (§4.3.2)
                        tcp_seq=frame.shadow_seq,
                        mirrored=True, replica=rep))
                    self.counters.mirrored_frames += frame.n_frames
        self.counters.tx_frames += sum(f.n_frames for f in out)
        return out

    def process_ack(self):
        self.counters.dropped_acks += 1
        return []
