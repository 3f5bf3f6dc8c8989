"""Multicast-update control plane (paper §4.3.1, §4.2.4), the port's copy
of ``repro.core.multicast``.

The switch control plane is configured per DP group with the boundary ranks'
addresses; it creates protocol-independent multicast groups (next training
rank + the shadow nodes) and a shadow-node-id -> address map used to rewrite
mirrored packets. `assign_buckets` is the bucket -> shadow node ownership map
that the shadow cluster and a sharded channel both derive.

The data plane that consumes this configuration lives in
`repro_torch.net.switch`; the event-driven fabric simulator
(`repro_torch.net.simulator`) instantiates one control plane per fabric and
one data plane per switch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.buckets import BucketLayout


@dataclass(frozen=True)
class MulticastGroup:
    group_id: int
    dp_group: int
    boundary_rank: int            # tagging source (first or last rank)
    next_rank: int                # normal AllGather destination
    shadow_nodes: tuple[int, ...]


@dataclass
class SwitchControlPlane:
    """Match-action configuration for tagged-gradient replication.

    Args:
        n_dp_groups: concurrent data-parallel groups sharing the fabric.
        ranks_per_group: ring size of each group's AllGather; global rank
            ``r`` belongs to DP group ``r // ranks_per_group``.
        n_shadow_nodes: CPU shadow nodes mirrored packets may target.

    Call ``setup()`` before use: it installs two multicast streams per DP
    group (the first and last rank of each ring, §4.4) into
    ``match_table`` and assigns shadow node addresses.
    """
    n_dp_groups: int
    ranks_per_group: int
    n_shadow_nodes: int
    shadow_addr: dict[int, str] = field(default_factory=dict)
    groups: list[MulticastGroup] = field(default_factory=list)
    match_table: dict[tuple[int, int], int] = field(default_factory=dict)

    def setup(self):
        """Two multicast streams per DP group (first + last rank), §4.4."""
        gid = 0
        self.groups.clear()
        self.match_table.clear()
        for dp in range(self.n_dp_groups):
            first = dp * self.ranks_per_group
            last = first + self.ranks_per_group - 1
            for rank in {first, last}:
                nxt = first + ((rank - first + 1) % self.ranks_per_group)
                g = MulticastGroup(
                    group_id=gid, dp_group=dp, boundary_rank=rank,
                    next_rank=nxt,
                    shadow_nodes=tuple(range(self.n_shadow_nodes)))
                self.groups.append(g)
                self.match_table[(dp, rank)] = gid
                gid += 1
        for node in range(self.n_shadow_nodes):
            self.shadow_addr[node] = f"10.8.{node // 256}.{node % 256}"
        return self

    def lookup(self, dp_group: int, src_rank: int) -> Optional[MulticastGroup]:
        """Match a (DP group, global source rank) against the multicast
        table; None for non-boundary ranks (no replication rule)."""
        gid = self.match_table.get((dp_group, src_rank))
        return self.groups[gid] if gid is not None else None

    @property
    def multicast_streams(self) -> int:
        return len(self.groups)

    def extra_switch_ports(self) -> int:
        """Ports for shadow connectivity: 2 streams per DP group (§4.4)."""
        return 2 * self.n_dp_groups


def multicast_groups(n_dp_groups: int, ranks_per_group: int,
                     n_shadow_nodes: int) -> list[MulticastGroup]:
    """The fabric's multicast group set (who replicates, to which shadow
    nodes), without holding a control plane; the stateful match-action
    table stays inside the simulator's own `SwitchControlPlane`."""
    return SwitchControlPlane(
        n_dp_groups, ranks_per_group, n_shadow_nodes).setup().groups


def assign_buckets(layout: BucketLayout, n_nodes: int) -> dict[int, int]:
    """bucket_id -> shadow node, byte-balanced greedy partition.

    Deterministic: buckets in id order onto the currently-lightest node, so
    training side and shadow nodes all derive the same mapping.
    """
    load = [0] * n_nodes
    out = {}
    for b in layout.buckets:
        node = min(range(n_nodes), key=lambda i: (load[i], i))
        out[b.bucket_id] = node
        load[node] += b.nbytes
    return out


def node_partitions(layout: BucketLayout, assignment: dict[int, int],
                    n_nodes: int) -> list[list[int]]:
    parts: list[list[int]] = [[] for _ in range(n_nodes)]
    for bid, node in assignment.items():
        parts[node].append(bid)
    return parts
