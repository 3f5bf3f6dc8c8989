"""Network resource planning (paper §4.4) and fabric topology construction
for the event-driven simulator, the port's copy of ``repro.net.planner``.

Two concerns live here:

* ``plan`` — the paper's §4.4 port/NIC accounting (2 multicast streams per
  DP group) plus the host-DMA budget check: for LLaMA3-405B (128 DP
  groups on 16K GPUs) the 256 extra ToR ports are < 0.8% of cluster network
  resources.
* ``build_topology`` — constructs the multi-switch fabric the event-driven
  simulator (`repro_torch.net.simulator`) runs on: hosts, shadow hosts,
  leaf and spine switches, and directed capacity links with static
  next-hop routing and deterministic ECMP spine selection.

Topology flavors:

* ``single``      — every host and shadow NIC on one switch (the legacy
                    idealization; the compatibility wrapper uses this).
* ``rail``        — rail-optimized leaf/spine: ring-consecutive ranks of a
                    DP group are packed onto the same leaf, so ring traffic
                    is overwhelmingly leaf-local and only DP-group boundary
                    hops and mirror traffic cross the spine.
* ``leaf-spine``  — same switches, but ranks are strided across leaves, so
                    every ring hop crosses the spine (the pessimal
                    placement; useful as a contention baseline).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class PlanInput:
    n_accelerators: int
    dp_groups: int
    ranks_per_group: int
    ports_per_tor: int = 32
    accel_per_host: int = 4
    pcie_gbps: float = 128.0         # PCIe gen4 x16 ~ 16 GB/s = 128 Gbps
    link_gbps: float = 100.0


@dataclass(frozen=True)
class Plan:
    multicast_streams: int
    extra_ports: int
    extra_port_fraction: float
    shadow_min_nics: int
    hosts: int
    grad_bytes_per_host: float
    pcie_util: float
    feasible: bool
    notes: str


def plan(inp: PlanInput, grad_bytes_total: float, iter_time_s: float) -> Plan:
    """§4.4 feasibility check: extra ports and host-DMA budget.

    Args:
        inp: cluster shape and per-component bandwidths.
        grad_bytes_total: full reduced-gradient payload per iteration.
        iter_time_s: training iteration time the capture must hide inside.
    """
    streams = 2 * inp.dp_groups
    total_ports = (inp.n_accelerators // max(inp.ports_per_tor // 2, 1)
                   ) * inp.ports_per_tor
    frac = streams / max(total_ports, 1)
    hosts = inp.n_accelerators // inp.accel_per_host
    per_host = grad_bytes_total / max(hosts, 1)
    pcie_util = (per_host * 8 / 1e9) / (inp.pcie_gbps * iter_time_s) \
        if iter_time_s else 0.0
    feasible = pcie_util < 0.5 and frac < 0.05
    notes = []
    if pcie_util >= 0.5:
        notes.append(f"host DMA uses {pcie_util:.0%} of PCIe — shard the "
                     "capture across more hosts or lengthen the interval")
    if frac >= 0.05:
        notes.append("extra ToR ports exceed 5% of fabric — repurpose "
                     "uplinks (spine-free) per §4.4")
    return Plan(multicast_streams=streams, extra_ports=streams,
                extra_port_fraction=frac,
                shadow_min_nics=2,           # round-0 double rate (§4.1.1)
                hosts=hosts, grad_bytes_per_host=per_host,
                pcie_util=pcie_util, feasible=feasible,
                notes="; ".join(notes) or "ok")


# ---------------------------------------------------------------------------
# Fabric topology for the event-driven simulator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LinkSpec:
    """One directed capacity link (an egress queue + serializer).

    Args:
        src/dst: node names ("h3", "leaf0", "spine1", "s0").
        gbps: line rate; a bonded shadow NIC pair is one link at 2x rate.
        prop_s: propagation + forwarding latency to the far end.
        nics: physical NICs bonded into this link (reporting only).
    """
    src: str
    dst: str
    gbps: float
    prop_s: float = 1e-6
    nics: int = 1


@dataclass
class Topology:
    """Static fabric description consumed by ``repro_torch.net.simulator``.

    Node naming: training hosts are ``h{global_rank}``, shadow hosts
    ``s{node}``, leaves ``leaf{i}`` (plus ``leafS`` for the shadow rail when
    present), spines ``spine{i}``.  ``links`` holds both directions of every
    cable as separate ``LinkSpec`` entries (full duplex).
    """
    name: str
    n_ranks: int
    n_dp_groups: int
    ranks_per_group: int
    n_shadow: int
    hosts: list[str]
    shadow_hosts: list[str]
    leaves: list[str]
    spines: list[str]
    links: dict[tuple[str, str], LinkSpec]
    attach: dict[str, str]              # host/shadow -> its leaf
    host_of_rank: dict[int, str]
    shadow_host_of: dict[int, str]


def _duplex(links: dict, a: str, b: str, gbps: float, prop_s: float = 1e-6,
            nics: int = 1):
    links[(a, b)] = LinkSpec(a, b, gbps, prop_s, nics)
    links[(b, a)] = LinkSpec(b, a, gbps, prop_s, nics)


def build_topology(n_dp_groups: int, ranks_per_group: int, n_shadow: int = 1,
                   *, topology: str = "rail", ranks_per_leaf: int = 32,
                   link_gbps: float = 100.0, spine_gbps: float | None = None,
                   shadow_nics: int = 2, n_spines: int = 2,
                   shadow_rails: int = 1, prop_s: float = 1e-6) -> Topology:
    """Build a fabric for the event-driven simulator.

    Args:
        topology: "single" | "rail" | "leaf-spine" (see module docstring).
        ranks_per_leaf: leaf radix used by the multi-switch flavors.
        link_gbps: host and shadow access link rate per NIC.
        spine_gbps: leaf->spine uplink rate (default ``4 * link_gbps``).
        shadow_nics: bonded NICs per shadow host (§4.1.1 says >= 2 so the
            round-0 double-rate incast does not pause the fabric).
        n_spines: spine count; leaf->spine selection is deterministic ECMP
            with failover in the simulator.
        shadow_rails: shadow-rail leaf count; a bucket-sharded shadow
            cluster spreads its owner nodes round-robin across rails so
            mirror incast splits over independent leaves. ``1`` keeps the
            legacy single ``leafS`` rail (name included).
    """
    n_ranks = n_dp_groups * ranks_per_group
    hosts = [f"h{r}" for r in range(n_ranks)]
    shadow_hosts = [f"s{n}" for n in range(n_shadow)]
    host_of_rank = dict(enumerate(hosts))
    shadow_host_of = dict(enumerate(shadow_hosts))
    links: dict[tuple[str, str], LinkSpec] = {}
    attach: dict[str, str] = {}

    if topology == "single":
        leaves, spines = ["sw0"], []
        for h in hosts:
            attach[h] = "sw0"
            _duplex(links, h, "sw0", link_gbps, prop_s)
        for s in shadow_hosts:
            attach[s] = "sw0"
            _duplex(links, s, "sw0", link_gbps * shadow_nics, prop_s,
                    nics=shadow_nics)
        return Topology("single", n_ranks, n_dp_groups, ranks_per_group,
                        n_shadow, hosts, shadow_hosts, leaves, spines, links,
                        attach, host_of_rank, shadow_host_of)

    if topology not in ("rail", "leaf-spine"):
        raise ValueError(f"unknown topology {topology!r}")

    n_leaves = max(1, (n_ranks + ranks_per_leaf - 1) // ranks_per_leaf)
    leaves = [f"leaf{i}" for i in range(n_leaves)]
    spines = [f"spine{i}" for i in range(max(n_spines, 1))]
    spine_gbps = spine_gbps or 4 * link_gbps
    for r, h in enumerate(hosts):
        if topology == "rail":
            leaf = leaves[r // ranks_per_leaf]          # consecutive packing
        else:
            leaf = leaves[r % n_leaves]                 # strided (pessimal)
        attach[h] = leaf
        _duplex(links, h, leaf, link_gbps, prop_s)
    # shadow rail(s): shadow hosts share dedicated leaves reachable via
    # spines; multiple rails spread a sharded cluster's incast round-robin
    rails = max(1, shadow_rails)
    shadow_leaves = (["leafS"] if rails == 1
                     else [f"leafS{r}" for r in range(rails)])
    leaves = leaves + shadow_leaves
    for i, s in enumerate(shadow_hosts):
        shadow_leaf = shadow_leaves[i % rails]
        attach[s] = shadow_leaf
        _duplex(links, s, shadow_leaf, link_gbps * shadow_nics, prop_s,
                nics=shadow_nics)
    for leaf in leaves:
        for sp in spines:
            _duplex(links, leaf, sp, spine_gbps, prop_s)
    return Topology(topology, n_ranks, n_dp_groups, ranks_per_group,
                    n_shadow, hosts, shadow_hosts, leaves, spines, links,
                    attach, host_of_rank, shadow_host_of)
