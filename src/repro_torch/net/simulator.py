"""Event-driven fabric simulator for gradient multicast (paper §4, Fig 10),
the port's copy of ``repro.net.simulator``: pure Python, kept line for line
(the event arithmetic and the ECMP hash included) so that its
`FabricResult` equals the reference's field for field.

A global event queue (`heapq`) advances simulated time over a multi-switch
topology built by `repro_torch.net.planner.build_topology`.  First-class
resources:

* **links** — every directed link is an egress queue plus a serializer:
  frames wait FIFO, transmit at line rate (serialization delay), then
  propagate (`prop_s`) to the far node,
* **switch egress queues** — bounded buffers; crossing the PFC XOFF
  threshold sends PAUSE to every upstream transmitter of that switch
  (propagated with `PfcConfig.pause_prop_s`), RESUME below XON — so incast
  at the shadow rail visibly backpressures the fabric hop by hop,
* **NICs** — host/shadow access links (bonded shadow NIC pairs are one link
  at aggregate rate, §4.1.1),
* **shadow drain** — the shadow access link's serializer is the drain.

Losses: a full lossy queue or a killed link drops frames.  Ring (training)
frames are retransmitted by their source after `retx_timeout_s` (TCP);
switch-mirrored copies are **not** — the switch PRE keeps no state and the
shadow stream's ACKs are dropped (§4.3.2), so a mirror loss means that
iteration's capture is incomplete, which is exactly the signal
`repro_torch.core.channel.PacketizedChannel` gates a delivery on.

The workload is one AllGather iteration per DP group, all groups sharing
the fabric concurrently: rank ``r`` sends round ``t+1``'s chunk only after
fully receiving round ``t``'s (the real ring dependency), with heartbeat
tagging and per-channel shadow streams from `repro_torch.core.tagging`.

`simulate_allgather_replication` is kept as a thin compatibility wrapper
(single-switch topology, one DP group) over this engine; the original
per-round arithmetic model survives as `_legacy_simulate_allgather` for
regression comparison.  See docs/netsim.md for the full model and a worked
Fig 10 example.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import heapq
from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.multicast import SwitchControlPlane
from repro_torch.core.tagging import (chunk_at, fabric_tag_schedule,
                                      is_tagged, tag_schedule)
from repro_torch.net.packets import MTU, Frame, frames_for_chunk
from repro_torch.net.pfc import PfcConfig, PfcQueue
from repro_torch.net.planner import Topology, build_topology
from repro_torch.net.switch import SwitchCounters, SwitchDataPlane

_HOST, _SWITCH, _SHADOW = 0, 1, 2


@dataclass(frozen=True)
class FailureSpec:
    """Fabric-level failure injection: fires once at ``at_s``.

    Args:
        at_s: simulation time of the failure (seconds).
        kind: "link" (cut a cable: both directions), "switch" (kill every
            link touching the switch), or "shadow_nic" (cut a shadow host's
            access link).
        target: ("a", "b") node-name pair for "link"; a switch name for
            "switch"; a shadow host name ("s0") or node id for "shadow_nic".
    """
    at_s: float
    kind: str
    target: tuple | str | int


@dataclass
class FabricResult:
    """Outcome of one fabric iteration (see docs/netsim.md)."""
    topology: str
    n_ranks: int
    n_dp_groups: int
    ranks_per_group: int
    n_shadow: int
    replication_factor: int
    grad_bytes_per_group: int
    duration_s: float
    group_done_s: dict
    ring_completed: bool
    algo_bandwidth_gbps: float
    bus_bandwidth_gbps: float
    rx_frames: int
    tx_frames: int
    mirrored_frames: int
    tx_over_rx: float
    switch_counters: dict
    shadow_bytes: dict
    reassembled_ok: bool
    missing_captures: int
    duplicate_mirror_bytes: int
    mirror_lost_frames: int
    drops: int
    retransmits: int
    rerouted: int
    pfc_pauses: int
    pfc_resumes: int
    latency: dict
    # processed heap events — identical between fast=True and the
    # per-frame oracle (the fast engine walks the exact same event
    # stream, it just dispatches it cheaper); the differential suite
    # (tests/test_fabric_fastpath.py) asserts full equality
    events: int
    # per-link PFC pause-duration account (was aggregate-only): total
    # link-paused virtual seconds, plus {"src->dst": {pauses, resumes,
    # pause_s}} for every link that ever paused
    pfc_pause_s: float = 0.0
    link_pfc: dict = field(default_factory=dict)


class _Link:
    """Runtime state of one directed link: FIFO egress queue + serializer."""
    __slots__ = ("src", "dst", "rate_bps", "prop", "q", "qbytes", "busy",
                 "up", "pause_count", "sent_xoff", "cap", "xoff", "xon",
                 "epoch", "drops", "pause_events", "resume_events",
                 "paused_since", "pause_s", "key", "ser_chunk")

    def __init__(self, spec, bounded: bool, pfc: PfcConfig,
                 min_cap: int = 0):
        self.key = (spec.src, spec.dst)
        self.src, self.dst = spec.src, spec.dst
        self.rate_bps = spec.gbps * 1e9
        self.prop = spec.prop_s
        self.q: deque = deque()
        self.qbytes = 0
        self.busy = False
        self.up = True
        self.pause_count = 0            # XOFFs currently held against us
        self.sent_xoff = False          # our queue has paused our feeders
        # frame coalescing makes enqueues burstier than the wire (one event
        # may carry quantum * rf MTU frames), so the lossless class scales
        # its buffer up with min_cap to keep the same relative headroom the
        # real frames have; the lossy class keeps the user's capacity (its
        # drops are the experiment) and bounds the quantum instead
        cap = max(pfc.capacity_bytes, min_cap) if pfc.enabled \
            else pfc.capacity_bytes
        self.cap = cap if bounded else None
        self.xoff = int(cap * pfc.xoff_frac)
        self.xon = int(cap * pfc.xon_frac)
        self.epoch = 0                  # bumped on kill: stale events no-op
        self.drops = 0
        self.pause_events = 0
        self.resume_events = 0
        self.paused_since = 0.0         # sim time the open pause began
        self.pause_s = 0.0              # closed-pause virtual time total


class FabricSimulator:
    """One AllGather iteration of every DP group over a shared fabric.

    Args:
        topo: static fabric from `repro_torch.net.planner.build_topology`.
        grad_bytes_per_group: reduced-gradient payload per DP group.
        replication_factor: mirror copies per tagged frame (Fig 10).
        n_channels: collective channels; each gets its own shadow stream.
        pfc: thresholds + PAUSE propagation for switch egress queues; pass
            ``PfcConfig(enabled=False)`` for a lossy class (drops + retx).
        failures: `FailureSpec` events to inject mid-iteration.
        frame_quantum: coalesce this many MTU frames per event (None =
            auto-pick so a chunk is <= ~256 events; counters stay exact).
        retx_timeout_s / max_retx: source retransmission for ring frames.
        max_time_s: hard simulation-time stop (guards unreachable rings).
        frame_tx_hook: injection point — called once per frame as it is
            created at its source host (before first enqueue); gradient
            channels use it to attach real payload bytes (`Frame.payload`)
            via `wire_offset`. Retransmissions reuse the same frame object,
            and switch mirrors share the buffer, so the hook fires exactly
            once per logical frame.
        shadow_rx_hook: extraction point — called as ``hook(node_id,
            frame)`` when a (mirrored) frame is finally delivered to a
            shadow host; channels use it to reassemble the capture.
        shadow_route: bucket-sharded shadow plane — maps a frame byte's
            *total-buffer* offset (``total_offset``) to the shadow node
            that owns it, overriding the round-robin tag schedule. The
            sender packetizes the shadow stream (§4.2.4 — it encodes the
            shadow node id per packet), so tagged frames are split at
            ``shadow_cuts`` and every piece is stamped with its owner.
        shadow_cuts: sorted total-buffer offsets where bucket ownership
            changes; tagged frames straddling a cut are split there.
        fast: run the specialized event engine (``_run_fast``). It walks
            the exact same heap with the exact same keys and float
            arithmetic as the per-frame loop — every event fires at the
            same instant in the same order — but the hot
            serialize -> arrive -> route -> enqueue chain is inlined into
            one dispatch loop with hoisted lookups, and every rare branch
            (tagged/mirror traffic, kills, drops, PFC transitions,
            multi-channel or sharded sends) falls back to the exact
            per-frame methods mid-chain. Results are bit-exact against
            ``fast=False`` including ``FabricResult.events``;
            tests/test_fabric_fastpath.py is the differential suite.
    """

    def __init__(self, topo: Topology, *, grad_bytes_per_group: int,
                 replication_factor: int = 1, n_channels: int = 1,
                 pfc: PfcConfig = PfcConfig(), failures=(),
                 frame_quantum: int | None = None,
                 retx_timeout_s: float = 100e-6, max_retx: int = 10,
                 max_time_s: float = 30.0,
                 frame_tx_hook=None, shadow_rx_hook=None,
                 shadow_route=None, shadow_cuts=(), fast: bool = False):
        self.topo = topo
        self.fast = bool(fast)
        self.pfc = pfc
        self.shadow_route = shadow_route
        self.shadow_cuts = sorted(shadow_cuts)
        self.rf = max(1, replication_factor)
        self.n_channels = max(1, n_channels)
        self.retx_timeout = retx_timeout_s
        self.max_retx = max_retx
        self.max_time = max_time_s
        self.frame_tx_hook = frame_tx_hook
        self.shadow_rx_hook = shadow_rx_hook
        n, rpg = topo.n_ranks, topo.ranks_per_group
        self.rounds = max(rpg - 1, 1)
        self.chunk_bytes = grad_bytes_per_group // rpg
        if self.chunk_bytes <= 0:
            raise ValueError("grad_bytes_per_group must cover >=1 byte/rank")
        nc = self.n_channels
        base, rem = divmod(self.chunk_bytes, nc)
        self.split = [base + (1 if i < rem else 0) for i in range(nc)]
        if frame_quantum is None:
            raw = (max(self.split) + MTU - 1) // MTU
            frame_quantum = max(1, (raw + 255) // 256)
            if not pfc.enabled:
                # lossy buffers stay at the configured size, so a coalesced
                # frame must stay well under it or every enqueue drops
                frame_quantum = min(frame_quantum,
                                    max(1, pfc.capacity_bytes // (4 * MTU)))
        self.quantum = frame_quantum

        self.control = SwitchControlPlane(
            topo.n_dp_groups, rpg, topo.n_shadow).setup()
        switch_names = list(topo.leaves) + list(topo.spines)
        self.dataplanes = {s: SwitchDataPlane(self.control, name=s)
                           for s in switch_names}
        self._kind = {h: _HOST for h in topo.hosts}
        self._kind.update({s: _SWITCH for s in switch_names})
        self._kind.update({s: _SHADOW for s in topo.shadow_hosts})
        self._shadow_id = {h: i for i, h in topo.shadow_host_of.items()}
        self._leaf_idx = {l: i for i, l in enumerate(topo.leaves)}
        self._spine_set = set(topo.spines)
        # worst case between XOFF firing and it taking effect: two taggers
        # (round 0, §4.1.1) each land one quantum*rf mirror burst plus a
        # pause-propagation window of line-rate arrivals — 16x covers it
        # with the default xoff_frac of 0.8 (headroom = 3.2 * burst)
        min_cap = 16 * self.quantum * MTU * self.rf
        self.links = {k: _Link(spec, bounded=self._kind[spec.src] == _SWITCH,
                               pfc=pfc, min_cap=min_cap)
                      for k, spec in topo.links.items()}
        self._feeders = {}              # node -> [links whose dst == node]
        for lk in self.links.values():
            self._feeders.setdefault(lk.dst, []).append(lk)
        self._attach_of_rank = [topo.attach[topo.host_of_rank[r]]
                                for r in range(n)]

        # tag schedule: (group, round, local_rank, channel) -> TagEvent
        self.schedule = {}
        for g, evs in fabric_tag_schedule(
                topo.n_dp_groups, rpg, n_channels=nc,
                n_shadow_nodes=topo.n_shadow).items():
            for ev in evs:
                self.schedule[(g, ev.round, ev.src_rank, ev.channel)] = ev

        # expected shadow capture: (g, ch, chunk, replica) -> bytes
        self.expected = {}
        for (g, _r, _lr, ch), ev in self.schedule.items():
            for rep in range(self.rf):
                self.expected[(g, ch, ev.chunk, rep)] = self.split[ch]
        self._cov: dict = {}            # key -> {offset: bytes}
        self.shadow_bytes = {i: 0 for i in range(topo.n_shadow)}
        self.duplicate_mirror_bytes = 0

        # ring receive bookkeeping
        self._rx_round = [dict() for _ in range(n)]     # rank -> {round: B}
        self._done_rounds = [set() for _ in range(n)]
        self._send_next = [1] * n
        self._group_rounds_left = {g: rpg * self.rounds
                                   for g in range(topo.n_dp_groups)}
        self.group_done_s: dict = {}

        self._heap: list = []
        self._seq = 0
        self.now = 0.0
        self.events = 0
        # memoize the hot bound methods: every heap push reuses ONE object,
        # so the fast loop can dispatch by identity (`fn is arrive`) and
        # classic pushes skip re-binding. Reads still resolve through the
        # instance, so both loops push the very same objects.
        self._tx_done = self._tx_done
        self._arrive = self._arrive
        self.retransmits = 0
        self.rerouted = 0
        self.mirror_lost = 0
        self.undelivered = 0
        self._lat = {"ring": [0, 0.0, 0.0], "mirror": [0, 0.0, 0.0]}
        for spec in failures:
            self._at(spec.at_s, self._fail, spec)

    # -- event plumbing ----------------------------------------------------
    # Heap entries are (fire_t, seq, fn, arg): same-instant events fire in
    # creation order. Both engines push through this one function (or an
    # inline copy with identical keys), so event order never depends on
    # which engine runs.
    def _at(self, t: float, fn, arg):
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, fn, arg))

    def _after(self, dt: float, fn, arg):
        self._at(self.now + dt, fn, arg)

    # -- failures ----------------------------------------------------------
    def _fail(self, spec: FailureSpec):
        if spec.kind == "link":
            a, b = spec.target
            self._kill((a, b))
            self._kill((b, a))
        elif spec.kind == "switch":
            for key in list(self.links):
                if spec.target in key:
                    self._kill(key)
        elif spec.kind == "shadow_nic":
            t = spec.target
            host = t if isinstance(t, str) else self.topo.shadow_host_of[t]
            leaf = self.topo.attach[host]
            self._kill((leaf, host))
            self._kill((host, leaf))
        else:
            raise ValueError(f"unknown failure kind {spec.kind!r}")

    def _kill(self, key):
        lk = self.links.get(key)
        if lk is None or not lk.up:
            return
        lk.up = False
        lk.epoch += 1
        lk.busy = False
        lost = list(lk.q)
        lk.q.clear()
        lk.qbytes = 0
        if lk.sent_xoff:                # dead queue must release its PAUSEs
            lk.sent_xoff = False
            for f in self._feeders.get(lk.src, []):
                self._after(self.pfc.pause_prop_s, self._resume, f)
        for fr in lost:
            self._lost(fr)

    # -- loss / retransmission --------------------------------------------
    def _lost(self, f: Frame):
        if f.mirrored:
            # the switch PRE keeps no state and shadow ACKs are dropped
            # (§4.3.2): a lost mirror is an incomplete capture, not a retx
            self.mirror_lost += f.n_frames
            return
        if f.retx >= self.max_retx:
            self.undelivered += f.n_frames
            return
        f.retx += 1
        self.retransmits += f.n_frames
        self._after(self.retx_timeout, self._inject, f)

    def _inject(self, f: Frame):
        src_host = self.topo.host_of_rank[f.src]
        self._enqueue(self.links[(src_host, self.topo.attach[src_host])], f)

    # -- link machinery ----------------------------------------------------
    def _enqueue(self, lk: _Link, f: Frame):
        if not lk.up:
            self._lost(f)
            return
        if lk.cap is not None and lk.qbytes + f.payload_len > lk.cap:
            lk.drops += f.n_frames
            self._lost(f)
            return
        lk.q.append(f)
        lk.qbytes += f.payload_len
        if (self.pfc.enabled and lk.cap is not None
                and lk.qbytes >= lk.xoff and not lk.sent_xoff):
            lk.sent_xoff = True
            for feeder in self._feeders.get(lk.src, []):
                self._after(self.pfc.pause_prop_s, self._pause, feeder)
        self._try_tx(lk)

    def _pause(self, lk: _Link):
        if lk.pause_count == 0:          # pause interval opens
            lk.paused_since = self.now
        lk.pause_count += 1
        lk.pause_events += 1

    def _resume(self, lk: _Link):
        if lk.pause_count > 0:
            lk.pause_count -= 1
            lk.resume_events += 1
            if lk.pause_count == 0:      # pause interval closes
                lk.pause_s += self.now - lk.paused_since
            self._try_tx(lk)

    def _try_tx(self, lk: _Link):
        if lk.busy or lk.pause_count or not lk.q or not lk.up:
            return
        lk.busy = True
        self._after(lk.q[0].payload_len * 8 / lk.rate_bps, self._tx_done,
                    (lk, lk.epoch))

    def _tx_done(self, arg):
        lk, epoch = arg
        if epoch != lk.epoch:
            return                      # link was killed mid-serialization
        f = lk.q.popleft()
        lk.qbytes -= f.payload_len
        lk.busy = False
        if lk.sent_xoff and lk.qbytes <= lk.xon:
            lk.sent_xoff = False
            for feeder in self._feeders.get(lk.src, []):
                self._after(self.pfc.pause_prop_s, self._resume, feeder)
        self._after(lk.prop, self._arrive, (f, lk.dst))
        self._try_tx(lk)

    # -- routing -----------------------------------------------------------
    @staticmethod
    def _ecmp_mix(a: int, b: int, c: int) -> int:
        """Deterministic avalanche mix for ECMP flow hashing (a plain
        linear combination keeps src/dst parity, which collapses all
        adjacent-leaf ring flows onto one spine)."""
        x = (a * 0x9E3779B1 + b * 0x85EBCA77 + c * 0xC2B2AE3D) & 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x045D9F3B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    def _route(self, sw: str, dst_host: str, f: Frame):
        """Next hop from switch ``sw`` toward ``dst_host`` (None = no path).

        Deterministic per-flow ECMP over spines with failover: the preferred
        spine hashes (src leaf, dst leaf, source rank) so flows spread, and
        a dead spine or uplink reroutes to the next live one.
        """
        topo = self.topo
        leaf_dst = topo.attach[dst_host]
        if sw == leaf_dst:
            return dst_host if self.links[(sw, dst_host)].up else None
        if sw in self._spine_set:
            return leaf_dst if self.links[(sw, leaf_dst)].up else None
        spines = topo.spines
        i0 = self._ecmp_mix(self._leaf_idx[sw], self._leaf_idx[leaf_dst],
                            f.src) % len(spines)
        for k in range(len(spines)):
            sp = spines[(i0 + k) % len(spines)]
            if self.links[(sw, sp)].up and self.links[(sp, leaf_dst)].up:
                if k:
                    self.rerouted += f.n_frames
                return sp
        return None

    # -- node arrival ------------------------------------------------------
    def _arrive(self, arg):
        f, node = arg
        kind = self._kind[node]
        if kind == _SWITCH:
            replicate = (f.tagged and not f.mirrored
                         and node == self._attach_of_rank[f.src])
            out = self.dataplanes[node].process(f, self.rf,
                                                replicate=replicate)
            topo = self.topo
            for g in out:
                dst_host = (topo.shadow_host_of[g.dst] if g.mirrored
                            else topo.host_of_rank[g.dst])
                if g.mirrored and g is not f:
                    g.t_send = self.now
                nh = self._route(node, dst_host, g)
                if nh is None:
                    self._lost(g)
                else:
                    self._enqueue(self.links[(node, nh)], g)
        elif kind == _HOST:
            f.t_arrive = self.now
            self._stat("ring", f)
            self._host_recv(f)
        else:
            f.t_arrive = self.now
            self._stat("mirror", f)
            self._shadow_recv(node, f)
            # the shadow's TCP stack ACKs; its leaf's data plane drops it
            self.dataplanes[self.topo.attach[node]].process_ack()

    def _stat(self, cls: str, f: Frame):
        s = self._lat[cls]
        d = self.now - f.t_send
        s[0] += f.n_frames
        s[1] += d * f.n_frames
        s[2] = max(s[2], d)

    def _host_recv(self, f: Frame):
        rank = f.dst
        rpg = self.topo.ranks_per_group
        lr = rank - f.dp_group * rpg
        rnd = (lr - f.chunk) % rpg if rpg > 1 else 0
        acc = self._rx_round[rank]
        got = acc.get(rnd, 0) + f.payload_len
        acc[rnd] = got
        if got < self.chunk_bytes or rnd in self._done_rounds[rank]:
            return
        self._done_rounds[rank].add(rnd)
        g = f.dp_group
        self._group_rounds_left[g] -= 1
        if self._group_rounds_left[g] == 0:
            self.group_done_s[g] = self.now
        # ring dependency: receiving round t releases send of round t+1
        while (self._send_next[rank] <= self.rounds - 1
               and self._send_next[rank] - 1 in self._done_rounds[rank]):
            t = self._send_next[rank]
            self._send_next[rank] += 1
            self._send_round(g, lr, t)

    def wire_offset(self, f: Frame) -> int:
        """Byte offset of ``f``'s payload inside its DP group's contiguous
        reduced-gradient buffer (chunk-major, channel-split within a chunk).
        Gradient channels use this to slice payload at injection and to
        place received spans at extraction."""
        return (f.chunk * self.chunk_bytes
                + sum(self.split[:f.channel]) + f.payload_off)

    def total_offset(self, f: Frame) -> int:
        """Byte offset of ``f``'s payload inside the concatenated
        all-groups wire buffer (group-major) — the coordinate system the
        sharded shadow plane's owner map (``shadow_route``) speaks."""
        return (f.dp_group * self.chunk_bytes * self.topo.ranks_per_group
                + self.wire_offset(f))

    def _owner_split(self, f: Frame):
        """Route a tagged frame to its bucket-owner shadow node(s).

        The sender packetizes the shadow stream (§4.2.4: it encodes the
        shadow node id per packet), so it aligns frame boundaries to
        bucket-ownership cuts: a frame straddling a cut is split into
        per-owner pieces, each a self-consistent frame (offsets, TCP and
        shadow sequence numbers advanced; wire-frame count re-derived).
        """
        route = self.shadow_route
        if route is None or not f.tagged:
            return (f,)
        w0 = self.total_offset(f)
        w1 = w0 + f.payload_len
        cuts = self.shadow_cuts
        i = bisect.bisect_right(cuts, w0)
        j = bisect.bisect_left(cuts, w1, i)
        if i == j:                          # one owner: stamp in place
            f.shadow_node = route(w0)
            return (f,)
        out = []
        bounds = [w0, *cuts[i:j], w1]
        for a, b in zip(bounds, bounds[1:]):
            d = a - w0
            out.append(dataclasses.replace(
                f, payload_off=f.payload_off + d, payload_len=b - a,
                tcp_seq=f.tcp_seq + d,
                shadow_seq=(f.shadow_seq + d) if f.shadow_seq >= 0 else -1,
                shadow_node=route(a),
                n_frames=(b - a + MTU - 1) // MTU))
        return out

    def _shadow_recv(self, node: str, f: Frame):
        nid = self._shadow_id[node]
        self.shadow_bytes[nid] += f.payload_len
        key = (f.dp_group, f.channel, f.chunk, f.replica)
        seen = self._cov.setdefault(key, {})
        if f.payload_off in seen:
            self.duplicate_mirror_bytes += min(seen[f.payload_off],
                                               f.payload_len)
        seen[f.payload_off] = max(seen.get(f.payload_off, 0), f.payload_len)
        if self.shadow_rx_hook is not None:
            self.shadow_rx_hook(nid, f)

    # -- workload ----------------------------------------------------------
    def _send_round(self, g: int, lr: int, rnd: int):
        topo = self.topo
        rpg = topo.ranks_per_group
        src = g * rpg + lr
        dst = g * rpg + (lr + 1) % rpg
        chunk = chunk_at(lr, rnd, rpg)
        tagged = is_tagged(lr, rnd, rpg)
        src_host = topo.host_of_rank[src]
        lk = self.links[(src_host, topo.attach[src_host])]
        off = 0
        for ch in range(self.n_channels):
            ev = self.schedule.get((g, rnd, lr, ch)) if tagged else None
            for f in frames_for_chunk(
                    src, dst, chunk=chunk, channel=ch,
                    chunk_bytes=self.split[ch], start_seq=off,
                    tagged=tagged,
                    shadow_seq0=(ev.seq * self.split[ch]) if ev else -1,
                    shadow_node=ev.shadow_node if ev else -1,
                    dp_group=g, quantum=self.quantum):
                for sf in self._owner_split(f):
                    sf.t_send = self.now
                    if self.frame_tx_hook is not None:
                        self.frame_tx_hook(sf)
                    self._enqueue(lk, sf)
            off += self.split[ch]

    # -- run ---------------------------------------------------------------
    def run(self) -> FabricResult:
        topo = self.topo
        for g in range(topo.n_dp_groups):
            for lr in range(topo.ranks_per_group):
                self._send_round(g, lr, 0)
        if self.fast:
            self._run_fast()
        else:
            heap = self._heap
            pop = heapq.heappop
            max_time = self.max_time
            events = 0
            while heap:
                item = pop(heap)
                t = item[0]
                if t > max_time:
                    break
                self.now = t
                events += 1
                item[2](item[3])
            self.events = events
        return self._result()

    def _run_fast(self):
        """The fast engine: the exact event stream of the per-frame loop,
        dispatched cheaper.

        Two mechanically-verifiable equivalences carry the whole design:

        * **Order.** The per-frame loop fires events in ``(fire_t, seq)``
          order, and ``seq`` is globally monotonic in *push* order. So a
          calendar queue — a dict from fire time to a FIFO bucket plus a
          heap of distinct times — fires events in exactly the same order
          (same instant => insertion order == seq order) while replacing
          log-n 4-tuple comparisons with list appends. Slow-path methods
          keep scheduling through ``self._at``, which is rebound to the
          bucket push for the duration of the run.
        * **Arithmetic.** ``_tx_done`` and ``_arrive`` (the two handlers
          that are ~all events) are inlined with hoisted lookups but
          compute the identical float expressions on identical inputs in
          the identical sequence; every rare branch (tagged/mirror
          traffic, kills, drops, PFC transitions, multi-channel or
          sharded sends) falls back to the exact per-frame methods
          mid-chain.

        Results are therefore bit-identical by construction — including
        ``FabricResult.events`` — and tests/test_fabric_fastpath.py
        holds this engine to that bar against the per-frame loop."""
        times: list = []            # heap of DISTINCT fire times
        buckets: dict = {}          # fire time -> FIFO of flat event items
        pop_t = heapq.heappop
        push_t = heapq.heappush
        txdone = self._tx_done
        arrive = self._arrive

        # bucket items are flat triples — (arrive, frame, node) /
        # (txdone, link, epoch) / (other_fn, arg, None) — so the hot
        # pushes allocate one tuple and the pop unpacks once
        def fast_at(t2, fn, arg, _g=buckets.get):
            if fn is arrive or fn is txdone:
                item = (fn, arg[0], arg[1])
            else:
                item = (fn, arg, None)
            b = _g(t2)
            if b is None:
                buckets[t2] = [item]
                push_t(times, t2)
            else:
                b.append(item)

        # drain events scheduled before the run (initial sends, failure
        # timers) into the calendar in (fire_t, seq) order, then route
        # every later self._at/_after through the calendar as well
        for t2, _sq, fn, arg in sorted(self._heap):
            fast_at(t2, fn, arg)
        self._heap.clear()
        self._at = fast_at          # instance attr shadows the method

        links = self.links
        kindof = self._kind
        topo = self.topo
        attach = topo.attach
        host_of_rank = topo.host_of_rank
        spine_set = self._spine_set
        feeders = self._feeders
        pfc_enabled = self.pfc.enabled
        pause_prop = self.pfc.pause_prop_s
        lat_ring = self._lat["ring"]
        lat_mirror = self._lat["mirror"]
        rx_round = self._rx_round
        done_rounds = self._done_rounds
        send_next = self._send_next
        grl = self._group_rounds_left
        group_done = self.group_done_s
        rpg = topo.ranks_per_group
        rpg_m1 = rpg - 1
        multi_rank = rpg > 1
        chunk_bytes = self.chunk_bytes
        last_round = self.rounds - 1
        max_time = self.max_time
        bget = buckets.get
        # the single-channel unsharded untagged send (one coalesced frame
        # per chunk, no payload hook) is frequent enough to build inline
        simple_send = (self.n_channels == 1 and self.shadow_route is None
                       and self.frame_tx_hook is None
                       and self.split[0] <= MTU * self.quantum)
        nf0 = (chunk_bytes + MTU - 1) // MTU
        # per-rank forwarding table: a ring frame to rank r always lands on
        # r's access downlink from r's leaf (the topology is static; kills
        # fall back to the exact methods via the `up` checks)
        dst_info = []
        for r in range(topo.n_ranks):
            h = host_of_rank[r]
            leaf = attach[h]
            dst_info.append((leaf, links[(leaf, h)]))
        access = [links[(h, attach[h])]
                  for h in (host_of_rank[r] for r in range(topo.n_ranks))]
        # full-chunk serialization time per link, precomputed with the
        # oracle's exact expression (pl * 8 == chunk_bytes * 8 => same div)
        for lk in links.values():
            lk.ser_chunk = chunk_bytes * 8 / lk.rate_bps
        counters_of = {s: dp.counters for s, dp in self.dataplanes.items()}
        # one lookup per arrival: node -> (kind, payload) where payload is
        # a forward-count cell for switches (untagged L2 forwards bump rx
        # and tx by the same frame count, tallied here and merged into the
        # slow-path-shared SwitchCounters after the loop) and the attached
        # leaf's counters for shadow hosts (its ACK drop accounting)
        fwd_count = {s: [0] for s in counters_of}
        node_info = {}
        for nd, kind in kindof.items():
            if kind == _SWITCH:
                node_info[nd] = (kind, fwd_count[nd])
            elif kind == _HOST:
                node_info[nd] = (kind, None)
            else:
                node_info[nd] = (kind, counters_of[attach[nd]])
        # per-site bucket memos: same-instant events overwhelmingly push
        # to the same future instant (equal rates / equal propagation), so
        # remember the last (time, bucket) per push site. A memo hit can
        # never alias a drained bucket: pushes target t2 >= now, drained
        # buckets have time < now (the active bucket stays in the dict
        # until fully processed, so zero-delay pushes stay correct too).
        m1t = m2t = m3t = m4t = -1.0
        m1b = m2b = m3b = m4b = None
        events = 0
        try:
            while times:
                tcur = pop_t(times)
                if tcur > max_time:
                    break
                self.now = t = tcur
                b = buckets[tcur]
                i = 0
                while True:
                    n = len(b)      # same-instant pushes grow the bucket
                    if i >= n:
                        break
                    for fn, a1, a2 in b[i:n]:
                        if fn is arrive:
                            f = a1
                            node = a2
                            info = node_info[node]
                            kind = info[0]
                            if kind == _SWITCH:
                                if f.tagged:    # mirror path: exact
                                    arrive((f, node))
                                    continue
                                info[1][0] += f.n_frames
                                leaf_dst, nlk = dst_info[f.dst]
                                if node != leaf_dst:
                                    if node in spine_set:
                                        nlk = links[(node, leaf_dst)]
                                    else:
                                        nh = self._route(
                                            node, host_of_rank[f.dst], f)
                                        if nh is None:
                                            self._lost(f)
                                            continue
                                        nlk = links[(node, nh)]
                                pl = f.payload_len
                                # inline _enqueue (drops/dead links exact)
                                if not nlk.up or (
                                        nlk.cap is not None
                                        and nlk.qbytes + pl > nlk.cap):
                                    self._enqueue(nlk, f)
                                    continue
                                nlk.q.append(f)
                                nlk.qbytes += pl
                                if (nlk.qbytes >= nlk.xoff and pfc_enabled
                                        and nlk.cap is not None
                                        and not nlk.sent_xoff):
                                    nlk.sent_xoff = True
                                    for fd in feeders.get(nlk.src, []):
                                        fast_at(t + pause_prop,
                                                self._pause, fd)
                                if nlk.busy or nlk.pause_count:
                                    continue
                                # inline _try_tx; the head IS f (idle +
                                # unpaused means the queue was empty)
                                nlk.busy = True
                                t2 = t + (nlk.ser_chunk
                                          if pl == chunk_bytes
                                          else pl * 8 / nlk.rate_bps)
                                if t2 == m3t:
                                    m3b.append((txdone, nlk, nlk.epoch))
                                else:
                                    b2 = bget(t2)
                                    if b2 is None:
                                        buckets[t2] = b2 = [
                                            (txdone, nlk, nlk.epoch)]
                                        push_t(times, t2)
                                    else:
                                        b2.append((txdone, nlk,
                                                   nlk.epoch))
                                    m3t = t2
                                    m3b = b2
                            elif kind == _HOST:
                                f.t_arrive = t
                                d = t - f.t_send    # inline _stat("ring")
                                nf = f.n_frames
                                lat_ring[0] += nf
                                lat_ring[1] += d * nf
                                if d > lat_ring[2]:
                                    lat_ring[2] = d
                                rank = f.dst        # inline _host_recv
                                g = f.dp_group
                                lr = rank - g * rpg
                                rnd = (lr - f.chunk) % rpg if multi_rank \
                                    else 0
                                dr = done_rounds[rank]
                                pl = f.payload_len
                                if pl == chunk_bytes:
                                    # whole chunk in one frame: the byte
                                    # accumulator can't be partial
                                    if rnd in dr:
                                        continue
                                else:
                                    acc = rx_round[rank]
                                    got = acc.get(rnd, 0) + pl
                                    acc[rnd] = got
                                    if got < chunk_bytes or rnd in dr:
                                        continue
                                dr.add(rnd)
                                left = grl[g] - 1
                                grl[g] = left
                                if left == 0:
                                    group_done[g] = t
                                # round rr-1 received releases send of rr
                                rr = send_next[rank]
                                while rr <= last_round and rr - 1 in dr:
                                    send_next[rank] = rr + 1
                                    if (not simple_send or lr == rpg_m1
                                            or (lr == 0 and rr == 0)):
                                        self._send_round(g, lr, rr)
                                        rr += 1
                                        continue
                                    # inline _send_round: one untagged
                                    # coalesced frame, positional args
                                    sf = Frame(rank,
                                               g * rpg + (lr + 1) % rpg,
                                               0, chunk_bytes,
                                               (lr + 1 - rr) % rpg,
                                               0, 0, False, -1, -1, False,
                                               g, 0, nf0, t)
                                    rr += 1
                                    nlk = access[rank]
                                    # inline _enqueue (host NIC)
                                    if not nlk.up or (
                                            nlk.cap is not None
                                            and nlk.qbytes + chunk_bytes
                                            > nlk.cap):
                                        self._enqueue(nlk, sf)
                                        continue
                                    nlk.q.append(sf)
                                    nlk.qbytes += chunk_bytes
                                    if (nlk.qbytes >= nlk.xoff
                                            and pfc_enabled
                                            and nlk.cap is not None
                                            and not nlk.sent_xoff):
                                        nlk.sent_xoff = True
                                        for fd in feeders.get(nlk.src, []):
                                            fast_at(t + pause_prop,
                                                    self._pause, fd)
                                    if nlk.busy or nlk.pause_count:
                                        continue
                                    # idle + unpaused: the head is sf
                                    nlk.busy = True
                                    t2 = t + nlk.ser_chunk
                                    if t2 == m4t:
                                        m4b.append((txdone, nlk,
                                                    nlk.epoch))
                                        continue
                                    b2 = bget(t2)
                                    if b2 is None:
                                        buckets[t2] = b2 = [
                                            (txdone, nlk, nlk.epoch)]
                                        push_t(times, t2)
                                    else:
                                        b2.append((txdone, nlk,
                                                   nlk.epoch))
                                    m4t = t2
                                    m4b = b2
                            else:
                                f.t_arrive = t
                                d = t - f.t_send   # inline _stat("mirror")
                                nf = f.n_frames
                                lat_mirror[0] += nf
                                lat_mirror[1] += d * nf
                                if d > lat_mirror[2]:
                                    lat_mirror[2] = d
                                self._shadow_recv(node, f)
                                # inline process_ack(): leaf drops the ACK
                                info[1].dropped_acks += 1
                        elif fn is txdone:
                            lk = a1
                            if a2 != lk.epoch:  # killed mid-serialize
                                continue
                            f = lk.q.popleft()
                            lk.qbytes -= f.payload_len
                            lk.busy = False
                            if lk.sent_xoff and lk.qbytes <= lk.xon:
                                lk.sent_xoff = False
                                for fd in feeders.get(lk.src, []):
                                    fast_at(t + pause_prop,
                                            self._resume, fd)
                            t2 = t + lk.prop
                            if t2 == m1t:
                                m1b.append((arrive, f, lk.dst))
                            else:
                                b2 = bget(t2)
                                if b2 is None:
                                    buckets[t2] = b2 = [
                                        (arrive, f, lk.dst)]
                                    push_t(times, t2)
                                else:
                                    b2.append((arrive, f, lk.dst))
                                m1t = t2
                                m1b = b2
                            if lk.q and not lk.pause_count:  # _try_tx
                                lk.busy = True
                                pl = lk.q[0].payload_len
                                t2 = t + (lk.ser_chunk
                                          if pl == chunk_bytes
                                          else pl * 8 / lk.rate_bps)
                                if t2 == m2t:
                                    m2b.append((txdone, lk, lk.epoch))
                                    continue
                                b2 = bget(t2)
                                if b2 is None:
                                    buckets[t2] = b2 = [
                                        (txdone, lk, lk.epoch)]
                                    push_t(times, t2)
                                else:
                                    b2.append((txdone, lk, lk.epoch))
                                m2t = t2
                                m2b = b2
                        else:
                            fn(a1)
                    i = n
                events += i
                del buckets[tcur]
        finally:
            del self._at            # restore the heap-backed method
        for node, cell in fwd_count.items():
            if cell[0]:
                c = counters_of[node]
                c.rx_frames += cell[0]
                c.tx_frames += cell[0]
        self.events = events

    def _result(self) -> FabricResult:
        topo = self.topo
        missing = 0
        ok = True
        for key, nbytes in self.expected.items():
            got = sum(self._cov.get(key, {}).values())
            if got != nbytes:
                ok = False
                missing += 1
        total = SwitchCounters()
        per_switch = {}
        for name, dp in self.dataplanes.items():
            per_switch[name] = dp.counters
            total = total.merge(dp.counters)
        ring_done = len(self.group_done_s) == topo.n_dp_groups
        duration = (max(self.group_done_s.values())
                    if self.group_done_s else self.now)
        gbits = self.chunk_bytes * topo.ranks_per_group * 8
        per_group_bw = [gbits / max(t, 1e-12) / 1e9
                        for t in self.group_done_s.values()]
        algbw = (sum(per_group_bw) / len(per_group_bw)) if per_group_bw \
            else 0.0
        n = topo.ranks_per_group
        lat = {cls: (c, (s / c) if c else 0.0, mx)
               for cls, (c, s, mx) in self._lat.items()}
        link_pfc = {}
        for lk in self.links.values():
            if not lk.pause_events:
                continue
            # flush a still-open pause interval up to the end of the run
            eff = lk.pause_s + (self.now - lk.paused_since
                                if lk.pause_count else 0.0)
            link_pfc[f"{lk.src}->{lk.dst}"] = {
                "pauses": lk.pause_events, "resumes": lk.resume_events,
                "pause_s": eff}
        return FabricResult(
            topology=topo.name, n_ranks=topo.n_ranks,
            n_dp_groups=topo.n_dp_groups, ranks_per_group=n,
            n_shadow=topo.n_shadow, replication_factor=self.rf,
            grad_bytes_per_group=self.chunk_bytes * n,
            duration_s=duration, group_done_s=dict(self.group_done_s),
            ring_completed=ring_done,
            algo_bandwidth_gbps=algbw,
            bus_bandwidth_gbps=algbw * (n - 1) / n if n > 1 else algbw,
            rx_frames=total.rx_frames, tx_frames=total.tx_frames,
            mirrored_frames=total.mirrored_frames,
            tx_over_rx=total.tx_over_rx,
            switch_counters=per_switch,
            shadow_bytes=dict(self.shadow_bytes),
            reassembled_ok=ok and ring_done,
            missing_captures=missing,
            duplicate_mirror_bytes=self.duplicate_mirror_bytes,
            mirror_lost_frames=self.mirror_lost,
            drops=sum(lk.drops for lk in self.links.values()),
            retransmits=self.retransmits, rerouted=self.rerouted,
            pfc_pauses=sum(lk.pause_events for lk in self.links.values()),
            pfc_resumes=sum(lk.resume_events for lk in self.links.values()),
            latency=lat, events=self.events,
            pfc_pause_s=sum(st["pause_s"] for st in link_pfc.values()),
            link_pfc=link_pfc)


def simulate_fabric(n_dp_groups: int, ranks_per_group: int,
                    grad_bytes_per_group: int, *,
                    topology: str | Topology = "rail",
                    n_shadow_nodes: int = 1, link_gbps: float = 100.0,
                    replication_factor: int = 1, n_channels: int = 1,
                    shadow_nics: int = 2, ranks_per_leaf: int = 32,
                    n_spines: int = 2, spine_gbps: float | None = None,
                    pfc: PfcConfig = PfcConfig(), failures=(),
                    frame_quantum: int | None = None,
                    retx_timeout_s: float = 100e-6, max_retx: int = 10,
                    max_time_s: float = 30.0,
                    fast: bool = False) -> FabricResult:
    """Run one multi-DP-group AllGather iteration on a simulated fabric.

    The main entry point for topology/replication sweeps; see the class
    docstring of `FabricSimulator` for per-argument semantics and
    docs/netsim.md for worked examples.
    """
    topo = topology if isinstance(topology, Topology) else build_topology(
        n_dp_groups, ranks_per_group, n_shadow_nodes, topology=topology,
        ranks_per_leaf=ranks_per_leaf, link_gbps=link_gbps,
        spine_gbps=spine_gbps, shadow_nics=shadow_nics, n_spines=n_spines)
    sim = FabricSimulator(
        topo, grad_bytes_per_group=grad_bytes_per_group,
        replication_factor=replication_factor, n_channels=n_channels,
        pfc=pfc, failures=failures, frame_quantum=frame_quantum,
        retx_timeout_s=retx_timeout_s, max_retx=max_retx,
        max_time_s=max_time_s, fast=fast)
    return sim.run()


def sweep_replication(factors, **kw) -> list[FabricResult]:
    """Fig 10 sweep: one fabric run per replication factor."""
    return [simulate_fabric(replication_factor=f, **kw) for f in factors]


def sweep_topology(names, **kw) -> dict:
    """Same workload across topology flavors (rail vs strided vs single)."""
    return {name: simulate_fabric(topology=name, **kw) for name in names}


# ---------------------------------------------------------------------------
# Compatibility wrapper + legacy reference model
# ---------------------------------------------------------------------------

@dataclass
class SimResult:
    n_ranks: int
    total_bytes: int
    duration_s: float
    bus_bandwidth_gbps: float
    algo_bandwidth_gbps: float
    rx_frames: int
    tx_frames: int
    tx_over_rx: float
    mirrored_frames: int
    shadow_bytes: dict
    reassembled_ok: bool
    pfc_pauses: int
    drops: int


def simulate_allgather_replication(
        n_ranks: int,
        grad_bytes: int,
        link_gbps: float = 100.0,
        n_shadow_nodes: int = 1,
        shadow_nics: int = 2,
        shadow_drain_gbps: float | None = None,
        replication_factor: int = 1,
        n_channels: int = 1) -> SimResult:
    """Single-switch, one-DP-group view of the fabric simulator.

    Kept signature-compatible with the original per-round model (whose
    arithmetic survives as `_legacy_simulate_allgather`): frame counters and
    reassembly verdicts are identical; durations now come from the event
    engine instead of the per-round max() approximation.

    grad_bytes: total reduced-gradient bytes (the AllGather payload).
    replication_factor: mirrors per tagged packet (Fig 10 sweeps this).
    shadow_drain_gbps: aggregate shadow access rate (default: one NIC-bonded
        link at ``link_gbps * shadow_nics``, §4.1.1).
    """
    drain = shadow_drain_gbps or (link_gbps * shadow_nics)
    topo = build_topology(1, n_ranks, n_shadow_nodes, topology="single",
                          link_gbps=link_gbps,
                          shadow_nics=max(1, round(drain / link_gbps)))
    # exact drain override (bonded NICs may not divide evenly)
    for (a, b), spec in list(topo.links.items()):
        if a in topo.shadow_hosts or b in topo.shadow_hosts:
            topo.links[(a, b)] = type(spec)(spec.src, spec.dst, drain,
                                            spec.prop_s, spec.nics)
    r = FabricSimulator(topo, grad_bytes_per_group=grad_bytes,
                        replication_factor=replication_factor,
                        n_channels=n_channels).run()
    t = r.duration_s
    algbw = (grad_bytes * 8 / t) / 1e9 if t else 0.0
    return SimResult(
        n_ranks=n_ranks, total_bytes=grad_bytes, duration_s=t,
        bus_bandwidth_gbps=algbw * (n_ranks - 1) / n_ranks,
        algo_bandwidth_gbps=algbw,
        rx_frames=r.rx_frames, tx_frames=r.tx_frames,
        tx_over_rx=r.tx_over_rx, mirrored_frames=r.mirrored_frames,
        shadow_bytes=r.shadow_bytes, reassembled_ok=r.reassembled_ok,
        pfc_pauses=r.pfc_pauses, drops=r.drops)


def _legacy_simulate_allgather(
        n_ranks: int,
        grad_bytes: int,
        link_gbps: float = 100.0,
        n_shadow_nodes: int = 1,
        shadow_nics: int = 2,
        shadow_drain_gbps: float | None = None,
        replication_factor: int = 1,
        n_channels: int = 1) -> SimResult:
    """The original per-round arithmetic model, kept as a regression oracle
    for the event engine's counters (tests/test_fabric.py)."""
    chunk_bytes = grad_bytes // n_ranks
    control = SwitchControlPlane(1, n_ranks, n_shadow_nodes).setup()
    switch = SwitchDataPlane(control)
    shadow_drain_gbps = shadow_drain_gbps or (link_gbps * shadow_nics)

    schedule = {(ev.round, ev.src_rank): ev
                for ev in tag_schedule(n_ranks, n_channels=1,
                                       n_shadow_nodes=n_shadow_nodes)}
    shadow_rx: dict[int, dict] = {n: {} for n in range(n_shadow_nodes)}
    shadow_bytes = {n: 0 for n in range(n_shadow_nodes)}
    pfc = {n: PfcQueue() for n in range(n_shadow_nodes)}

    t = 0.0
    seqs = [0] * max(n_channels, 1)
    rounds = max(n_ranks - 1, 1)
    for rnd in range(rounds):
        # every rank sends one chunk to its neighbour concurrently at line
        # rate
        link_time = chunk_bytes * 8 / (link_gbps * 1e9)
        shadow_round_bytes = {n: 0 for n in range(n_shadow_nodes)}
        for rank in range(n_ranks):
            chunk = chunk_at(rank, rnd, n_ranks)
            tagged = is_tagged(rank, rnd, n_ranks)
            ev = schedule.get((rnd, rank))
            frames = frames_for_chunk(
                rank, (rank + 1) % n_ranks, chunk=chunk, channel=0,
                chunk_bytes=chunk_bytes, start_seq=0, tagged=tagged,
                shadow_seq0=seqs[0] * chunk_bytes if tagged else -1,
                shadow_node=(ev.shadow_node if ev else -1))
            if tagged:
                seqs[0] += 1
            for f in frames:
                out = switch.process(f)
                for g in out[1:]:
                    for _ in range(replication_factor):
                        node = g.shadow_node % n_shadow_nodes
                        pfc[node].offer(g.payload_len)
                        shadow_rx[node].setdefault(g.chunk, 0)
                        shadow_rx[node][g.chunk] += g.payload_len
                        shadow_bytes[node] += g.payload_len
                        shadow_round_bytes[node] += g.payload_len
                switch.counters.tx_frames += \
                    (replication_factor - 1) * (len(out) - 1)
        # round duration: slower of ring link vs shadow drain
        drain_times = [b * 8 / (shadow_drain_gbps * 1e9)
                       for b in shadow_round_bytes.values()] or [0.0]
        round_time = max([link_time] + drain_times)
        for n in range(n_shadow_nodes):
            pfc[n].drain(int(shadow_drain_gbps * 1e9 / 8 * round_time))
        t += round_time

    # reassembly check: every chunk fully received exactly once across nodes
    got: dict[int, int] = {}
    for n, chunks in shadow_rx.items():
        for c, b in chunks.items():
            got[c] = got.get(c, 0) + b
    expected = {c: chunk_bytes * replication_factor for c in range(n_ranks)}
    ok = got == expected

    # bus bandwidth convention (nccl-tests): busbw = algbw * 2(n-1)/n
    # AllGather moves (n-1)/n of the data per rank per phase.
    algbw = (grad_bytes * 8 / t) / 1e9 if t else 0.0
    busbw = algbw * (n_ranks - 1) / n_ranks

    return SimResult(
        n_ranks=n_ranks, total_bytes=grad_bytes, duration_s=t,
        bus_bandwidth_gbps=busbw, algo_bandwidth_gbps=algbw,
        rx_frames=switch.counters.rx_frames,
        tx_frames=switch.counters.tx_frames,
        tx_over_rx=switch.counters.tx_over_rx,
        mirrored_frames=switch.counters.mirrored_frames,
        shadow_bytes=shadow_bytes,
        reassembled_ok=ok,
        pfc_pauses=sum(q.pause_events for q in pfc.values()),
        drops=sum(q.dropped for q in pfc.values()))


# ---------------------------------------------------------------------------
# CLI: topology / replication sweeps
# ---------------------------------------------------------------------------

def _parse_kill(spec: str) -> FailureSpec:
    """"link:leaf0:spine0@120" / "switch:spine1@80" / "shadow_nic:s0@50"
    — the trailing number is the failure time in microseconds."""
    body, _, at = spec.partition("@")
    parts = body.split(":")
    kind = parts[0]
    try:
        at_s = float(at) * 1e-6 if at else 0.0
        if kind == "link":
            return FailureSpec(at_s, "link", (parts[1], parts[2]))
        if kind in ("switch", "shadow_nic"):
            return FailureSpec(at_s, kind, parts[1])
    except (IndexError, ValueError):
        pass
    raise ValueError(
        f"bad --kill spec {spec!r}: expected link:A:B[@US], "
        f"switch:NAME[@US], or shadow_nic:NAME[@US]")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Event-driven gradient-multicast fabric simulator "
                    "(Checkmate §4 / Fig 10); see docs/netsim.md")
    p.add_argument("--ranks", type=int, default=64,
                   help="total training ranks across all DP groups")
    p.add_argument("--dp-groups", type=int, default=2)
    p.add_argument("--shadow-nodes", type=int, default=2)
    p.add_argument("--topology", default="rail",
                   choices=["single", "rail", "leaf-spine"])
    p.add_argument("--ranks-per-leaf", type=int, default=16)
    p.add_argument("--spines", type=int, default=2)
    p.add_argument("--grad-kb", type=int, default=1024,
                   help="reduced-gradient payload per DP group (KiB)")
    p.add_argument("--link-gbps", type=float, default=100.0)
    p.add_argument("--replication", default="1,2,4",
                   help="comma-separated Fig 10 replication factors")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--kill", action="append", default=[],
                   metavar="KIND:TARGET[@US]",
                   help="failure injection, e.g. link:leaf0:spine0@120, "
                        "switch:spine1@80, shadow_nic:s0@50")
    p.add_argument("--fast", action="store_true",
                   help="inlined fast event engine (bit-exact results; "
                        "see docs/netsim.md)")
    args = p.parse_args(argv)

    if args.ranks % args.dp_groups:
        p.error("--ranks must be divisible by --dp-groups")
    rpg = args.ranks // args.dp_groups
    try:
        failures = tuple(_parse_kill(s) for s in args.kill)
    except ValueError as e:
        p.error(str(e))
    factors = [int(x) for x in args.replication.split(",")]

    hdr = (f"{'rf':>3} {'dur_us':>9} {'busbw':>8} {'tx/rx':>6} "
           f"{'pauses':>6} {'drops':>5} {'retx':>5} {'rerte':>5} "
           f"{'lost':>5} {'ok':>3}")
    print(f"# {args.topology}: {args.ranks} ranks, {args.dp_groups} DP "
          f"groups, {args.shadow_nodes} shadow nodes, "
          f"{args.grad_kb} KiB/group"
          + (f", failures={[str(k) for k in args.kill]}" if args.kill
             else ""))
    print(hdr)
    for rf in factors:
        r = simulate_fabric(
            args.dp_groups, rpg, args.grad_kb * 1024,
            topology=args.topology, n_shadow_nodes=args.shadow_nodes,
            link_gbps=args.link_gbps, replication_factor=rf,
            n_channels=args.channels, ranks_per_leaf=args.ranks_per_leaf,
            n_spines=args.spines, failures=failures, fast=args.fast)
        print(f"{rf:>3} {r.duration_s * 1e6:>9.1f} "
              f"{r.bus_bandwidth_gbps:>8.1f} {r.tx_over_rx:>6.3f} "
              f"{r.pfc_pauses:>6} {r.drops:>5} {r.retransmits:>5} "
              f"{r.rerouted:>5} {r.mirror_lost_frames:>5} "
              f"{'y' if r.reassembled_ok else 'N':>3}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
