"""GradientChannel: the delivery API from the capture point to the shadow
apply (paper §4), the port of ``repro.core.channel``.

    channel.open(layout)
    channel.send(StepEvent(...))      # per iteration, capture side
    for d in channel.poll():          # shadow side
        shadow.on_delivery(d)
    channel.close()

Every delivery carries the bucket wire layout (``Delivery.flats``: bucket_id
-> flat buffer on the host) as its payload. The port's training loop packs
the capture on the card and hands the host copies over as
``StepEvent.flats``. A channel that transforms the capture on the card
(``CompressedChannel``, marked by ``device_flats = True``) is handed the
device buckets instead; its dequantized flats cross to the host inside the
inner channel's ``send``. Three implementations:

* ``InProcessChannel``   — adopts the host flats and enqueues them.
* ``PacketizedChannel``  — the paper's dataflow: the flats are laid out in
                           one pinned wire buffer, segmented into MTU frames
                           and pushed through one AllGather iteration of
                           the event-driven fabric simulator
                           (`repro_torch.net.simulator`), whose switches
                           replicate the tagged frames to the shadow hosts;
                           the delivery is reassembled from the frames that
                           arrived. An incomplete capture is a gated
                           ``Delivery`` (``complete=False``).
* ``CompressedChannel``  — wraps either with int8 + error feedback.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Protocol, runtime_checkable

import torch

from repro_torch import obs as _obs
from repro_torch.core.buckets import (TORCH_DTYPES, BucketLayout,
                                      FlatTreeView, alloc_flat, bucket_dtype,
                                      pack_bucket_into)
from repro_torch.core.multicast import assign_buckets
from repro_torch.dist.compression import Compressor
from repro_torch.net.pfc import PfcConfig
from repro_torch.net.planner import build_topology
from repro_torch.net.simulator import FabricSimulator, FailureSpec
from repro_torch.obs.trace import NULL_SPAN

# byte alignment of each bucket's slot in the packetized wire buffer: the
# JAX channel's (``XLA_ALIGN``), so padding, per-group bytes and with them
# every frame count are the reference's; it also keeps every slot aligned
# for the bucket dtype's view
WIRE_ALIGN = 64


@dataclass(frozen=True)
class StepEvent:
    """Everything the capture point knows about one training iteration.

    Args:
        step: 1-based training step the gradients belong to.
        grads: reduced gradients as a leaf tree, or None when ``flats``
            carries them.
        lr: learning rate the training step applied.
        grad_scale: global-norm clipping scale the training step applied.
        iter_time: wall-clock seconds of the iteration.
        state_fn: zero-arg callable giving a host snapshot of the full
            TrainState (the resync path).
        flats: the gradients already in wire layout (bucket_id -> flat
            buffer, on the host, or on the card for a channel with
            ``device_flats``); channels adopt them without a pack.
    """
    step: int
    grads: Optional[dict] = None
    lr: float = 0.0
    grad_scale: float = 1.0
    iter_time: Optional[float] = None
    state_fn: Optional[Callable[[], dict]] = None
    flats: Optional[dict] = None


class Delivery:
    """One iteration's gradients as they arrived on the shadow side.

    ``complete=False`` is a gated delivery: the shadow must not apply it.
    ``grads`` is a lazy leaf view over ``flats``. ``wire_bytes`` is what the
    channel put on the wire (0 in process), ``fabric`` the packetized
    channel's `FabricResult` and ``missing_captures`` its count of mirror
    streams that did not arrive.

    A bucket-sharded transport (``PacketizedChannel(sharded=True)``) also
    reports per-owner verdicts: ``node_complete`` maps each shadow node id
    to whether every bucket it owns arrived whole, and ``missing_buckets``
    maps node id -> tuple of its bucket ids that did not. On a partial
    capture ``complete`` is False but ``flats`` carries the surviving
    owners' buckets (``ShadowCluster.on_delivery(d, nodes=...)``).
    """

    __slots__ = ("step", "lr", "grad_scale", "complete", "missing_captures",
                 "wire_bytes", "fabric", "flats", "layout", "node_complete",
                 "missing_buckets", "_grads")

    def __init__(self, step: int, lr: float, grad_scale: float,
                 complete: bool = True, flats: Optional[dict] = None,
                 layout: Optional[BucketLayout] = None, wire_bytes: int = 0,
                 missing_captures: int = 0, fabric: object = None,
                 node_complete: Optional[dict] = None,
                 missing_buckets: Optional[dict] = None):
        self.step = step
        self.lr = lr
        self.grad_scale = grad_scale
        self.complete = complete
        self.missing_captures = missing_captures
        self.wire_bytes = wire_bytes
        self.fabric = fabric           # FabricResult for packetized transports
        self.flats = flats
        self.layout = layout
        self.node_complete = node_complete      # sharded: node -> bool
        self.missing_buckets = missing_buckets  # sharded: node -> bucket ids
        self._grads = None

    @property
    def grads(self) -> Optional[dict]:
        if self._grads is None and self.flats is not None and self.complete:
            self._grads = FlatTreeView(self.layout, self.flats)
        return self._grads

    def __repr__(self):
        return f"Delivery(step={self.step}, complete={self.complete})"


@dataclass
class FabricTotals:
    """Always-on cumulative wire/fabric account for one channel.

    Native counters updated in place per send (no registry lookups on the
    hot path); `repro_torch.obs.publish.publish_channel` mirrors them into
    labeled metrics once per run.
    """
    sends: int = 0
    gated: int = 0                      # incomplete captures
    wire_bytes: int = 0                 # incl. in-switch replication
    frames_tx: int = 0
    frames_rx: int = 0
    frames_mirrored: int = 0
    drops: int = 0
    retransmits: int = 0
    rerouted: int = 0
    mirror_lost: int = 0
    pfc_pauses: int = 0
    pfc_resumes: int = 0
    pfc_pause_s: float = 0.0            # aggregate link-paused virtual time
    fabric_time_s: float = 0.0          # simulated time consumed
    link_pfc: dict = field(default_factory=dict)   # per-link pause account

    def absorb(self, result, wire_bytes: int):
        """Fold one ``FabricResult`` into the running totals."""
        self.sends += 1
        if not result.reassembled_ok:
            self.gated += 1
        self.wire_bytes += wire_bytes
        self.frames_tx += result.tx_frames
        self.frames_rx += result.rx_frames
        self.frames_mirrored += result.mirrored_frames
        self.drops += result.drops
        self.retransmits += result.retransmits
        self.rerouted += result.rerouted
        self.mirror_lost += result.mirror_lost_frames
        self.pfc_pauses += result.pfc_pauses
        self.pfc_resumes += result.pfc_resumes
        self.pfc_pause_s += result.pfc_pause_s
        self.fabric_time_s += result.duration_s
        for link, st in result.link_pfc.items():
            agg = self.link_pfc.setdefault(
                link, {"pauses": 0, "resumes": 0, "pause_s": 0.0})
            agg["pauses"] += st["pauses"]
            agg["resumes"] += st["resumes"]
            agg["pause_s"] += st["pause_s"]


@runtime_checkable
class GradientChannel(Protocol):
    """Transport between the capture point and the shadow plane. ``send``
    returns the sender-visible stall seconds; work the transport does off
    the sender's critical path (in-switch replication, wire propagation,
    reassembly) is not stall, and the fabric's virtual-time account lives
    in ``Delivery.fabric``."""
    name: str

    def open(self, layout: BucketLayout) -> None: ...

    def send(self, event: StepEvent) -> float: ...

    def poll(self) -> list[Delivery]: ...

    def close(self) -> None: ...


def _flats_from_event(layout: BucketLayout, event: StepEvent) -> dict:
    """The event's payload in wire layout: ``event.flats`` as is, else the
    leaf tree packed once into fresh buffers on its own device."""
    if event.flats is not None:
        return event.flats
    if event.grads is None:
        raise ValueError("a channel carries gradients: the event has none")
    out = {}
    for b in layout.buckets:
        dev = event.grads[b.slots[0].name].device
        out[b.bucket_id] = pack_bucket_into(
            b, event.grads, alloc_flat(b.size, bucket_dtype(b), dev))
    return out


def to_host(flats: dict) -> dict:
    """Flat buffers on the host: each one on the card is copied once into
    fresh pinned memory (a shadow may still hold the previous step's) and
    the copies are awaited; host buffers are adopted as they are."""
    out, streams = {}, set()
    for bid, t in flats.items():
        if t.device.type == "cpu":
            out[bid] = t
            continue
        host = alloc_flat(t.numel(), t.dtype, "cpu", pin=True)
        host.copy_(t, non_blocking=True)
        out[bid] = host
        streams.add(torch.cuda.current_stream(t.device))
    for st in streams:
        st.synchronize()
    return out


class InProcessChannel:
    """In-process hand-off in wire layout: ``send`` adopts (or packs once)
    the per-bucket flat buffers, brings any on the card to the host, and
    enqueues them by reference.

    The pack and the copy are charged as sender stall (the ``send``
    stage): in process, the wire-format copy is work the sending thread
    performs.
    """
    name = "inprocess"

    def __init__(self):
        self._layout: Optional[BucketLayout] = None
        self._pending: list[Delivery] = []
        self.last_send_parts: dict = {}

    def open(self, layout):
        self._layout = layout

    def send(self, event: StepEvent) -> float:
        if self._layout is None:
            raise RuntimeError("open() before send()")
        ob = _obs.get()
        t0 = time.perf_counter()
        with ob.tracer.span("channel.send", args={"step": event.step,
                                                  "channel": self.name}):
            # a pack of the channel's own only where the event brings the
            # leaf tree; packed flats were packed (and timed) by the capture
            with (ob.tracer.span("bucket.pack", args={"step": event.step})
                  if event.flats is None else NULL_SPAN):
                flats = to_host(_flats_from_event(self._layout, event))
            self._pending.append(Delivery(
                step=event.step, lr=event.lr, grad_scale=event.grad_scale,
                flats=flats, layout=self._layout, complete=True))
        dt = time.perf_counter() - t0
        self.last_send_parts = {"send": dt}
        ob.metrics.counter("channel_sends_total", "Gradient sends").inc(
            1, channel=self.name)
        return dt

    def poll(self) -> list[Delivery]:
        out, self._pending = self._pending, []
        return out

    def close(self):
        self._pending.clear()


def wire_geometry(layout: BucketLayout, dtypes: tuple, n_dp_groups: int,
                  ranks_per_group: int) -> tuple[list[tuple], int, int]:
    """The packetized wire buffer for per-bucket payload ``dtypes`` (torch
    dtypes): ``([(dtype, size, nbytes, offset), ...], bytes per DP group,
    total bytes)``. Each bucket's slot starts `WIRE_ALIGN`-aligned, and the
    buffer is padded to split evenly into ``n_dp_groups`` payloads of
    ``ranks_per_group`` whole chunks each."""
    metas, cum = [], 0
    for b, dt in zip(layout.buckets, dtypes):
        nbytes = b.size * dt.itemsize
        cum = -(-cum // WIRE_ALIGN) * WIRE_ALIGN
        metas.append((dt, b.size, nbytes, cum))
        cum += nbytes
    n_g, rpg = n_dp_groups, ranks_per_group
    per = -(-max(cum, n_g * rpg) // (n_g * rpg)) * rpg
    return metas, per, per * n_g


def _pin() -> bool:
    """Page-locked wire buffers wherever a card can copy to and from them."""
    return torch.cuda.is_available()


def _canon_topology(name: str) -> str:
    aliases = {"rail-optimized": "rail", "rail": "rail",
               "strided": "leaf-spine", "leaf-spine": "leaf-spine",
               "single": "single"}
    if name not in aliases:
        raise ValueError(f"unknown topology {name!r}; "
                         f"expected one of {sorted(set(aliases))}")
    return aliases[name]


class PacketizedChannel:
    """Deliver gradients through the event-driven fabric simulator.

    Per ``send``: the capture's buckets are laid out in one pinned wire
    buffer (each slot `WIRE_ALIGN`-aligned), split across DP groups,
    segmented into MTU frames and pushed through one AllGather iteration of
    `repro_torch.net.simulator.FabricSimulator` — boundary-rank frames are
    DSCP-tagged, the ingress leaf's match-action table replicates them
    toward the shadow hosts, and the channel reassembles the capture from
    the frames that actually arrived (the simulator's frame-level
    injection and extraction hooks slice the real bytes).

    The wire buffer is allocated once per geometry and reused: its bytes are
    consumed inside ``sim.run()``. The rx buffer is fresh per send, because
    the delivery's flats are views of it for as long as a shadow node holds
    them; both come from the pinned host allocator on a machine with a
    card, which recycles the rx block once the delivery is released.
    Buckets on the card (a `CompressedChannel`'s dequantized flats) are
    copied straight into their wire slots; host flats are copied there; a
    leaf tree is packed there.

    Args:
        topology: "rail-optimized" (alias "rail"), "leaf-spine" (alias
            "strided"), or "single" — see `repro_torch.net.planner`.
        n_dp_groups / ranks_per_group: fabric workload shape; the wire
            buffer is split evenly across groups.
        n_shadow_nodes: shadow hosts on the fabric (transport view; the
            `ShadowCluster` node count is independent).
        replication_factor / n_channels / link_gbps / ranks_per_leaf /
            n_spines / shadow_nics / pfc / frame_quantum: forwarded to the
            simulator (see `FabricSimulator`).
        failures_at: ``{step: failures}`` fabric failure injection; each
            entry fires once. ``failures`` is a `FailureSpec` sequence, or
            the string ``"capture"`` — cut every shadow NIC at t=0, so the
            ring completes but that step's capture is lost.
        sharded: bucket-sharded shadow plane — each shadow node owns the
            byte-balanced bucket subset `assign_buckets` gives it, the
            fabric routes every bucket's frames only to its owner, and
            deliveries carry per-owner ``node_complete`` /
            ``missing_buckets`` verdicts plus partial flats for the
            surviving owners.
        shadow_rails: shadow-rail leaf count (`repro_torch.net.planner`).
        fast: run each send on the simulator's calendar-queue engine
            (bit-identical to the per-frame one).
    """
    name = "packetized"

    def __init__(self, *, topology: str = "rail-optimized",
                 n_dp_groups: int = 1, ranks_per_group: int = 4,
                 n_shadow_nodes: int = 2, replication_factor: int = 1,
                 n_channels: int = 1, link_gbps: float = 100.0,
                 ranks_per_leaf: int = 32, n_spines: int = 2,
                 shadow_nics: int = 2, pfc=None,
                 frame_quantum: Optional[int] = None,
                 failures_at: Optional[dict] = None,
                 sharded: bool = False, shadow_rails: int = 1,
                 fast: bool = False):
        self.topology = _canon_topology(topology)
        self.n_dp_groups = n_dp_groups
        self.ranks_per_group = ranks_per_group
        self.n_shadow_nodes = n_shadow_nodes
        self.replication_factor = replication_factor
        self.n_channels = n_channels
        self.link_gbps = link_gbps
        self.ranks_per_leaf = ranks_per_leaf
        self.n_spines = n_spines
        self.shadow_nics = shadow_nics
        self.pfc = pfc
        self.frame_quantum = frame_quantum
        self.failures_at = dict(failures_at or {})
        self.sharded = sharded
        self.shadow_rails = shadow_rails
        self.fast = fast
        self.dead_shadow_nodes: set[int] = set()
        self._owners: Optional[dict] = None   # bucket_id -> owner node
        self._route_starts: list[int] = []    # owner step fn over total buf
        self._route_owners: list[int] = []
        self._bucket_spans: list[tuple] = []  # (bid, start, nbytes, owner)
        self._layout: Optional[BucketLayout] = None
        self._topo = None
        self._pending: list[Delivery] = []
        self._wire_dtypes: tuple = ()
        self._metas: list[tuple] = []         # (dtype, size, nbytes, offset)
        self._per = 0                         # padded bytes per DP group
        self._total = 0                       # wire buffer size
        self._src_buf: Optional[torch.Tensor] = None
        self._src_views: list[torch.Tensor] = []
        self.totals = FabricTotals()
        self.last_send_parts: dict = {}

    def open(self, layout):
        self._layout = layout
        if self.sharded:
            self._owners = assign_buckets(layout, self.n_shadow_nodes)
        self._topo = build_topology(
            self.n_dp_groups, self.ranks_per_group, self.n_shadow_nodes,
            topology=self.topology, ranks_per_leaf=self.ranks_per_leaf,
            link_gbps=self.link_gbps, shadow_nics=self.shadow_nics,
            n_spines=self.n_spines, shadow_rails=self.shadow_rails)
        self._set_wire_geometry(tuple(TORCH_DTYPES[bucket_dtype(b)]
                                      for b in layout.buckets))

    def _set_wire_geometry(self, dtypes: tuple):
        """(Re)derive the wire-buffer geometry for per-bucket payload
        ``dtypes`` (torch dtypes) and allocate the reusable tx buffer.

        The wire carries what the payload is (a `CompressedChannel`'s f32
        stand-in over a narrower layout is never downcast); the geometry is
        `wire_geometry`'s, so the delivery's rx views are dtype views of
        the rx buffer.
        """
        self._wire_dtypes = dtypes
        self._metas, self._per, self._total = wire_geometry(
            self._layout, dtypes, self.n_dp_groups, self.ranks_per_group)
        self._src_buf = self._src_views = None      # free the old one first
        self._src_buf = alloc_flat(self._total, torch.uint8, pin=_pin())
        self._src_views = [self._src_buf[ofs:ofs + nbytes].view(dt)
                           for dt, _, nbytes, ofs in self._metas]
        if self.sharded and self._owners is not None:
            self._shard_geometry()

    def _shard_geometry(self):
        """Derive the owner step-function and per-bucket byte spans over
        the total wire buffer (offsets move when wire dtypes change, so
        this re-runs with ``_set_wire_geometry``)."""
        starts: list[int] = []
        owners: list[int] = []
        spans: list[tuple] = []
        for b, (_dt, _size, nbytes, ofs) in zip(self._layout.buckets,
                                                self._metas):
            o = self._owners[b.bucket_id]
            spans.append((b.bucket_id, ofs, nbytes, o))
            if not owners or o != owners[-1]:
                starts.append(ofs)
                owners.append(o)
        # leading byte 0 and the trailing padding keep their neighbours'
        # owner (padding has no data; its routing just needs to be total)
        starts[0] = 0
        self._route_starts = starts
        self._route_owners = owners
        self._bucket_spans = spans

    def _owner_at(self, off: int) -> int:
        """Shadow node owning total-buffer byte ``off`` (simulator's
        ``shadow_route``)."""
        return self._route_owners[
            bisect.bisect_right(self._route_starts, off) - 1]

    def _node_accounting(self, node_cov: dict, ring_done: bool):
        """Per-owner capture verdicts from the per-node coverage maps.

        ``node_cov``: ``(node_id, replica) -> {total_off: max bytes}`` of
        mirror payloads that actually arrived. Clips every covered span to
        the bucket data spans (wire padding doesn't count), then calls a
        bucket complete when every replica covered all of its bytes.
        """
        starts = [s for _, s, _, _ in self._bucket_spans]
        got: dict[tuple, int] = {}             # (bucket_id, replica) -> B
        for (_nid, rep), seen in node_cov.items():
            for off, ln in seen.items():
                while ln > 0:
                    i = bisect.bisect_right(starts, off) - 1
                    if i < 0:
                        break
                    bid, s, nb, _o = self._bucket_spans[i]
                    end = s + nb
                    if off >= end:             # padding gap: skip ahead
                        if i + 1 >= len(self._bucket_spans):
                            break
                        skip = min(ln, self._bucket_spans[i + 1][1] - off)
                        off += skip
                        ln -= skip
                        continue
                    take = min(ln, end - off)
                    key = (bid, rep)
                    got[key] = got.get(key, 0) + take
                    off += take
                    ln -= take
        rf = self.replication_factor
        missing: dict[int, list] = {n: [] for n in range(self.n_shadow_nodes)}
        for bid, _s, nb, owner in self._bucket_spans:
            if not all(got.get((bid, rep), 0) >= nb for rep in range(rf)):
                missing[owner].append(bid)
        node_complete = {n: ring_done and not missing[n]
                         for n in range(self.n_shadow_nodes)}
        return node_complete, {n: tuple(m) for n, m in missing.items()}

    def kill_shadow_node(self, node_id: int):
        """Persistently cut shadow node ``node_id``'s access NIC: every
        subsequent send loses the frames routed to it, so its buckets stay
        missing until ``revive_all`` (hardware replaced + resync)."""
        if not 0 <= node_id < self.n_shadow_nodes:
            raise ValueError(f"shadow node {node_id} out of range "
                             f"[0, {self.n_shadow_nodes})")
        self.dead_shadow_nodes.add(node_id)

    def revive_all(self):
        """Forget all shadow-node deaths (replacement hardware racked)."""
        self.dead_shadow_nodes.clear()

    def _failures_for(self, step: int):
        # dead shadow nodes stay dead: each send re-cuts their NICs at t=0
        # (every send builds a fresh simulator over the static topology)
        dead = tuple(FailureSpec(0.0, "shadow_nic", n)
                     for n in sorted(self.dead_shadow_nodes))
        spec = self.failures_at.pop(step, None)      # each failure fires once
        if spec is None:
            return dead
        if spec == "capture":
            return dead + tuple(FailureSpec(0.0, "shadow_nic", h)
                                for h in self._topo.shadow_hosts)
        if isinstance(spec, FailureSpec):
            return dead + (spec,)
        return dead + tuple(spec)

    def _fill(self, event: StepEvent):
        """The event's payload into the wire buffer, one copy per bucket:
        host flats by a host copy, flats on the card by a device-to-host
        copy (all awaited before returning), a leaf tree packed in place
        (on the card: into a device buffer first)."""
        buckets = self._layout.buckets
        if event.flats is not None:
            dtypes = tuple(event.flats[b.bucket_id].dtype for b in buckets)
        elif event.grads is not None:
            # the wire carries the gradient dtype, which may differ from
            # the param layout's
            dtypes = tuple(functools.reduce(
                torch.promote_types,
                [event.grads[s.name].dtype for s in b.slots])
                for b in buckets)
        else:
            raise ValueError("a channel carries gradients: the event has none")
        if dtypes != self._wire_dtypes:      # e.g. f32 dequantized stream
            self._set_wire_geometry(dtypes)
        streams = set()
        for b, dst in zip(buckets, self._src_views):
            if event.flats is not None:
                src = event.flats[b.bucket_id]
            else:
                dev = event.grads[b.slots[0].name].device
                src = (dst if dev.type == "cpu"
                       else alloc_flat(b.size, dst.dtype, dev))
                pack_bucket_into(b, event.grads, src)
                if src is dst:
                    continue
            if src.device.type == "cuda":
                dst.copy_(src, non_blocking=True)
                streams.add(torch.cuda.current_stream(src.device))
            else:
                dst.copy_(src)
        for st in streams:
            st.synchronize()

    def send(self, event: StepEvent) -> float:
        if self._layout is None:
            raise RuntimeError("open() before send()")
        ob = _obs.get()
        with ob.tracer.span("channel.send", args={"step": event.step,
                                                  "channel": self.name}):
            with ob.tracer.span("bucket.pack", args={"step": event.step}):
                self._fill(event)
            self._pending.append(self._transmit(event, ob))
        # Zero sender-visible stall (§4 zero-overhead claim): the gradient
        # frames ride the ring AllGather training performs anyway, and
        # replication happens in-switch. The event loop is simulation cost
        # on this host; its virtual-time account is Delivery.fabric.
        self.last_send_parts = {"send": 0.0}
        return 0.0

    def _transmit(self, event: StepEvent, ob) -> Delivery:
        """One AllGather iteration of the wire buffer through the fabric;
        the delivery reassembled from the mirror frames that arrived."""
        buckets = self._layout.buckets
        per, total = self._per, self._total
        src = memoryview(self._src_buf.numpy())
        rx_t = alloc_flat(total, torch.uint8, pin=_pin())
        rx = memoryview(rx_t.numpy())

        sim = FabricSimulator(
            self._topo, grad_bytes_per_group=per,
            replication_factor=self.replication_factor,
            n_channels=self.n_channels,
            pfc=self.pfc if self.pfc is not None else PfcConfig(),
            failures=self._failures_for(event.step),
            frame_quantum=self.frame_quantum,
            shadow_route=self._owner_at if self.sharded else None,
            shadow_cuts=self._route_starts[1:] if self.sharded else (),
            fast=self.fast)

        def frame_tx(f):                     # injection: slice real bytes in
            off = f.dp_group * per + sim.wire_offset(f)
            f.payload = src[off:off + f.payload_len]

        node_cov: dict = {}   # sharded: (node, replica) -> {total_off: B}

        def shadow_rx(node_id, f):           # extraction: reassemble capture
            off = f.dp_group * per + sim.wire_offset(f)
            rx[off:off + f.payload_len] = f.payload
            if self.sharded:
                seen = node_cov.setdefault((node_id, f.replica), {})
                seen[off] = max(seen.get(off, 0), f.payload_len)

        sim.frame_tx_hook = frame_tx
        sim.shadow_rx_hook = shadow_rx
        rx_frames: list[tuple] = []
        if ob.tracer.enabled:
            # per-frame fabric traversal on the simulated-time tracks:
            # record each mirror delivery (node, virtual tx/arrive times)
            def traced_rx(node_id, f, _inner=shadow_rx):
                _inner(node_id, f)
                rx_frames.append((node_id, f.dp_group, f.chunk, f.replica,
                                  f.t_send, f.t_arrive, f.n_frames,
                                  f.payload_len))
            sim.shadow_rx_hook = traced_rx
        with ob.tracer.span("fabric.simulate", args={"step": event.step}):
            result = sim.run()
        # the hooks close over the simulator (a reference cycle) and the rx
        # buffer: unhooked, the rx block goes back to the pinned allocator
        # when the delivery is released, not at the next full collection
        sim.frame_tx_hook = sim.shadow_rx_hook = None
        if ob.tracer.enabled:
            tr = ob.tracer
            tr.fabric_span(f"allgather step{event.step}", 0.0,
                           result.duration_s, track="fabric",
                           args={"step": event.step,
                                 "events": result.events,
                                 "reassembled_ok": result.reassembled_ok})
            for nid, dp, chunk, rep, t_tx, t_rx, nf, pl in rx_frames:
                tr.fabric_span(f"g{dp}c{chunk}r{rep}", t_tx, t_rx,
                               track=f"shadow{nid}.rx",
                               args={"step": event.step, "frames": nf,
                                     "bytes": pl})
            tr.fabric_advance(result.duration_s)

        # FabricTotals is this channel's single metrics source, mirrored
        # into the registry once per run by publish_channel
        self.totals.absorb(result, total * self.replication_factor)

        node_complete = missing_buckets = None
        if self.sharded:
            node_complete, missing_buckets = self._node_accounting(
                node_cov, result.ring_completed)

        flats = None
        if result.reassembled_ok:
            # the delivery's flats ARE the rx buffer: per-bucket dtype views
            # which keep rx_t alive
            flats = {b.bucket_id: rx_t[ofs:ofs + nbytes].view(dt)
                     for b, (dt, _, nbytes, ofs) in zip(buckets, self._metas)}
        elif node_complete is not None and any(node_complete.values()):
            # partial capture: the surviving owners' buckets are whole —
            # ship them so the live shard of the shadow can stay current
            flats = {b.bucket_id: rx_t[ofs:ofs + nbytes].view(dt)
                     for b, (dt, _, nbytes, ofs) in zip(buckets, self._metas)
                     if node_complete[self._owners[b.bucket_id]]}
        return Delivery(
            step=event.step, lr=event.lr, grad_scale=event.grad_scale,
            flats=flats, layout=self._layout,
            complete=result.reassembled_ok,
            missing_captures=result.missing_captures,
            wire_bytes=total * self.replication_factor, fabric=result,
            node_complete=node_complete, missing_buckets=missing_buckets)

    def poll(self) -> list[Delivery]:
        out, self._pending = self._pending, []
        return out

    def close(self):
        self._pending.clear()
        self._topo = None
        self._src_buf = None
        self._src_views = []


class CompressedChannel:
    """Wrap a channel with int8 + error-feedback gradient compression.

    ``send`` quantizes the flat buckets in one pass
    (`repro_torch.dist.compression.Compressor.compress_flats`, residuals
    carried across iterations as flat buffers in the same layout) and
    forwards the *dequantized* flats to the inner channel — what a
    compressed multicast payload delivers. The shadow replica therefore
    tracks the compressed stream.

    ``device_flats``: the training loop hands this channel the capture's
    device buckets, so the quantize runs on the card and its residuals
    stay there; the inner channel's send then copies the dequantized f32
    flats to the host. The quantize is charged as the ``quantize`` stage,
    the inner channel's send as its own parts. ``Delivery.wire_bytes``
    reports the compressed payload (int8 + one f32 scale per leaf).
    """
    name = "compressed"
    device_flats = True

    def __init__(self, inner: Optional[GradientChannel] = None):
        self.inner: GradientChannel = (inner if inner is not None
                                       else InProcessChannel())
        self.compressor = Compressor()
        self.name = f"compressed[{self.inner.name}]"
        self._layout: Optional[BucketLayout] = None
        self._sent_bytes: dict[int, int] = {}
        self.last_send_parts: dict = {}

    def open(self, layout):
        self._layout = layout
        self.inner.open(layout)

    def send(self, event: StepEvent) -> float:
        if self._layout is None:
            raise RuntimeError("open() before send()")
        ob = _obs.get()
        t0 = time.perf_counter()
        with ob.tracer.span("channel.quantize", args={"step": event.step}):
            before = self.compressor.wire_bytes_total
            flats = _flats_from_event(self._layout, event)  # pack once
            deq = self.compressor.compress_flats(self._layout, flats)
            for dev in {t.device for t in deq.values()
                        if t.device.type == "cuda"}:
                torch.cuda.current_stream(dev).synchronize()
        self._sent_bytes[event.step] = (self.compressor.wire_bytes_total
                                        - before)
        stall = time.perf_counter() - t0
        inner_stall = self.inner.send(
            dataclasses.replace(event, grads=None, flats=deq))
        # quantize + the inner channel's own decomposition, whose in-order
        # sum is its stall
        self.last_send_parts = {
            "quantize": stall,
            **dict(getattr(self.inner, "last_send_parts", None)
                   or {"send": float(inner_stall or 0.0)})}
        ob.metrics.counter("channel_wire_bytes_total",
                           "Bytes put on the wire (incl. replication)").inc(
            self._sent_bytes[event.step], channel="compressed")
        return stall + inner_stall

    def poll(self) -> list[Delivery]:
        out = self.inner.poll()
        for d in out:
            d.wire_bytes = self._sent_bytes.pop(d.step, d.wire_bytes)
        return out

    def kill_shadow_node(self, node_id: int):
        """Forward a shadow-node death to the inner transport."""
        self.inner.kill_shadow_node(node_id)

    def revive_all(self):
        fn = getattr(self.inner, "revive_all", None)
        if fn is not None:
            fn()

    def close(self):
        self._sent_bytes.clear()
        self.inner.close()
