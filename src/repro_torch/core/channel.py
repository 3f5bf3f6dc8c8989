"""GradientChannel: the delivery API from the capture point to the shadow
apply (paper §4), the port's ``StepEvent``, ``Delivery``, protocol,
``InProcessChannel`` and ``CompressedChannel``.

    channel.open(layout)
    channel.send(StepEvent(...))      # per iteration, capture side
    for d in channel.poll():          # shadow side
        shadow.on_delivery(d)
    channel.close()

Every delivery carries the bucket wire layout (``Delivery.flats``: bucket_id
-> flat buffer on the host) as its payload. The port's training loop packs
the capture on the card and hands the host copies over as
``StepEvent.flats``, which the channel adopts as they are. A channel that
transforms the capture on the card (``CompressedChannel``, marked by
``device_flats = True``) is handed the device buckets instead; its
dequantized flats cross to the host inside the inner channel's ``send``.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable, Optional, Protocol, runtime_checkable

import torch

from repro_torch import obs as _obs
from repro_torch.core.buckets import (BucketLayout, FlatTreeView, alloc_flat,
                                      bucket_dtype, pack_bucket_into)
from repro_torch.dist.compression import Compressor


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
    ``grads`` is a lazy leaf view over ``flats``. ``wire_bytes`` is the
    payload a compressed channel put on the wire (0 in process).
    """

    __slots__ = ("step", "lr", "grad_scale", "complete", "flats", "layout",
                 "wire_bytes", "_grads")

    def __init__(self, step: int, lr: float, grad_scale: float,
                 complete: bool = True, flats: Optional[dict] = None,
                 layout: Optional[BucketLayout] = None, wire_bytes: int = 0):
        self.step = step
        self.lr = lr
        self.grad_scale = grad_scale
        self.complete = complete
        self.flats = flats
        self.layout = layout
        self.wire_bytes = wire_bytes
        self._grads = None

    @property
    def grads(self) -> Optional[dict]:
        if self._grads is None and self.flats is not None and self.complete:
            self._grads = FlatTreeView(self.layout, self.flats)
        return self._grads

    def __repr__(self):
        return f"Delivery(step={self.step}, complete={self.complete})"


@runtime_checkable
class GradientChannel(Protocol):
    """Transport between the capture point and the shadow plane. ``send``
    returns the sender-visible stall seconds."""
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
            with ob.tracer.span("bucket.pack", args={"step": event.step}):
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
