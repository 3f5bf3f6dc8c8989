"""GradientChannel: the delivery API from the capture point to the shadow
apply (paper §4), the port's ``StepEvent``, ``Delivery``, protocol and
``InProcessChannel``.

    channel.open(layout)
    channel.send(StepEvent(...))      # per iteration, capture side
    for d in channel.poll():          # shadow side
        shadow.on_delivery(d)
    channel.close()

Every delivery carries the bucket wire layout (``Delivery.flats``: bucket_id
-> flat buffer) as its payload. The port's training loop packs the capture
on the card and hands the host copies over as ``StepEvent.flats``, which
the channel adopts as they are.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Protocol, runtime_checkable

from repro_torch.core.buckets import (BucketLayout, FlatTreeView, alloc_flat,
                                      bucket_dtype, pack_bucket_into)


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
            host buffer); channels adopt them without a pack.
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
    ``grads`` is a lazy leaf view over ``flats``.
    """

    __slots__ = ("step", "lr", "grad_scale", "complete", "flats", "layout",
                 "_grads")

    def __init__(self, step: int, lr: float, grad_scale: float,
                 complete: bool = True, flats: Optional[dict] = None,
                 layout: Optional[BucketLayout] = None):
        self.step = step
        self.lr = lr
        self.grad_scale = grad_scale
        self.complete = complete
        self.flats = flats
        self.layout = layout
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


class InProcessChannel:
    """In-process hand-off in wire layout: ``send`` adopts (or packs once)
    the per-bucket flat buffers and enqueues them by reference."""
    name = "inprocess"

    def __init__(self):
        self._layout: Optional[BucketLayout] = None
        self._pending: list[Delivery] = []

    def open(self, layout):
        self._layout = layout

    def send(self, event: StepEvent) -> float:
        if self._layout is None:
            raise RuntimeError("open() before send()")
        t0 = time.perf_counter()
        flats = _flats_from_event(self._layout, event)
        self._pending.append(Delivery(
            step=event.step, lr=event.lr, grad_scale=event.grad_scale,
            flats=flats, layout=self._layout, complete=True))
        return time.perf_counter() - t0

    def poll(self) -> list[Delivery]:
        out, self._pending = self._pending, []
        return out

    def close(self):
        self._pending.clear()
