"""Checkpointers: Checkmate and the copy-persist baselines the paper
compares against (§2.2, §6.2), the port of ``repro.core.checkpoint``.

All baselines do *real* work (a device-to-host snapshot, host clones, an
in-memory persist), so their stalls are what a copy-then-persist
checkpointer costs the trainer:

  * ``SyncCheckpointer``       — pause; copy + persist inline (worst case)
  * ``AsyncCheckpointer``      — copy inline, persist on a background thread;
                                 blocks if the previous persist is unfinished
                                 (the unbounded-memory guard the paper cites)
  * ``ShardedAsyncCheckpointer`` — Torch-DCP-like: each of N nodes handles 1/N
  * ``GeminiLikeCheckpointer`` — checkpoint to remote CPU memory over the
                                 training network; stall = transfer time not
                                 hidden by the per-iteration overlap budget
  * ``CheckFreqCheckpointer``  — async + profiling that tunes frequency so
                                 overhead stays under a target fraction
  * ``CheckmateCheckpointer``  — sends the already-captured gradients
                                 through a `GradientChannel` to the shadow
                                 cluster

The training loop calls ``on_step(event)`` every iteration with one frozen
`StepEvent` and adds the returned stall seconds to its critical path. Every
checkpointer books its stall into an ordered per-stage ledger
(``stall_stages``, stage names from `repro_torch.obs.stalls`), and
``stall_total`` is the in-order sum of that ledger.
"""
from __future__ import annotations

import io
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core.channel import (GradientChannel, InProcessChannel,
                                      StepEvent)
from repro_torch.core.shadow import ShadowCluster, ShadowNodeLoss


def _flatten_state(state: dict) -> list[torch.Tensor]:
    """The snapshot's leaves in dict order (the step as a 0-d int64)."""
    out = []
    for v in state.values():
        if isinstance(v, dict):
            out.extend(_flatten_state(v))
        else:
            out.append(torch.as_tensor(v))
    return out


def _persist(leaves: list[torch.Tensor], sink: io.BytesIO):
    """Write every leaf's bytes into ``sink`` (a bf16 leaf too: through a
    uint8 view, since numpy has no bfloat16)."""
    sink.seek(0)
    for t in leaves:
        sink.write(t.contiguous().reshape(-1).view(torch.uint8).numpy())


class BaseCheckpointer:
    name = "base"
    # whether on_step reads the captured gradients: the loop skips the
    # capture's pack and device-to-host copy for everyone else (the
    # copy-persist baselines read state_fn snapshots instead)
    consumes_grads = False
    # the stage this checkpointer's whole stall is booked to, unless
    # _checkpoint stages a finer breakdown in self._parts
    stage = "copy-persist"

    def __init__(self, freq: int = 1):
        self.freq = max(1, freq)
        self.n_checkpoints = 0
        self.skipped_captures = 0
        # ordered stall ledger: stage -> booked seconds, in first-booked
        # order; stall_total is its in-order sum, so the attribution sums
        # bit-exactly to the total
        self.stall_stages: dict[str, float] = {}
        self._parts: Optional[dict] = None
        self._latest: Optional[dict] = None

    @property
    def stall_total(self) -> float:
        total = 0.0
        for sec in self.stall_stages.values():
            total += sec
        return total

    def _book(self, stage: str, seconds: float):
        self.stall_stages[stage] = (self.stall_stages.get(stage, 0.0)
                                    + seconds)

    def on_step(self, event: StepEvent) -> float:
        """Consume one iteration; returns stall seconds. A gated capture
        (``_checkpoint`` returning False) is counted in
        ``skipped_captures``: it is no checkpoint and books no stall."""
        if event.step % self.freq != 0:
            return 0.0
        ob = _obs.get()
        t0 = time.perf_counter()
        self._parts = None
        with ob.tracer.span("checkpoint.on_step", track="checkpoint",
                            args={"step": event.step, "ck": self.name}):
            captured = self._checkpoint(event)
        if captured is False:
            self.skipped_captures += 1
            return 0.0
        stall = (captured if isinstance(captured, float)
                 else time.perf_counter() - t0)
        parts = self._parts if self._parts is not None else {self.stage: stall}
        for part_stage, sec in parts.items():
            self._book(part_stage, sec)
        self.n_checkpoints += 1
        return stall

    def _checkpoint(self, event: StepEvent):
        """Perform one capture; return False if it was gated, or a float to
        charge that exact stall instead of the wall time of this call."""
        raise NotImplementedError

    def restore(self) -> Optional[dict]:
        return self._latest

    def finalize(self):
        pass


class NoCheckpointer(BaseCheckpointer):
    name = "no_checkpoint"

    def on_step(self, event: StepEvent) -> float:
        return 0.0


class SyncCheckpointer(BaseCheckpointer):
    name = "sync"

    def __init__(self, freq: int = 1):
        super().__init__(freq)
        self._sink = io.BytesIO()

    def _checkpoint(self, event: StepEvent):
        state = event.state_fn()                 # device -> host copy
        leaves = [t.clone() for t in _flatten_state(state)]    # clone
        _persist(leaves, self._sink)             # persist inline
        self._latest = state


class AsyncCheckpointer(BaseCheckpointer):
    name = "async"

    def __init__(self, freq: int = 1):
        super().__init__(freq)
        self._sink = io.BytesIO()
        self._thread: Optional[threading.Thread] = None

    def _checkpoint(self, event: StepEvent):
        if self._thread is not None:
            self._thread.join()                  # previous persist must finish
        state = event.state_fn()
        leaves = [t.clone() for t in _flatten_state(state)]
        self._latest = state
        self._thread = threading.Thread(
            target=_persist, args=(leaves, self._sink), daemon=True)
        self._thread.start()

    def finalize(self):
        if self._thread is not None:
            self._thread.join()


class ShardedAsyncCheckpointer(AsyncCheckpointer):
    """Torch-DCP-like: checkpoint sharded across N training nodes, so each
    node copies/persists 1/N of the state."""
    name = "torch_dcp"

    def __init__(self, freq: int = 1, n_shards: int = 4):
        super().__init__(freq)
        self.n_shards = n_shards

    def _checkpoint(self, event: StepEvent):
        if self._thread is not None:
            self._thread.join()
        state = event.state_fn()
        # this node's shard: 1/N of every leaf (flattened prefix slice)
        leaves = []
        for t in _flatten_state(state):
            flat = t.reshape(-1)
            leaves.append(flat[:max(1, flat.numel() // self.n_shards)]
                          .clone())
        self._latest = state
        self._thread = threading.Thread(
            target=_persist, args=(leaves, self._sink), daemon=True)
        self._thread.start()


class GeminiLikeCheckpointer(BaseCheckpointer):
    """Checkpoint into remote CPU memory over the training network,
    interleaved with training traffic (paper §6.2).

    Transfer = bytes / network bandwidth; stall = transfer time minus the
    overlap budget (idle network time per iteration), slept for at most
    0.25 s. Short iterations give less overlap, which is exactly the regime
    where Gemini slows down.
    """
    name = "gemini"

    def __init__(self, freq: int = 1, network_gbps: float = 100.0,
                 overlap_fraction: float = 0.5, replication: int = 1):
        super().__init__(freq)
        self.network_gbps = network_gbps
        self.overlap_fraction = overlap_fraction
        self.replication = replication
        self._remote: list[torch.Tensor] = []

    def _checkpoint(self, event: StepEvent):
        state = event.state_fn()
        leaves = _flatten_state(state)
        nbytes = sum(t.numel() * t.element_size()
                     for t in leaves) * self.replication
        self._remote = [t.clone() for t in leaves]       # the real copy
        self._latest = state
        transfer = nbytes * 8 / (self.network_gbps * 1e9)
        budget = (event.iter_time or 0.0) * self.overlap_fraction
        residual = max(0.0, transfer - budget)
        time.sleep(min(residual, 0.25))                  # bounded for benches


class CheckFreqCheckpointer(AsyncCheckpointer):
    """CheckFreq: profile checkpoint overhead for the first few steps, then
    pick the frequency that keeps overhead under ``target_overhead``."""
    name = "checkfreq"

    def __init__(self, target_overhead: float = 0.035, profile_steps: int = 3):
        super().__init__(freq=1)
        self.target = target_overhead
        self.profile_steps = profile_steps
        self._profiled: list[float] = []
        self._iter_times: list[float] = []
        self.tuned_freq: Optional[int] = None

    def on_step(self, event: StepEvent) -> float:
        if event.iter_time:
            self._iter_times.append(event.iter_time)
        if self.tuned_freq is None and len(self._profiled) >= self.profile_steps:
            ovh = float(np.mean(self._profiled))
            it = float(np.mean(self._iter_times)) if self._iter_times else 1.0
            self.tuned_freq = max(1, int(np.ceil(ovh / (self.target * it))))
            self.freq = self.tuned_freq
        stall = super().on_step(event)
        if self.tuned_freq is None and stall > 0:
            self._profiled.append(stall)
        return stall


class CheckmateCheckpointer(BaseCheckpointer):
    """Per-iteration checkpointing from the captured gradients.

    ``on_step`` sends the capture into a `GradientChannel` (default:
    `InProcessChannel`) and applies the channel's deliveries to the shadow
    cluster. The stall is booked by stage: the channel's own decomposition
    of its send (``last_send_parts``: ``send``, and ``quantize`` for a
    compressed channel), the wait for a bounded-lag shadow's backlog
    (``apply-lag``) and the rest of the inline hand-off (``inline-apply``:
    a sync-mode shadow applies on this thread). A resync books ``resync``
    and a recovery's consolidation ``consolidate-wait``.

    The stall is the channel's sender-visible send cost, so a
    `PacketizedChannel`'s event loop (the host simulating the network)
    is never booked as training stall.

    A gated delivery is not applied and desynchronizes the stream: the
    shadow stays frozen at the last fully-captured step (``skipped_steps``
    records every refused step) until the next event that carries
    ``state_fn`` (a full-state resync) or ``restore()`` (recovery rewinds
    training to exactly the shadow's state).

    A bucket-sharded transport (``PacketizedChannel(sharded=True)``) gates
    per owner node instead, by its deliveries' ``node_complete``:

    * holes confined to DEAD owners (``shadow.dead_nodes``) cost exactly
      their shards: the surviving owners keep replaying the stream
      (``ShadowCluster.on_delivery(d, nodes=live)``) and consolidation
      names exactly the dead buckets (`ShadowNodeLoss`). Such a step is no
      checkpoint: it is booked as a skipped capture with zero stall and
      recorded in ``skipped_steps`` and ``partial_steps``.
    * a hole on an ALIVE owner desynchronizes the whole cluster, as the
      unsharded gate does: advancing the others would tear the
      consolidated tree across steps.

    Either way the next ``state_fn`` resync makes the cluster whole: the
    shadow is re-bootstrapped (reviving dead owners) and the channel's
    ``revive_all()`` re-arms the transport.

    ``durability`` (a `repro_torch.durability.DurableShadow`) is attached
    to the shadow here: its flush epochs ride the shadow's own ingest
    (``ShadowCluster.on_delivery`` -> ``notify``), so a gated capture opens
    no epoch, and nothing of it touches the stall ledger. `finalize`
    drains and closes it.
    """
    name = "checkmate"
    consumes_grads = True

    def __init__(self, shadow: ShadowCluster,
                 channel: Optional[GradientChannel] = None,
                 durability=None):
        super().__init__(freq=1)
        self.shadow = shadow
        self.channel: GradientChannel = (channel if channel is not None
                                         else InProcessChannel())
        self.channel.open(shadow.layout)
        self.durability = durability
        if durability is not None and durability.cluster is not shadow:
            durability.attach(shadow)
        self.skipped_steps: list[int] = []
        self.partial_steps: list[int] = []   # sharded: survivors-only applies
        self.resyncs: list[int] = []
        self._desynced = False
        self._dead_desynced = False      # dead shards seen: arm a resync

    def _apply_deliveries(self):
        for d in self.channel.poll():
            nc = d.node_complete
            if nc is None:               # unsharded transport: global gate
                if not d.complete:
                    self._desynced = True
                    self.skipped_steps.append(d.step)
                elif self._desynced:     # contiguity: refuse post-gap applies
                    self.skipped_steps.append(d.step)
                else:
                    self.shadow.on_delivery(d)
                continue
            # sharded transport: per-owner verdicts (see class docstring)
            dead = set(self.shadow.dead_nodes)
            incomplete = {n for n, ok in nc.items() if not ok}
            if incomplete - dead:
                self._desynced = True    # an alive owner lost capture spans
            elif incomplete:
                self._dead_desynced = True
            if self._desynced or incomplete:
                self.skipped_steps.append(d.step)
                if not self._desynced:
                    live = set(nc) - dead
                    if live:
                        self.shadow.on_delivery(d, nodes=live)
                        self.partial_steps.append(d.step)
            else:
                self.shadow.on_delivery(d)

    def _checkpoint(self, event: StepEvent):
        ob = _obs.get()
        t0 = time.perf_counter()
        if self._desynced or self._dead_desynced:
            if event.state_fn is not None:
                with ob.tracer.span("checkpoint.resync", track="checkpoint",
                                    args={"step": event.step}):
                    self.channel.poll()  # superseded by the full-state copy
                    snap = event.state_fn()
                    self.shadow.bootstrap(snap["params"], snap["mu"],
                                          snap["nu"], int(snap["step"]))
                revive = getattr(self.channel, "revive_all", None)
                if revive is not None:
                    revive()             # replacement shadow hardware racked
                self._desynced = False
                self._dead_desynced = False
                self.resyncs.append(event.step)
                dt = time.perf_counter() - t0
                self._parts = {"resync": dt}
                return dt
            if self._desynced:
                self.skipped_steps.append(event.step)
                return False             # frozen until resync or recovery
            # dead owners only: their shards are lost either way — keep
            # the survivors replaying (consolidate reports the holes)
        if event.grads is None and event.flats is None:
            raise ValueError("Checkmate consumes captured gradients")
        n_skipped = len(self.skipped_steps)
        lag0 = self.shadow.lag_wait_s_total
        stall = float(self.channel.send(event) or 0.0)
        t1 = time.perf_counter()
        self._apply_deliveries()
        if self._desynced or len(self.skipped_steps) > n_skipped:
            return False    # gated or partial: not a checkpoint, no stall
        inline = time.perf_counter() - t1
        # the channel's parts sum in order to its stall bit-exactly; the
        # bounded-lag wait is split out of the inline hand-off
        parts = dict(getattr(self.channel, "last_send_parts", None)
                     or {"send": stall})
        lag_wait = self.shadow.lag_wait_s_total - lag0
        if lag_wait > 0.0:
            parts["apply-lag"] = lag_wait
            inline = max(0.0, inline - lag_wait)
        parts["inline-apply"] = inline
        self._parts = parts
        return sum(parts.values())

    def restore(self) -> Optional[dict]:
        ob = _obs.get()
        t0 = time.perf_counter()
        with ob.tracer.span("recovery.consolidate", track="recovery"):
            out = self.shadow.consolidate()
        # recovery stalls training while the shadows drain
        self._book("consolidate-wait", time.perf_counter() - t0)
        self._desynced = False           # training rewinds to this state
        return out

    def finalize(self):
        self._apply_deliveries()
        self.channel.close()
        try:
            self.shadow.consolidate()
        except ShadowNodeLoss:
            pass        # dead nodes at shutdown: the partial is all there is
        if self.durability is not None:
            self.durability.drain()      # everything applied is durable
            self.durability.close()
