"""Checkpointers: Checkmate and the no-checkpoint baseline, the port of
``repro.core.checkpoint`` (unsharded gate only; the copy-persist baselines
come later).

The training loop calls ``on_step(event)`` every iteration with one frozen
`StepEvent` and adds the returned stall seconds to its critical path.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.core.channel import (GradientChannel, InProcessChannel,
                                      StepEvent)
from repro_torch.core.shadow import ShadowCluster


class BaseCheckpointer:
    name = "base"
    # whether on_step reads the captured gradients: the loop skips the
    # capture's pack and device-to-host copy for everyone else
    consumes_grads = False

    def __init__(self, freq: int = 1):
        self.freq = max(1, freq)
        self.n_checkpoints = 0
        self.skipped_captures = 0
        self.stall_total = 0.0

    def on_step(self, event: StepEvent) -> float:
        """Consume one iteration; returns stall seconds. A gated capture
        (``_checkpoint`` returning False) is counted in
        ``skipped_captures`` and is no checkpoint."""
        if event.step % self.freq != 0:
            return 0.0
        t0 = time.perf_counter()
        captured = self._checkpoint(event)
        if captured is False:
            self.skipped_captures += 1
            return 0.0
        stall = (captured if isinstance(captured, float)
                 else time.perf_counter() - t0)
        self.stall_total += stall
        self.n_checkpoints += 1
        return stall

    def _checkpoint(self, event: StepEvent):
        raise NotImplementedError

    def restore(self) -> Optional[dict]:
        return None

    def finalize(self):
        pass


class NoCheckpointer(BaseCheckpointer):
    name = "no_checkpoint"

    def on_step(self, event: StepEvent) -> float:
        return 0.0


class CheckmateCheckpointer(BaseCheckpointer):
    """Per-iteration checkpointing from the captured gradients.

    ``on_step`` sends the capture into a `GradientChannel` (default:
    `InProcessChannel`) and applies the channel's deliveries to the shadow
    cluster. A gated delivery is not applied and desynchronizes the stream:
    the shadow stays frozen at the last fully-captured step
    (``skipped_steps`` records every refused step) until the next event that
    carries ``state_fn`` (a full-state resync) or ``restore()`` (recovery
    rewinds training to exactly the shadow's state).
    """
    name = "checkmate"
    consumes_grads = True

    def __init__(self, shadow: ShadowCluster,
                 channel: Optional[GradientChannel] = None):
        super().__init__(freq=1)
        self.shadow = shadow
        self.channel: GradientChannel = (channel if channel is not None
                                         else InProcessChannel())
        self.channel.open(shadow.layout)
        self.skipped_steps: list[int] = []
        self.resyncs: list[int] = []
        self._desynced = False

    def _apply_deliveries(self):
        for d in self.channel.poll():
            if not d.complete:
                self._desynced = True
                self.skipped_steps.append(d.step)
            elif self._desynced:         # contiguity: refuse post-gap applies
                self.skipped_steps.append(d.step)
            else:
                self.shadow.on_delivery(d)

    def _checkpoint(self, event: StepEvent):
        t0 = time.perf_counter()
        if self._desynced:
            if event.state_fn is None:
                self.skipped_steps.append(event.step)
                return False             # frozen until resync or recovery
            self.channel.poll()          # superseded by the full-state copy
            snap = event.state_fn()
            self.shadow.bootstrap(snap["params"], snap["mu"], snap["nu"],
                                  int(snap["step"]))
            self._desynced = False
            self.resyncs.append(event.step)
            return time.perf_counter() - t0
        if event.grads is None and event.flats is None:
            raise ValueError("Checkmate consumes captured gradients")
        n_skipped = len(self.skipped_steps)
        stall = float(self.channel.send(event) or 0.0)
        t1 = time.perf_counter()
        self._apply_deliveries()
        if self._desynced or len(self.skipped_steps) > n_skipped:
            return False                 # gated: not a checkpoint, no stall
        # the channel's sender-visible cost plus the inline hand-off (a
        # sync-mode shadow applies on this thread)
        return stall + (time.perf_counter() - t1)

    def restore(self) -> Optional[dict]:
        out = self.shadow.consolidate()
        self._desynced = False           # training rewinds to this state
        return out

    def finalize(self):
        self._apply_deliveries()
        self.channel.close()
        self.shadow.consolidate()
