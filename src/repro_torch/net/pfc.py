"""Priority Flow Control model (paper §4.3.3): lossless delivery to shadow
nodes under transient receiver-side pressure. The port's copy of
``repro.net.pfc``.

Two views live here:

* ``PfcQueue`` — the original self-contained bounded queue with XOFF/XON
  thresholds, used by the unit tests and the legacy per-round simulator.
* ``PfcConfig`` — threshold/propagation parameters consumed by the
  event-driven fabric simulator (`repro_torch.net.simulator`), where
  occupancy is tracked per switch-egress queue and PAUSE/RESUME signals propagate to
  upstream transmitters with a configurable delay (hop-by-hop PFC, the way
  real 802.1Qbb behaves).

The invariant in both: when thresholds leave headroom for in-flight bytes,
a paused upstream never overflows the queue, so the lossless class drops
nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class PfcConfig:
    """PFC parameters for one switch egress queue in the fabric simulator.

    Args:
        capacity_bytes: physical buffer bound; enqueue beyond it drops.
        xoff_frac: occupancy fraction at which PAUSE is sent upstream.
        xon_frac: occupancy fraction at which RESUME is sent upstream.
        pause_prop_s: one-way PAUSE/RESUME signal propagation delay.
        enabled: disable to model a lossy (drop + retransmit) class.
    """
    capacity_bytes: int = 2 * 1024 * 1024
    xoff_frac: float = 0.8
    xon_frac: float = 0.5
    pause_prop_s: float = 2e-6
    enabled: bool = True

    @property
    def xoff(self) -> int:
        return int(self.capacity_bytes * self.xoff_frac)

    @property
    def xon(self) -> int:
        return int(self.capacity_bytes * self.xon_frac)


@dataclass
class PfcQueue:
    capacity_bytes: int = 2 * 1024 * 1024
    xoff_frac: float = 0.8
    xon_frac: float = 0.5
    occupancy: int = 0
    paused: bool = False
    pause_events: int = 0
    resume_events: int = 0
    dropped: int = 0
    enqueued_bytes: int = 0
    paused_offers: int = 0         # offers refused while paused (held bytes)

    @property
    def xoff(self) -> int:
        return int(self.capacity_bytes * self.xoff_frac)

    @property
    def xon(self) -> int:
        return int(self.capacity_bytes * self.xon_frac)

    def offer(self, nbytes: int) -> bool:
        """Try to enqueue. Returns False when the sender must hold (paused).
        A correct PFC sender never loses data: drops only happen on overflow,
        which pause prevents."""
        if self.paused:
            self.paused_offers += 1
            return False
        if self.occupancy + nbytes > self.capacity_bytes:
            # would overflow: this cannot happen if thresholds are sane,
            # because XOFF fires first — count it as a (model) drop.
            self.dropped += 1
            return False
        self.occupancy += nbytes
        self.enqueued_bytes += nbytes
        if self.occupancy >= self.xoff and not self.paused:
            self.paused = True
            self.pause_events += 1
        return True

    def drain(self, nbytes: int):
        self.occupancy = max(0, self.occupancy - nbytes)
        if self.paused and self.occupancy <= self.xon:
            self.paused = False
            self.resume_events += 1

    def headroom_ok(self, max_inflight: int) -> bool:
        """XOFF must leave room for in-flight bytes (cable + reaction)."""
        return self.capacity_bytes - self.xoff >= max_inflight
