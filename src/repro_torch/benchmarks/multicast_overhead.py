"""Fig 10: replication-factor sweep on the packet simulator — AllReduce bus
bandwidth and switch TX/RX frame counts (only tagged packets replicate) —
plus per-channel send-side overhead (in-process vs packetized vs
compressed) measured from the checkpointer's stall-attribution ledger
(`repro_torch.obs.stalls`); the port of ``benchmarks/multicast_overhead.py``.

The sweep is host arithmetic, machine-independent, and equals the JAX
module's rows. The channel rows drive a `CheckmateCheckpointer` over each
channel into a 2-node shadow on ``device`` (the card unless ``"cpu"``),
with the gradient leaves on that device as a capture point holds them:
on the card the send packs them with the bucket-pack kernel and brings
the buckets to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks.common import cli_device, csv_row
from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.channel import (CompressedChannel, InProcessChannel,
                                      PacketizedChannel, StepEvent)
from repro_torch.core.checkpoint import CheckmateCheckpointer
from repro_torch.core.shadow import ShadowCluster
from repro_torch.device import resolve
from repro_torch.net.simulator import simulate_allgather_replication
from repro_torch.optim.functional import OptimizerConfig

SEND_STAGES = ("send", "quantize")       # the channel-attributed stall


def run(registry=None, device=None) -> list[tuple]:
    device = resolve(device)
    rows = []
    base = None
    for rf in (1, 2, 4, 8, 16):
        r = simulate_allgather_replication(
            4, 1 << 30, link_gbps=100.0, replication_factor=rf,
            # Fig 10 attaches one dedicated port per replica: drain scales
            shadow_drain_gbps=100.0 * 2 * rf)
        base = base or r.bus_bandwidth_gbps
        rows.append(csv_row(f"fig10.rf{rf}", r.duration_s * 1e6,
                            f"busbw={r.bus_bandwidth_gbps:.1f}Gbps "
                            f"tx_over_rx={r.tx_over_rx:.2f} "
                            f"ok={r.reassembled_ok} drops={r.drops}"))
    rows.append(csv_row("fig10.busbw_constant", 0.0,
                        f"{abs(base - r.bus_bandwidth_gbps) < 1e-6}"))

    # -- per-channel send-side overhead (capture critical path) --------------
    # the channel-attributed stages (send + quantize) per step from the
    # stall ledger, as `repro_torch.obs summary` prints them
    rng = np.random.default_rng(0)
    tree = {f"layer{i}.w": torch.from_numpy(
        rng.standard_normal((256, 512)).astype(np.float32)).to(device)
        for i in range(8)}
    layout = layout_for_tree(tree, cap_bytes=1 << 20)
    zeros = {k: torch.zeros_like(v) for k, v in tree.items()}
    opt = OptimizerConfig(name="sgd", lr=1e-3)
    channels = [
        ("inprocess", lambda: InProcessChannel()),
        ("packetized", lambda: PacketizedChannel(topology="rail-optimized",
                                                 n_dp_groups=2,
                                                 ranks_per_group=4)),
        ("compressed", lambda: CompressedChannel(InProcessChannel())),
    ]
    n_reps = 3
    for name, make in channels:
        chan = make()
        shadow = ShadowCluster(layout, opt, n_nodes=2, device=device)
        shadow.bootstrap(tree, zeros, zeros, 0)
        ck = CheckmateCheckpointer(shadow, channel=chan)
        ck.on_step(StepEvent(step=1, grads=tree, lr=1e-3))      # warmup
        base = dict(ck.stall_stages)
        for r_i in range(n_reps):
            ck.on_step(StepEvent(step=2 + r_i, grads=tree, lr=1e-3))
        delta = {k: v - base.get(k, 0.0)
                 for k, v in ck.stall_stages.items()}
        send_s = sum(delta.get(s, 0.0) for s in SEND_STAGES)
        breakdown = " ".join(f"{k}={v / n_reps * 1e6:.1f}us"
                             for k, v in sorted(delta.items()))
        chan.close()
        shadow.shutdown()
        rows.append(csv_row(f"channel_send.{name}", send_s / n_reps * 1e6,
                            breakdown))
        if registry is not None:
            from repro_torch.obs.publish import publish_channel
            from repro_torch.obs.stalls import publish_stalls
            publish_stalls(registry, ck, labels={"bench": name})
            publish_channel(registry, chan)
    return rows


if __name__ == "__main__":
    run(device=cli_device())
