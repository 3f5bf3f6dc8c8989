"""The golden scenario corpus, the 47 specs of ``repro.harness.corpus``
copied verbatim: named chaos drills spanning the scenario space — single
/ rail-optimized / strided topologies x all three channel stacks x every
failure class (link, switch, shadow-NIC, gated-capture bursts,
shadow-node deaths on sharded clusters, worker wedge, training-node
failures, multi-failure sequences).

Every golden scenario must pass every applicable invariant;
``python -m repro_torch.harness run --corpus golden`` is the CI chaos gate.
Channel-level scenarios drive checkpointer -> channel -> fabric -> shadow
on a synthetic stream (fast); full-level ones run the real training loop.
The port's runner refuses ``elastic-fsdp-flip`` (a full-level shrink onto
an FSDP-flipped mesh) until the multi-GPU slice, ROADMAP item 11.
"""
from __future__ import annotations

from repro_torch.harness.scenario import (ChannelSpec, DurabilitySpec,
                                          FabricFailure, FailureSchedule,
                                          Scenario, ShadowDeath,
                                          ShadowPlaneLoss, TierFailure,
                                          TrainNodeLoss)

_RAIL = dict(kind="packetized", topology="rail-optimized")
# bucket-sharded owner routing; small buckets so 3 owners all hold shards
_SHARD = dict(kind="packetized", topology="rail-optimized", sharded=True)


def _sc(name: str, **kw) -> Scenario:
    return Scenario(name=name, **kw).validate()


GOLDEN: dict[str, Scenario] = {s.name: s for s in [
    # -- clean transports: every topology, every channel stack --------------
    _sc("inprocess-clean", seed=11, steps=5),
    _sc("packetized-single-clean", seed=12, steps=5,
        channel=ChannelSpec(kind="packetized", topology="single")),
    _sc("packetized-rail-clean", seed=13, steps=5,
        channel=ChannelSpec(**_RAIL)),
    _sc("packetized-strided-clean", seed=14, steps=5,
        channel=ChannelSpec(kind="packetized", topology="leaf-spine")),
    _sc("packetized-two-groups", seed=15, steps=4, n_leaves=4,
        channel=ChannelSpec(**_RAIL, n_dp_groups=2, ranks_per_group=4)),
    _sc("packetized-replicated", seed=16, steps=4,
        channel=ChannelSpec(**_RAIL, replication_factor=2)),
    _sc("async-shadow-clean", seed=17, steps=5, shadow_async=True,
        shadow_nodes=3, channel=ChannelSpec(**_RAIL)),
    _sc("adam-nodes3-clean", seed=18, steps=5, optimizer="adam",
        shadow_nodes=3, channel=ChannelSpec(kind="packetized",
                                            topology="single")),

    # -- gated captures: freeze, resync, burst ------------------------------
    _sc("capture-frozen", seed=21, steps=4, resync=False,
        channel=ChannelSpec(**_RAIL),
        schedule=FailureSchedule(fabric=(
            FabricFailure(step=2, kind="capture"),))),
    _sc("capture-resync", seed=22, steps=5,
        channel=ChannelSpec(**_RAIL),
        schedule=FailureSchedule(fabric=(
            FabricFailure(step=3, kind="capture"),))),
    _sc("capture-burst", seed=23, steps=6,
        channel=ChannelSpec(**_RAIL),
        schedule=FailureSchedule(fabric=(
            FabricFailure(step=3, kind="capture"),
            FabricFailure(step=4, kind="capture")))),

    # -- hardware kills mid-iteration ---------------------------------------
    _sc("shadow-nic-kill", seed=31, steps=5,
        channel=ChannelSpec(**_RAIL),
        schedule=FailureSchedule(fabric=(
            FabricFailure(step=3, kind="shadow_nic", target="s0"),))),
    _sc("spine-kill-reroutes", seed=32, steps=5,
        channel=ChannelSpec(**_RAIL),
        schedule=FailureSchedule(fabric=(
            FabricFailure(step=3, kind="switch", target="spine0"),))),
    _sc("uplink-cut-reroutes", seed=33, steps=5,
        channel=ChannelSpec(kind="packetized", topology="leaf-spine"),
        schedule=FailureSchedule(fabric=(
            FabricFailure(step=2, kind="link",
                          target=("leaf0", "spine0")),))),
    _sc("multi-failure-sequence", seed=34, steps=5,
        channel=ChannelSpec(**_RAIL),
        schedule=FailureSchedule(fabric=(
            FabricFailure(step=2, kind="link", target=("leaf0", "spine0")),
            FabricFailure(step=2, kind="switch", target="spine1",
                          at_us=1.0),
            FabricFailure(step=4, kind="shadow_nic", target="s1")))),

    # -- recovery: training-node failures rewind onto the shadow ------------
    _sc("inprocess-recovery", seed=41, steps=6,
        schedule=FailureSchedule(train_fail_steps=(4,))),
    _sc("gated-then-recovery", seed=42, steps=6,
        channel=ChannelSpec(**_RAIL),
        schedule=FailureSchedule(
            train_fail_steps=(5,),
            fabric=(FabricFailure(step=4, kind="capture"),))),
    _sc("double-recovery", seed=43, steps=7,
        channel=ChannelSpec(kind="packetized", topology="single"),
        schedule=FailureSchedule(train_fail_steps=(3, 6))),

    # -- compressed stream: EF bound + gated compressed captures ------------
    _sc("compressed-sgd-ef-bound", seed=51, steps=5, optimizer="sgd",
        momentum=0.0, lr=0.1,
        channel=ChannelSpec(kind="compressed")),
    _sc("compressed-packetized", seed=52, steps=5,
        channel=ChannelSpec(kind="compressed", inner="packetized",
                            topology="rail-optimized")),
    _sc("compressed-capture-resync", seed=53, steps=5,
        channel=ChannelSpec(kind="compressed", inner="packetized",
                            topology="single"),
        schedule=FailureSchedule(fabric=(
            FabricFailure(step=3, kind="capture"),))),

    # -- bucket-sharded shadow cluster: owner routing + node deaths ---------
    _sc("sharded-rail-clean", seed=81, steps=5, shadow_nodes=3,
        n_leaves=4, cap_bytes=256,
        channel=ChannelSpec(**_SHARD, shadow_rails=2)),
    _sc("sharded-two-groups-clean", seed=82, steps=4, shadow_nodes=3,
        n_leaves=4, cap_bytes=256,
        channel=ChannelSpec(**_SHARD, n_dp_groups=2, ranks_per_group=4)),
    _sc("shadow-death-midstep", seed=83, steps=5, shadow_nodes=3,
        n_leaves=4, cap_bytes=256, resync=False,
        channel=ChannelSpec(**_SHARD),
        schedule=FailureSchedule(shadow_death=(
            ShadowDeath(step=3, node=1, phase="step"),))),
    _sc("shadow-death-consolidate", seed=84, steps=5, shadow_nodes=3,
        n_leaves=4, cap_bytes=256, resync=False,
        channel=ChannelSpec(**_SHARD),
        schedule=FailureSchedule(shadow_death=(
            ShadowDeath(step=3, node=0, phase="consolidate"),))),
    # death at 2, resync heals at 3, then a link + alive-NIC kill burst at
    # 4 desyncs the revived cluster as a whole (alive owners lose spans)
    _sc("shadow-death-link-burst", seed=85, steps=6, shadow_nodes=3,
        n_leaves=4, cap_bytes=256,
        channel=ChannelSpec(**_SHARD),
        schedule=FailureSchedule(
            shadow_death=(ShadowDeath(step=2, node=2, phase="step"),),
            fabric=(FabricFailure(step=4, kind="link",
                                  target=("leaf0", "spine0")),
                    FabricFailure(step=4, kind="shadow_nic",
                                  target="s0")))),
    _sc("shadow-death-resync", seed=86, steps=6, shadow_nodes=3,
        n_leaves=4, cap_bytes=256,
        channel=ChannelSpec(**_SHARD, shadow_rails=3),
        schedule=FailureSchedule(shadow_death=(
            ShadowDeath(step=2, node=0, phase="step"),))),
    _sc("shadow-death-async", seed=87, steps=5, shadow_nodes=3,
        n_leaves=4, cap_bytes=256, shadow_async=True, resync=False,
        channel=ChannelSpec(**_SHARD),
        schedule=FailureSchedule(shadow_death=(
            ShadowDeath(step=2, node=1, phase="step"),
            ShadowDeath(step=4, node=2, phase="consolidate")))),

    # -- durability tiers behind the shadow plane ---------------------------
    _sc("durability-clean", seed=91, steps=5, shadow_nodes=3,
        n_leaves=4, cap_bytes=256,
        channel=ChannelSpec(**_SHARD),
        durability=DurabilitySpec(enabled=True)),
    # kill the ENTIRE shadow plane after step 4; the only way back is
    # restore_from_tiers, and the run must still end bit-identical
    _sc("shadow-plane-loss", seed=92, steps=6, shadow_nodes=3,
        n_leaves=4, cap_bytes=256,
        channel=ChannelSpec(**_SHARD),
        durability=DurabilitySpec(enabled=True),
        schedule=FailureSchedule(plane_loss=(ShadowPlaneLoss(step=4),))),
    # flush cadence 2: the tiers trail the stream by one step when the
    # plane dies at step 5, so recovery rewinds to 4 and replays
    _sc("flush-lag", seed=93, steps=6, shadow_nodes=3,
        n_leaves=4, cap_bytes=256,
        channel=ChannelSpec(**_SHARD),
        durability=DurabilitySpec(enabled=True, every_steps=2),
        schedule=FailureSchedule(plane_loss=(ShadowPlaneLoss(step=5),))),
    # local-disk refuses step 3's records; the object store still holds a
    # complete epoch there and restore serves the newest point ANY tier has
    _sc("tier-failure-fallback", seed=94, steps=5, shadow_nodes=3,
        n_leaves=4, cap_bytes=256,
        channel=ChannelSpec(**_SHARD),
        durability=DurabilitySpec(enabled=True, object_store=True),
        schedule=FailureSchedule(tier_fail=(
            TierFailure(step=3, tier="local-disk"),))),
    # int8 delta flushing (stateless no-EF codec) + async applies; the
    # zero-flush-stall claim must hold on the compressed path too
    _sc("compressed-flush", seed=95, steps=5, shadow_nodes=3,
        n_leaves=4, cap_bytes=256, shadow_async=True,
        channel=ChannelSpec(**_SHARD),
        durability=DurabilitySpec(enabled=True, compress=True,
                                  rebase_every=2)),

    # -- elastic shrink: train ranks die with NO hot spare ------------------
    # half the world dies after step 3; the run replans DP 8 -> 4,
    # rebuilds channel + shadow plane, and resumes bit-identically
    _sc("elastic-dp8-to-4", seed=101, steps=6,
        channel=ChannelSpec(**_RAIL, n_dp_groups=2, ranks_per_group=4),
        schedule=FailureSchedule(train_node_loss=(
            TrainNodeLoss(step=3, ranks=(4, 5, 6, 7)),))),
    # a non-power-of-two world: 8 -> 6 survivors regroup as 2 groups of 3
    _sc("elastic-dp8-to-6", seed=102, steps=6,
        channel=ChannelSpec(**_RAIL, n_dp_groups=2, ranks_per_group=4),
        schedule=FailureSchedule(train_node_loss=(
            TrainNodeLoss(step=3, ranks=(3, 6)),))),
    # full level: the restore lands on an FSDP-flipped ShardingRules — the
    # one layout change the 1-device smoke mesh can express
    _sc("elastic-fsdp-flip", level="full", seed=103, steps=6,
        channel=ChannelSpec(**_RAIL),
        schedule=FailureSchedule(train_node_loss=(
            TrainNodeLoss(step=3),))),
    # shrink at 3, then the WHOLE rebuilt shadow plane dies at 5: recovery
    # restores the post-shrink epoch from the durability tiers onto the
    # shrunken layout
    _sc("elastic-shrink-then-plane-loss", seed=104, steps=6,
        shadow_nodes=3, n_leaves=4, cap_bytes=256,
        channel=ChannelSpec(**_SHARD, n_dp_groups=2, ranks_per_group=4),
        durability=DurabilitySpec(enabled=True),
        schedule=FailureSchedule(
            train_node_loss=(TrainNodeLoss(step=3, ranks=(5, 7)),),
            plane_loss=(ShadowPlaneLoss(step=5),))),
    # shrink under a compressed channel: the rebuilt stream restarts its
    # error-feedback from the synced resume point, so the sharp EF bound
    # must hold over the post-shrink steps alone
    _sc("elastic-compressed-shrink", seed=105, steps=5, optimizer="sgd",
        momentum=0.0, lr=0.1,
        channel=ChannelSpec(kind="compressed", inner="packetized",
                            topology="rail-optimized",
                            n_dp_groups=2, ranks_per_group=4),
        schedule=FailureSchedule(train_node_loss=(
            TrainNodeLoss(step=3, ranks=(0, 1, 2, 3)),))),
    # two shrinks in one run: 8 -> 6 -> 4, ranks named in ORIGINAL ids
    _sc("elastic-double-shrink", seed=106, steps=6,
        channel=ChannelSpec(**_RAIL, n_dp_groups=2, ranks_per_group=4),
        schedule=FailureSchedule(train_node_loss=(
            TrainNodeLoss(step=2, ranks=(6, 7)),
            TrainNodeLoss(step=4, ranks=(4, 5))))),

    # -- consolidation under a wedged worker --------------------------------
    _sc("wedge-consolidate", seed=61, steps=4, shadow_async=True,
        shadow_nodes=2,
        schedule=FailureSchedule(wedge_node=0, wedge_release_s=1.5)),

    # -- bounded multi-step lag under a throttled applier --------------------
    # every apply is deliberately slow, so the trainer outruns the shadow,
    # hits the max_lag_steps bound (booked as the apply-lag stall stage),
    # and the workers catch up with batched K-step replays; the fast fabric
    # engine rides along so the lagged path is exercised on it too
    _sc("slow-apply-clean", seed=111, steps=8, shadow_async=True,
        shadow_nodes=2, max_lag_steps=3, apply_delay_s=0.03,
        channel=ChannelSpec(**_RAIL, fast=True)),
    # a mid-run link cut desyncs the stream while the applier is lagging:
    # the resync's full-state copy must supersede the queued backlog
    _sc("slow-apply-with-link-burst", seed=112, steps=10, shadow_async=True,
        shadow_nodes=2, max_lag_steps=3, apply_delay_s=0.03,
        channel=ChannelSpec(**_RAIL),
        schedule=FailureSchedule(fabric=(
            FabricFailure(step=3, kind="link", target=("leaf0", "spine0")),
            FabricFailure(step=3, kind="shadow_nic", target="s0")))),
    # sharded owners, each lagging independently: the final consolidate is
    # a distributed gather across backlogged nodes and must still land
    # bit-identical at the trainer's step
    _sc("slow-apply-consolidate", seed=113, steps=8, shadow_nodes=3,
        n_leaves=4, cap_bytes=256, shadow_async=True,
        max_lag_steps=3, apply_delay_s=0.04,
        channel=ChannelSpec(**_SHARD)),

    # -- full-stack: the real training loop ---------------------------------
    _sc("full-inprocess-recovery", level="full", seed=71, steps=8,
        schedule=FailureSchedule(train_fail_steps=(3, 6))),
    _sc("full-packetized-gated-recovery", level="full", seed=72, steps=6,
        channel=ChannelSpec(**_RAIL, n_dp_groups=2, ranks_per_group=4),
        schedule=FailureSchedule(
            train_fail_steps=(5,),
            fabric=(FabricFailure(step=4, kind="capture"),))),
    _sc("full-sync-repeated-work", level="full", seed=73, steps=6,
        checkpointer="sync", ckpt_freq=3,
        schedule=FailureSchedule(train_fail_steps=(5,))),
    _sc("full-packetized-rail-clean", level="full", seed=74, steps=5,
        channel=ChannelSpec(**_RAIL)),
]}
