"""Declarative chaos scenarios: everything a co-simulation run needs,
expandable from a single integer seed — the port's copy of
``repro.harness.scenario`` (same fields, same draws, the same JSON byte
for byte; only the channels `ChannelSpec.build` constructs are the
port's).

A `Scenario` names the full stack configuration — model (or synthetic
tree), channel stack, optimizer, DP groups, shadow plane — plus a
`FailureSchedule` of link/switch/shadow-NIC kills, gated-capture bursts,
worker wedges, and training-node failures. Scenarios are frozen,
JSON-round-trippable (`to_dict`/`from_dict`), and `sample_scenario(seed)`
expands a random-but-valid scenario deterministically from one RNG seed —
which is what makes every chaos run replayable from one integer
(`python -m repro_torch.harness replay --seed N`).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field

import numpy as np


def repro_seed(default: int = 0) -> int:
    """The process-wide base seed: ``REPRO_SEED`` env var (see
    tests/conftest.py, which prints it in the pytest header) or
    ``default``. Every harness RNG derives from a scenario seed, and
    seeded sweeps derive scenario seeds from this."""
    return int(os.environ.get("REPRO_SEED", default))


@dataclass(frozen=True)
class ChannelSpec:
    """How gradients travel from the capture point to the shadow plane.

    ``kind`` picks the `repro_torch.core.channel` implementation; ``inner`` is
    the transport a ``compressed`` channel wraps. The remaining fields are
    forwarded to `PacketizedChannel` (fabric shape). ``sharded`` turns on
    bucket-sharded mirror routing: each shadow node receives only the
    buckets it owns, deliveries carry per-owner ``node_complete``
    verdicts, and ``shadow_rails`` spreads the owners across that many
    shadow leaf switches.
    """
    kind: str = "inprocess"            # inprocess | packetized | compressed
    inner: str = "inprocess"           # compressed only: inner transport
    topology: str = "rail-optimized"
    n_dp_groups: int = 1
    ranks_per_group: int = 4
    ranks_per_leaf: int = 4
    n_spines: int = 2
    shadow_nics: int = 2
    n_channels: int = 1
    replication_factor: int = 1
    sharded: bool = False              # packetized only: bucket->owner routing
    shadow_rails: int = 1
    # fabric engine: False = per-frame oracle, True = calendar-queue fast
    # path (bit-identical; tests/test_fabric_fastpath.py). Serialized into
    # every scenario/bundle JSON so a violation replays on the exact
    # engine that produced it.
    fast: bool = False

    @property
    def has_fabric(self) -> bool:
        """Whether a fabric simulator sits somewhere in the stack (i.e.
        fabric failure injection is meaningful)."""
        return self.kind == "packetized" or (
            self.kind == "compressed" and self.inner == "packetized")

    def build(self, failures_at: dict, n_shadow_nodes: int = 2):
        """Instantiate the channel stack (fabric failures attach to the
        packetized transport). ``n_shadow_nodes`` is the scenario's shadow
        cluster size, so the fabric models exactly the shadow hosts the
        scenario declares."""
        from repro_torch.core.channel import (CompressedChannel,
                                              InProcessChannel,
                                              PacketizedChannel)

        def packetized():
            return PacketizedChannel(
                topology=self.topology, n_dp_groups=self.n_dp_groups,
                ranks_per_group=self.ranks_per_group,
                n_shadow_nodes=n_shadow_nodes,
                ranks_per_leaf=self.ranks_per_leaf, n_spines=self.n_spines,
                shadow_nics=self.shadow_nics, n_channels=self.n_channels,
                replication_factor=self.replication_factor,
                sharded=self.sharded, shadow_rails=self.shadow_rails,
                failures_at=failures_at, fast=self.fast)

        if self.kind == "inprocess":
            if failures_at:
                raise ValueError("fabric failures need a packetized "
                                 "transport in the channel stack")
            return InProcessChannel()
        if self.kind == "packetized":
            return packetized()
        if self.kind == "compressed":
            if self.inner == "packetized":
                return CompressedChannel(packetized())
            if failures_at:
                raise ValueError("fabric failures need a packetized "
                                 "transport in the channel stack")
            return CompressedChannel(InProcessChannel())
        raise ValueError(f"unknown channel kind {self.kind!r}")


@dataclass(frozen=True)
class FabricFailure:
    """One fabric-level failure bound to a training step.

    kind: "capture" (cut every shadow NIC at t=0 — that step's capture is
    lost, §4.3.2), or a `repro_torch.net.simulator.FailureSpec` kind ("link",
    "switch", "shadow_nic") fired ``at_us`` microseconds into that step's
    fabric iteration. ``target`` follows FailureSpec conventions
    (("leaf0", "spine0") for links, a switch/shadow-host name otherwise).
    """
    step: int
    kind: str
    target: tuple | str | None = None
    at_us: float = 0.0


@dataclass(frozen=True)
class ShadowDeath:
    """Kill one shadow node of a bucket-sharded cluster at a step.

    ``phase`` places the death inside the iteration: ``"step"`` kills the
    node before that step's capture is sent (the delivery arrives with the
    dead owner's buckets missing), ``"consolidate"`` kills it after the
    step applied but before that step's consolidation (the gather itself
    discovers the loss). The node stays dead — every later capture keeps
    losing its shard — until a resync re-seeds replacement hardware.
    """
    step: int
    node: int
    phase: str = "step"                # step | consolidate


@dataclass(frozen=True)
class ShadowPlaneLoss:
    """Kill the ENTIRE shadow plane after ``step`` applied (rack power
    loss, correlated shadow-NIC failure, operator error).

    Every node dies at once — consolidation raises
    `ShadowNodeLoss(total=True)`, there is no surviving partial to merge,
    and the ONLY way back is `repro_torch.durability.restore_from_tiers`: the
    runner restores from the newest flushed epoch, rewinds the trainer
    onto it, re-seeds a replacement fleet, and replays. Requires
    ``Scenario.durability.enabled``.
    """
    step: int


@dataclass(frozen=True)
class TrainNodeLoss:
    """Kill ``ranks`` train nodes after ``step`` with NO hot spare: the
    job must elastically shrink onto the survivors (ROADMAP item 1).

    The runner consolidates the shadow into a layout-agnostic
    checkpoint, replans the largest feasible layout on the surviving
    ranks (`repro_torch.core.costmodel.plan_elastic_mesh`), rebuilds the
    channel geometry + bucket layout + shadow ownership map for the
    shrunken world (`repro_torch.core.elastic.rebuild_shadow` +
    `CheckmateCheckpointer.reconfigure`, booked as the
    ``elastic-reshard`` stall stage), rewinds onto the checkpoint, and
    resumes at the new DP width. ``ranks`` are ORIGINAL-world rank ids;
    a second `TrainNodeLoss` at a later step shrinks again (double
    shrink). At full level the drill restores onto an FSDP-flipped
    `ShardingRules`, which the port has not got yet: its runner raises
    `NotImplementedError` there (ROADMAP item 11).
    """
    step: int
    ranks: tuple[int, ...] = (0,)


@dataclass(frozen=True)
class TierFailure:
    """Injected durability-tier write failure: every flush record for
    ``step`` raises `TierPutError` on the named tier (the record is still
    written to the OTHER tiers — restore falls back across tiers).
    """
    step: int
    tier: str = "local-disk"           # local-disk | object-store


@dataclass(frozen=True)
class DurabilitySpec:
    """The persistence tiers behind the scenario's shadow plane.

    ``enabled`` attaches a `repro_torch.durability.DurableShadow` (a
    `LocalDiskTier` in a run-scoped tempdir, plus an `ObjectStoreTier`
    stub when ``object_store``) with a
    `FlushPolicy(every_steps, compress, rebase_every)`. The runner drains
    flushes between steps so tier lag is deterministic:
    ``every_steps - 1`` at worst.
    """
    enabled: bool = False
    every_steps: int = 1
    compress: bool = False
    rebase_every: int = 4
    object_store: bool = False
    object_latency_s: float = 0.0


@dataclass(frozen=True)
class FailureSchedule:
    """Everything that goes wrong during one scenario.

    * ``train_fail_steps`` — training-node failures (the iteration aborts
      mid-step and recovery restores from the checkpointer), fired once
      each (`repro_torch.core.recovery.FailurePlan`).
    * ``fabric`` — `FabricFailure` events injected into the channel's
      fabric simulator, one-shot per step.
    * ``shadow_death`` — `ShadowDeath` kills of sharded shadow owners
      (persistent, unlike one-shot fabric failures).
    * ``wedge_node`` — wedge this shadow node's apply before the final
      step so consolidation hits its deadline (`ConsolidationTimeout`
      drill); requires an async shadow cluster. ``wedge_release_s`` is how
      long the worker stays wedged.
    * ``plane_loss`` — `ShadowPlaneLoss`: the whole shadow plane dies at
      once; recovery goes through the durability tiers.
    * ``tier_fail`` — `TierFailure`: a tier refuses one step's flush
      records (restore must fall back to another tier).
    * ``train_node_loss`` — `TrainNodeLoss`: train ranks die with no hot
      spare; the job elastically shrinks onto the survivors.
    """
    train_fail_steps: tuple[int, ...] = ()
    fabric: tuple[FabricFailure, ...] = ()
    shadow_death: tuple[ShadowDeath, ...] = ()
    wedge_node: int | None = None
    wedge_release_s: float = 1.5
    plane_loss: tuple[ShadowPlaneLoss, ...] = ()
    tier_fail: tuple[TierFailure, ...] = ()
    train_node_loss: tuple[TrainNodeLoss, ...] = ()

    def failures_at(self) -> dict:
        """The fabric schedule in `PacketizedChannel(failures_at=...)`
        form: {step: "capture" | (FailureSpec, ...)}."""
        from repro_torch.net.simulator import FailureSpec
        by_step: dict[int, list[FabricFailure]] = {}
        for f in self.fabric:
            by_step.setdefault(f.step, []).append(f)
        out: dict = {}
        for step, fs in by_step.items():
            kinds = {f.kind for f in fs}
            if "capture" in kinds:
                if len(fs) > 1:
                    raise ValueError(
                        f"step {step}: 'capture' (kill every shadow NIC) "
                        f"cannot combine with other failures")
                out[step] = "capture"
            else:
                out[step] = tuple(
                    FailureSpec(f.at_us * 1e-6, f.kind,
                                tuple(f.target) if isinstance(
                                    f.target, (list, tuple)) else f.target)
                    for f in fs)
        return out

    @property
    def fabric_steps(self) -> frozenset[int]:
        return frozenset(f.step for f in self.fabric)


@dataclass(frozen=True)
class Scenario:
    """One declarative chaos co-simulation run (see docs/harness.md).

    ``level`` picks the stack depth:

    * ``"channel"`` — synthetic gradient stream through
      checkpointer -> channel -> fabric -> shadow, with a functional-
      optimizer reference trainer maintained side by side (fast; most of
      the golden corpus).
    * ``"full"`` — the real `repro_torch.train.loop.train` loop on a reduced
      model config, with an uninterrupted reference run for bit-identity.

    ``invariants`` empty means auto-select every registered invariant
    whose ``applies()`` matches the scenario; naming invariants forces
    exactly those (used to demonstrate violation bundles).
    ``resync`` (channel level) mirrors whether events carry ``state_fn``,
    i.e. whether a gated capture heals via full-state copy (the training
    loop always resyncs) or freezes the shadow.
    """
    name: str
    level: str = "channel"             # channel | full
    seed: int = 0
    steps: int = 5
    # full level: model + data shape
    arch: str = "tinyllama-1.1b"
    batch: int = 2
    seq: int = 16
    # channel level: synthetic tree shape
    n_leaves: int = 3
    leaf_cols: int = 5
    cap_bytes: int = 4096
    resync: bool = True
    # shared
    optimizer: str = "adamw"
    lr: float = 1e-3
    momentum: float = 0.9
    shadow_nodes: int = 2
    shadow_async: bool = False
    # bounded multi-step shadow lag (async only): the applier may trail the
    # trainer by at most this many queued deliveries; a worker at the bound
    # catches up with one batched K-step replay, and the trainer's wait is
    # booked as the `apply-lag` stall stage. None = legacy unbounded queue.
    max_lag_steps: int | None = None
    # throttle every shadow apply by this many seconds (a deliberately slow
    # applier — the slow-apply golden drills); 0.0 = no throttle
    apply_delay_s: float = 0.0
    checkpointer: str = "checkmate"    # checkmate | sync | none
    ckpt_freq: int = 1
    channel: ChannelSpec = field(default_factory=ChannelSpec)
    schedule: FailureSchedule = field(default_factory=FailureSchedule)
    durability: DurabilitySpec = field(default_factory=DurabilitySpec)
    invariants: tuple[str, ...] = ()

    # -- construction helpers -------------------------------------------------
    def opt_config(self):
        from repro_torch.optim.functional import OptimizerConfig
        return OptimizerConfig(name=self.optimizer, lr=self.lr,
                               momentum=self.momentum)

    def validate(self) -> "Scenario":
        if self.level not in ("channel", "full"):
            raise ValueError(f"unknown level {self.level!r}")
        if self.seed < 0:
            raise ValueError(f"{self.name}: seed must be non-negative")
        if self.schedule.fabric and not self.channel.has_fabric:
            raise ValueError(
                f"{self.name}: fabric failures scheduled but channel "
                f"{self.channel.kind!r} has no fabric transport")
        if self.schedule.wedge_node is not None:
            if not self.shadow_async:
                raise ValueError(f"{self.name}: wedge_node requires an "
                                 f"async shadow cluster")
            if self.schedule.wedge_node >= self.shadow_nodes:
                raise ValueError(f"{self.name}: wedge_node out of range")
            if self.level != "channel":
                raise ValueError(f"{self.name}: wedge drills are "
                                 f"channel-level scenarios")
        if self.channel.sharded and self.channel.kind != "packetized":
            raise ValueError(f"{self.name}: sharded delivery is a "
                             f"packetized-transport feature")
        if self.channel.shadow_rails > max(1, self.shadow_nodes):
            raise ValueError(f"{self.name}: {self.channel.shadow_rails} "
                             f"shadow rails but only {self.shadow_nodes} "
                             f"shadow nodes to spread over them")
        if self.schedule.shadow_death:
            if not self.channel.sharded:
                raise ValueError(f"{self.name}: shadow_death needs a "
                                 f"sharded channel (per-owner delivery)")
            if self.level != "channel":
                raise ValueError(f"{self.name}: shadow_death drills are "
                                 f"channel-level scenarios")
            if self.schedule.wedge_node is not None:
                raise ValueError(f"{self.name}: shadow_death cannot "
                                 f"combine with a wedge drill")
            if self.schedule.train_fail_steps:
                raise ValueError(
                    f"{self.name}: shadow_death cannot combine with "
                    f"train_fail_steps — a dead shard makes shadow-only "
                    f"recovery partial (see recover(allow_partial=True))")
            for d in self.schedule.shadow_death:
                if d.phase not in ("step", "consolidate"):
                    raise ValueError(f"{self.name}: unknown death phase "
                                     f"{d.phase!r}")
                if not 0 <= d.node < self.shadow_nodes:
                    raise ValueError(f"{self.name}: shadow_death node "
                                     f"{d.node} out of range "
                                     f"0..{self.shadow_nodes - 1}")
                if not 1 <= d.step <= self.steps:
                    raise ValueError(f"{self.name}: shadow_death step "
                                     f"{d.step} outside 1..{self.steps}")
            if self.shadow_nodes < 2:
                raise ValueError(f"{self.name}: shadow_death needs >= 2 "
                                 f"shadow nodes (someone must survive)")
        if self.durability.enabled:
            if self.level != "channel":
                raise ValueError(f"{self.name}: durability tiers are "
                                 f"channel-level scenarios")
            if self.durability.every_steps < 1:
                raise ValueError(f"{self.name}: durability.every_steps "
                                 f"must be >= 1")
        if self.schedule.plane_loss:
            if not self.durability.enabled:
                raise ValueError(
                    f"{self.name}: plane_loss without durability tiers is "
                    f"unrecoverable — enable Scenario.durability")
            if not self.channel.sharded:
                raise ValueError(f"{self.name}: plane_loss drills drive a "
                                 f"sharded channel (per-owner routing)")
            if self.schedule.shadow_death or self.schedule.wedge_node \
                    is not None or self.schedule.train_fail_steps:
                raise ValueError(
                    f"{self.name}: plane_loss cannot combine with "
                    f"shadow_death / wedge / train_fail drills")
            if self.durability.compress:
                raise ValueError(
                    f"{self.name}: plane_loss needs raw (compress=False) "
                    f"flushes — a lossy restore cannot resume the trainer "
                    f"bit-identically")
            for p in self.schedule.plane_loss:
                if not 1 <= p.step <= self.steps:
                    raise ValueError(f"{self.name}: plane_loss step "
                                     f"{p.step} outside 1..{self.steps}")
        if self.schedule.tier_fail:
            if not self.durability.enabled:
                raise ValueError(f"{self.name}: tier_fail needs "
                                 f"durability tiers enabled")
            for t in self.schedule.tier_fail:
                if t.tier not in ("local-disk", "object-store"):
                    raise ValueError(f"{self.name}: unknown tier "
                                     f"{t.tier!r}")
                if t.tier == "object-store" \
                        and not self.durability.object_store:
                    raise ValueError(
                        f"{self.name}: tier_fail targets object-store but "
                        f"durability.object_store is off")
                if not 1 <= t.step <= self.steps:
                    raise ValueError(f"{self.name}: tier_fail step "
                                     f"{t.step} outside 1..{self.steps}")
        if self.schedule.train_node_loss:
            if self.checkpointer != "checkmate":
                raise ValueError(f"{self.name}: elastic shrink drills "
                                 f"drive a CheckmateCheckpointer")
            if self.schedule.wedge_node is not None \
                    or self.schedule.shadow_death:
                raise ValueError(
                    f"{self.name}: train_node_loss cannot combine with "
                    f"wedge / shadow_death drills — the shrink rebuilds "
                    f"the whole shadow plane")
            losses = self.schedule.train_node_loss
            world = self.channel.n_dp_groups * self.channel.ranks_per_group
            killed: set[int] = set()
            prev = 0
            for tl in losses:
                if not 1 <= tl.step <= self.steps:
                    raise ValueError(f"{self.name}: train_node_loss step "
                                     f"{tl.step} outside 1..{self.steps}")
                if tl.step <= prev:
                    raise ValueError(f"{self.name}: train_node_loss steps "
                                     f"must strictly increase")
                prev = tl.step
                if not tl.ranks:
                    raise ValueError(f"{self.name}: train_node_loss with "
                                     f"no ranks to kill")
                if len(set(tl.ranks)) != len(tl.ranks):
                    raise ValueError(f"{self.name}: duplicate ranks in "
                                     f"one train_node_loss")
                if self.level == "channel":
                    bad = [r for r in tl.ranks if not 0 <= r < world]
                    if bad:
                        raise ValueError(
                            f"{self.name}: train_node_loss ranks {bad} "
                            f"outside the original world 0..{world - 1}")
                    if killed & set(tl.ranks):
                        raise ValueError(
                            f"{self.name}: ranks "
                            f"{sorted(killed & set(tl.ranks))} killed "
                            f"twice across train_node_loss events")
                    killed |= set(tl.ranks)
            if self.level == "channel" and len(killed) >= world:
                raise ValueError(f"{self.name}: train_node_loss kills the "
                                 f"whole {world}-rank world — no survivor "
                                 f"can host the job")
            if self.level == "full" and len(losses) > 1:
                raise ValueError(f"{self.name}: full-level shrink drills "
                                 f"fire once (one FSDP flip)")
        if self.apply_delay_s < 0:
            raise ValueError(f"{self.name}: apply_delay_s must be >= 0")
        if self.apply_delay_s and self.level != "channel":
            raise ValueError(f"{self.name}: slow-apply throttles are "
                             f"channel-level scenarios")
        if self.max_lag_steps is not None:
            if self.max_lag_steps < 1:
                raise ValueError(f"{self.name}: max_lag_steps must be >= 1")
            if not self.shadow_async:
                raise ValueError(f"{self.name}: max_lag_steps bounds the "
                                 f"async delivery queue — requires "
                                 f"shadow_async")
            # bounded-lag runs consolidate only at the END (consolidating
            # every step would drain the backlog the drill exists to
            # build), so drills that need per-step consolidation or
            # per-step flush settlement cannot combine with it
            if (self.schedule.wedge_node is not None
                    or self.schedule.shadow_death
                    or self.schedule.plane_loss
                    or self.schedule.train_node_loss
                    or self.durability.enabled):
                raise ValueError(
                    f"{self.name}: max_lag_steps cannot combine with wedge "
                    f"/ shadow_death / plane_loss / elastic / durability "
                    f"drills — those settle the shadow plane every step, "
                    f"which defeats the lag bound under test")
        if self.checkpointer != "checkmate" and self.level == "channel":
            raise ValueError(f"{self.name}: channel-level scenarios drive "
                             f"a CheckmateCheckpointer")
        bad = [s for s in self.schedule.fabric_steps
               if not 1 <= s <= self.steps]
        if bad:
            raise ValueError(f"{self.name}: fabric failure steps {bad} "
                             f"outside 1..{self.steps}")
        bad = [s for s in self.schedule.train_fail_steps
               if not 1 <= s <= self.steps]
        if bad:
            raise ValueError(f"{self.name}: train failure steps {bad} "
                             f"outside 1..{self.steps} — they would never "
                             f"fire")
        return self

    # -- JSON round trip ------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        d["channel"] = ChannelSpec(**d.get("channel", {}))
        sched = dict(d.get("schedule", {}))
        sched["train_fail_steps"] = tuple(sched.get("train_fail_steps", ()))
        sched["fabric"] = tuple(
            FabricFailure(**{**f, "target": tuple(f["target"])
                             if isinstance(f.get("target"), list)
                             else f.get("target")})
            for f in sched.get("fabric", ()))
        sched["shadow_death"] = tuple(
            ShadowDeath(**s) for s in sched.get("shadow_death", ()))
        sched["plane_loss"] = tuple(
            ShadowPlaneLoss(**p) for p in sched.get("plane_loss", ()))
        sched["tier_fail"] = tuple(
            TierFailure(**t) for t in sched.get("tier_fail", ()))
        sched["train_node_loss"] = tuple(
            TrainNodeLoss(**{**t, "ranks": tuple(t.get("ranks", (0,)))})
            for t in sched.get("train_node_loss", ()))
        d["schedule"] = FailureSchedule(**sched)
        d["durability"] = DurabilitySpec(**d.get("durability", {}))
        d["invariants"] = tuple(d.get("invariants", ()))
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))


# -- random scenarios from one integer ---------------------------------------

def sample_scenario(seed: int, level: str | None = None) -> Scenario:
    """Deterministically expand one integer into a valid random scenario.

    The whole scenario space the golden corpus spans is sampled here:
    channel kind x topology x DP shape x optimizer x sharded shadow
    routing x failure classes (captures, bursts, hardware kills,
    shadow-node deaths, training failures, multi-failure sequences).
    Every sampled scenario must PASS all auto-selected invariants — a
    violation is a real bug, and the CLI writes its repro bundle.
    """
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF      # negative CLI seeds wrap
    rng = np.random.default_rng(seed)
    if level is None:
        level = "full" if rng.random() < 0.2 else "channel"
    steps = int(rng.integers(4, 8))

    kind = str(rng.choice(["inprocess", "packetized", "packetized",
                           "compressed"]))
    inner = ("packetized" if kind == "compressed" and rng.random() < 0.4
             else "inprocess")
    topology = str(rng.choice(["single", "rail-optimized", "leaf-spine"]))
    spec = ChannelSpec(
        kind=kind, inner=inner, topology=topology,
        n_dp_groups=int(rng.choice([1, 2])),
        ranks_per_group=int(rng.choice([2, 4])),
        ranks_per_leaf=4,
        replication_factor=int(rng.choice([1, 1, 2])))

    if kind == "compressed" and rng.random() < 0.5:
        optimizer, momentum = "sgd", 0.0    # the sharp EF-bound regime
    else:
        optimizer = str(rng.choice(["adamw", "adam", "sgd"]))
        momentum = 0.9

    fabric: list[FabricFailure] = []
    if spec.has_fabric and steps >= 2:
        r = rng.random()
        s = int(rng.integers(2, steps + 1))
        if r < 0.30:                                    # one lost capture
            fabric.append(FabricFailure(step=s, kind="capture"))
        elif r < 0.45 and s < steps:                    # gated-capture burst
            fabric += [FabricFailure(step=s, kind="capture"),
                       FabricFailure(step=s + 1, kind="capture")]
        elif r < 0.70:                                  # hardware kill(s)
            at = float(round(rng.uniform(0.0, 200.0), 1))
            if topology == "single":
                fabric.append(FabricFailure(step=s, kind="shadow_nic",
                                            target="s0", at_us=at))
            else:
                hw = str(rng.choice(["switch", "link", "shadow_nic"]))
                target = {"switch": "spine0",
                          "link": ("leaf0", "spine0"),
                          "shadow_nic": "s0"}[hw]
                fabric.append(FabricFailure(step=s, kind=hw, target=target,
                                            at_us=at))
                if rng.random() < 0.3:                  # multi-failure seq
                    fabric.append(FabricFailure(
                        step=s, kind="switch", target="spine1",
                        at_us=at + 20.0))

    train_fails: tuple[int, ...] = ()
    if rng.random() < 0.4:
        train_fails = (int(rng.integers(2, steps + 1)),)

    shadow_nodes = int(rng.integers(1, 4))
    deaths: tuple[ShadowDeath, ...] = ()
    if kind == "packetized" and rng.random() < 0.3:   # bucket-sharded owners
        spec = dataclasses.replace(
            spec, sharded=True,
            shadow_rails=int(rng.integers(1, min(shadow_nodes, 2) + 1)))
        if (level == "channel" and shadow_nodes >= 2 and not train_fails
                and rng.random() < 0.5):
            deaths = (ShadowDeath(
                step=int(rng.integers(2, steps + 1)),
                node=int(rng.integers(0, shadow_nodes)),
                phase=str(rng.choice(["step", "consolidate"]))),)

    # draw order matters: these were the Scenario(...) argument draws
    # before durability existed — new draws must append strictly AFTER
    # them so every pre-existing seed expands to the same scenario fields
    n_leaves = int(rng.integers(2, 5))
    cap_bytes = int(rng.choice([1024, 4096, 1 << 16]))
    resync = bool(rng.random() < 0.5)
    shadow_async = bool(level == "channel" and rng.random() < 0.25)

    durability = DurabilitySpec()
    plane_loss: tuple[ShadowPlaneLoss, ...] = ()
    tier_fail: tuple[TierFailure, ...] = ()
    if level == "channel" and spec.sharded and rng.random() < 0.5:
        obj = bool(rng.random() < 0.5)
        durability = DurabilitySpec(
            enabled=True,
            every_steps=int(rng.choice([1, 1, 2])),
            compress=bool(rng.random() < 0.25),
            rebase_every=int(rng.choice([2, 4])),
            object_store=obj)
        if (not fabric and not deaths and not train_fails
                and steps >= 2 and rng.random() < 0.5):
            plane_loss = (ShadowPlaneLoss(
                step=int(rng.integers(2, steps + 1))),)
            if durability.compress:       # lossy restore can't resume
                durability = dataclasses.replace(durability,
                                                 compress=False)
        if obj and rng.random() < 0.3:
            tier_fail = (TierFailure(step=int(rng.integers(1, steps + 1)),
                                     tier="local-disk"),)

    # elastic shrink drills (append-only draws: everything above must keep
    # its draw order so pre-existing seeds expand identically)
    node_loss: tuple[TrainNodeLoss, ...] = ()
    world = spec.n_dp_groups * spec.ranks_per_group
    if (level == "channel" and world >= 4 and steps >= 3
            and not fabric and not deaths and not train_fails
            and not plane_loss and not tier_fail
            and rng.random() < 0.25):
        n_kill = int(rng.integers(1, world // 2 + 1))
        ranks = tuple(sorted(int(r) for r in rng.choice(
            world, size=n_kill, replace=False)))
        node_loss = (TrainNodeLoss(step=int(rng.integers(2, steps + 1)),
                                   ranks=ranks),)

    # fabric engine + bounded shadow lag (append-only draws, same rule as
    # above: nothing before this point may change its draw order)
    if spec.has_fabric and rng.random() < 0.5:
        spec = dataclasses.replace(spec, fast=True)   # calendar-queue engine
    max_lag_steps = None
    if (shadow_async and not deaths and not plane_loss and not tier_fail
            and not durability.enabled and not node_loss
            and rng.random() < 0.5):
        max_lag_steps = int(rng.integers(1, 5))

    return Scenario(
        name=f"sampled-{seed}", level=level, seed=int(seed) & 0x7FFFFFFF,
        steps=steps,
        n_leaves=n_leaves,
        cap_bytes=cap_bytes,
        resync=resync,
        optimizer=optimizer, momentum=momentum,
        shadow_nodes=shadow_nodes,
        shadow_async=shadow_async,
        max_lag_steps=max_lag_steps,
        channel=spec,
        schedule=FailureSchedule(train_fail_steps=train_fails,
                                 fabric=tuple(fabric),
                                 shadow_death=deaths,
                                 plane_loss=plane_loss,
                                 tier_fail=tier_fail,
                                 train_node_loss=node_loss),
        durability=durability,
    ).validate()


def scenario_strategy(level: str = "channel"):
    """A hypothesis strategy over valid random scenarios (works with the
    deterministic fallback too — it only needs integers().map)."""
    from hypothesis import strategies as st
    return st.integers(0, 2 ** 20).map(
        lambda s: sample_scenario(s, level=level))
