"""Deterministic chaos co-simulation runner — the port of
``repro.harness.runner``.

`run_scenario` drives one declarative `Scenario` through the port's stack —
checkpointer -> GradientChannel -> fabric simulator -> shadow plane ->
durability -> recovery — while a reference trainer runs beside it, and
evaluates the invariant registry (`repro_torch.harness.invariants`) after
every step. Two stack depths:

* channel level — a synthetic gradient stream (numpy, a pure function of
  the scenario seed, so both packages see the same stream) through a
  `CheckmateCheckpointer`, with the reference trainer applying the same
  update the port's trainer applies (`optim.functional.apply_updates`: on
  the card one fused AdamW launch per leaf, the kernel the shadow runs per
  bucket) to the raw gradients on the scenario's device; training-node
  failures rewind the reference onto ``restore()``, elastic shrinks
  rebuild the shadow plane (`repro_torch.core.elastic`).
* full level — the port's `repro_torch.train.loop.train` on a model
  config (the reference's ``.reduced()`` unless ``cfg`` is given),
  observed through its ``step_hook``; an uninterrupted reference run from
  the same initial state provides the bit-identity targets. A full-level
  elastic shrink (``elastic-fsdp-flip``) needs sharding rules the port
  has not got: it raises `NotImplementedError` (ROADMAP item 11).

Everything runs on ``device``: the card unless the caller passes
``device="cpu"``. On violation the runner emits a minimal repro bundle —
scenario JSON + seed + failing step — that `replay_bundle` re-runs and
compares bit-identically; the bundle format is the reference's, so a
bundle replays on either package.
"""
from __future__ import annotations

import dataclasses
import json
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch import obs as _obs
from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.channel import StepEvent
from repro_torch.core.checkpoint import (CheckmateCheckpointer,
                                         NoCheckpointer, SyncCheckpointer)
from repro_torch.core.costmodel import ElasticMeshBudget, plan_elastic_mesh
from repro_torch.core.elastic import rebuild_shadow
from repro_torch.core.recovery import (FailurePlan, checkpoint_from_state,
                                       state_from_checkpoint)
from repro_torch.core.shadow import (ConsolidationTimeout, ShadowCluster,
                                     ShadowNodeLoss)
from repro_torch.device import resolve
from repro_torch.harness import invariants as inv
from repro_torch.harness.scenario import Scenario
from repro_torch.optim.functional import apply_updates
from repro_torch.train.loop import train
from repro_torch.train.step import make_train_state

WEDGE_TIMEOUT_S = 0.25      # the deadline the wedged consolidate must honor
WEDGE_RETRY_S = 30.0        # post-release retry budget


@dataclass
class SendRecord:
    """One ``channel.send``: the stall it reported vs the wall it took,
    plus the channel's per-stage decomposition of the reported value
    (``last_send_parts`` — its in-order sum must equal ``reported``
    bit-exactly, checked by the stall-attribution invariant)."""
    step: int
    reported: float
    wall_s: float
    parts: dict = field(default_factory=dict)


@dataclass
class PollRecord:
    """One delivery as the shadow side saw it."""
    step: int
    complete: bool
    missing_captures: int
    fabric: object          # FabricResult for packetized transports
    node_complete: Optional[dict] = None   # sharded: per-owner verdicts


class InstrumentedChannel:
    """Transparent `GradientChannel` wrapper recording every send/poll —
    the harness's observation point on the delivery edge."""

    def __init__(self, inner):
        self.inner = inner
        self.name = getattr(inner, "name", "channel")
        self._sends: list[SendRecord] = []
        self._polls: list[PollRecord] = []

    @property
    def device_flats(self) -> bool:
        """Forward the inner channel's wish for device buckets, so the
        training loop's capture hands it what it would hand the inner."""
        return getattr(self.inner, "device_flats", False)

    def open(self, layout):
        self.inner.open(layout)

    def send(self, event) -> float:
        t0 = time.perf_counter()
        reported = self.inner.send(event)
        self._sends.append(SendRecord(
            event.step, float(reported or 0.0), time.perf_counter() - t0,
            parts=dict(getattr(self.inner, "last_send_parts", None) or {})))
        return reported

    @property
    def last_send_parts(self) -> dict:
        """Forward the inner channel's stall decomposition so the
        checkpointer's attribution sees through the wrapper."""
        return getattr(self.inner, "last_send_parts", {})

    def poll(self):
        out = self.inner.poll()
        self._polls.extend(
            PollRecord(d.step, d.complete, d.missing_captures,
                       getattr(d, "fabric", None),
                       getattr(d, "node_complete", None)) for d in out)
        return out

    def kill_shadow_node(self, node_id: int):
        self.inner.kill_shadow_node(node_id)

    def revive_all(self):
        fn = getattr(self.inner, "revive_all", None)
        if fn is not None:
            fn()

    def close(self):
        self.inner.close()

    def take_sends(self) -> list[SendRecord]:
        out, self._sends = self._sends, []
        return out

    def take_polls(self) -> list[PollRecord]:
        out, self._polls = self._polls, []
        return out


@dataclass
class StepRecord:
    """Everything the invariants see about one executed iteration."""
    step: int
    stall: float = 0.0
    loss: Optional[float] = None
    shadow_step: Optional[int] = None    # consolidated shadow step after
    gated: bool = False                  # skipped_steps grew this on_step
    applied: bool = False                # a delivery advanced the shadow
    partial_applied: bool = False        # sharded: survivors-only apply
    shadow_missing: Optional[dict] = None  # node -> buckets lost with it
    dead_nodes: tuple = ()               # dead owners at this consolidate
    resync: bool = False                 # healed via full-state copy
    shadow_lag: Optional[int] = None     # async applier backlog after ingest
    restored_step: Optional[int] = None  # a restore() ran just before this
    plane_restore: bool = False          # ...and it came from the tiers
    elastic: bool = False                # ...and it landed on a shrunken mesh
    first_seen: bool = True              # False = replay after a recovery
    sends: list = field(default_factory=list)
    polls: list = field(default_factory=list)
    state: Optional[dict] = None         # trainer checkpoint after this step
    shadow_ckpt: Optional[dict] = None   # cleared after per-step checks


class Trace:
    """The run's observable history, shared with every invariant. Trees
    (``states``, ``final``, ``ref_final``, ``final_shadow``) are host
    tensors."""

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self.records: list[StepRecord] = []
        self.states: dict[int, dict] = {}    # step -> first-seen trainer ckpt
        self.ref_losses: Optional[list] = None
        self.ref_final: Optional[dict] = None
        self.final: Optional[dict] = None
        self.final_shadow: Optional[dict] = None
        self.bootstrap_step = 0
        self.checkpointer = None
        self.channel: Optional[InstrumentedChannel] = None
        self.compressor = None
        self.wedge: Optional[dict] = None
        self.shadow_partition: Optional[dict] = None  # node -> buckets/leaves
        self.layout = None                   # the run's BucketLayout
        self.durability = None               # DurableShadow when enabled
        self.tiers: list = []                # its Tier objects
        self.plane_losses: list[dict] = []   # total-loss drills, as observed
        self.elastic_events: list[dict] = []  # shrink drills, as observed
        self.shadow_stats = None             # final ShadowStats (channel lvl)
        self.dur_tmpdir = None               # local-disk tier root; cleaned
        #                                      by run_scenario AFTER end-of-
        #                                      run invariants read the tier
        self.stats = None
        self.violations: list[inv.Violation] = []
        # steps where injected failures make fabric-level loss legitimate.
        # A shadow-node death keeps losing that owner's mirrors on every
        # later send, so every step from the death onward counts (an
        # over-approximation once a resync revives the transport — the
        # death invariant checks those steps precisely).
        fs = set(scenario.schedule.fabric_steps)
        for d in scenario.schedule.shadow_death:
            first = d.step if d.phase == "step" else d.step + 1
            fs.update(range(first, scenario.steps + 1))
        self.fabric_steps = frozenset(fs)


class _Engine:
    """Evaluates the selected invariants per step and at the end. A forced
    selection (``Scenario.invariants``) bypasses ``applies()`` — that is
    how an inapplicable check demonstrates the violation-bundle path."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self.forced = bool(trace.scenario.invariants)
        self.invariants = inv.select(trace)

    def _active(self, i) -> bool:
        return self.forced or i.applies(self.trace)

    def step(self, rec: StepRecord):
        for i in self.invariants:
            if self._active(i):
                self.trace.violations.extend(i.check_step(self.trace, rec))

    def end(self):
        for i in self.invariants:
            if self._active(i):
                self.trace.violations.extend(i.check_end(self.trace))


@dataclass
class ScenarioResult:
    scenario: Scenario
    violations: tuple[inv.Violation, ...]
    trace: Trace
    bundle_path: Optional[Path] = None
    # Chrome trace_event JSON of the run's trailing trace window (the
    # runner's ring tracer); NOT part of bundle() — bundles must compare
    # bit-identically across replays, and trace timings are wall clock
    trace_export: Optional[dict] = None

    @property
    def passed(self) -> bool:
        return not self.violations

    @property
    def failing_step(self) -> Optional[int]:
        steps = [v.step for v in self.violations if v.step is not None]
        return min(steps) if steps else None

    def bundle(self) -> dict:
        """The minimal replayable repro: seed + scenario + failing step."""
        return {"seed": self.scenario.seed,
                "scenario": self.scenario.to_dict(),
                "failing_step": self.failing_step,
                "violations": [v.to_dict() for v in self.violations]}

    def describe(self) -> str:
        sc = self.scenario
        tag = "PASS" if self.passed else f"FAIL@{self.failing_step}"
        extra = ""
        if self.violations:
            v = self.violations[0]
            extra = f"  [{v.invariant}] {v.message}"
        return (f"{tag:<8} {sc.name:<34} {sc.level:<7} "
                f"{sc.channel.kind:<11} steps={sc.steps}{extra}")


# -- bundles ------------------------------------------------------------------

TRACE_TAIL_EVENTS = 64          # trailing trace window embedded in bundles


def write_bundle(result: ScenarioResult, bundle_dir) -> Path:
    """Write the repro bundle to disk. The on-disk JSON adds the trailing
    trace window (``trace_tail``) for triage — ``bundle()`` itself stays
    wall-clock-free so replays compare bit-identically — and the full
    trace export lands beside it as ``<name>.trace.json``."""
    bundle_dir = Path(bundle_dir)
    bundle_dir.mkdir(parents=True, exist_ok=True)
    path = bundle_dir / f"{result.scenario.name}.json"
    d = result.bundle()
    if result.trace_export is not None:
        events = result.trace_export.get("traceEvents", [])
        d["trace_tail"] = events[-TRACE_TAIL_EVENTS:]
        (bundle_dir / f"{result.scenario.name}.trace.json").write_text(
            json.dumps(result.trace_export, indent=1, sort_keys=True))
    path.write_text(json.dumps(d, indent=2, sort_keys=True))
    return path


def replay_bundle(path, *, device=None) -> tuple[ScenarioResult, bool]:
    """Re-run a violation bundle's scenario on ``device``; True iff the
    violations reproduce bit-identically (same invariants, steps, and
    messages)."""
    stored = json.loads(Path(path).read_text())
    result = run_scenario(Scenario.from_dict(stored["scenario"]),
                          device=device)
    fresh = result.bundle()
    identical = (fresh["violations"] == stored["violations"]
                 and fresh["failing_step"] == stored["failing_step"])
    return result, identical


# -- channel-level co-simulation ----------------------------------------------

def _grads_at(sc: Scenario, params: dict, step: int) -> dict:
    """The synthetic gradient stream: a pure function of (seed, step), so
    recovery replays the identical stream (the reference's numpy draws)."""
    rng = np.random.default_rng((sc.seed + 1) * 1_000_003 + step)
    return {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
            for k, v in params.items()}


def _partition(shadow: ShadowCluster) -> dict:
    """node -> its buckets and the leaves they hold (layout order)."""
    out = {}
    for n in shadow.nodes:
        ids = set(n.bucket_ids)
        out[n.node_id] = {"buckets": list(n.bucket_ids),
                          "leaves": [s.name for b in shadow.layout.buckets
                                     if b.bucket_id in ids for s in b.slots]}
    return out


def _install_wedge(shadow, node_id: int, release_s: float):
    node = shadow.nodes[node_id]
    original = node.apply
    release = time.time() + release_s

    def wedged(*a, **kw):
        while time.time() < release:
            time.sleep(0.01)
        return original(*a, **kw)

    node.apply = wedged


def _install_throttle(shadow, delay_s: float):
    """Make every shadow apply deliberately slow (the slow-apply drills).
    Wraps ``_apply`` (not ``apply``) so both the single and the batched
    (`apply_batch`) paths pay the delay per replayed step."""
    for node in shadow.nodes:
        original = node._apply

        def slowed(*a, _orig=original, **kw):
            time.sleep(delay_s)
            return _orig(*a, **kw)

        node._apply = slowed


def _run_channel(sc: Scenario, trace: Trace, engine: _Engine,
                 device: torch.device):
    rng = np.random.default_rng(np.uint64(sc.seed))
    params = {f"leaf{k}": torch.from_numpy(rng.standard_normal(
                  (6 + 2 * k, sc.leaf_cols)).astype(np.float32))
              for k in range(sc.n_leaves)}
    layout = layout_for_tree(params, cap_bytes=sc.cap_bytes)
    opt = sc.opt_config()
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}

    shadow = ShadowCluster(layout, opt, n_nodes=sc.shadow_nodes,
                           async_mode=sc.shadow_async,
                           max_lag_steps=sc.max_lag_steps, device=device)
    if sc.apply_delay_s:
        _install_throttle(shadow, sc.apply_delay_s)
    trace.layout = layout
    dur = None
    if sc.durability.enabled:
        from repro_torch.durability import (DurableShadow, FlushPolicy,
                                            LocalDiskTier, ObjectStoreTier)

        # attach BEFORE bootstrap so the seed replica gets its base epoch
        trace.dur_tmpdir = tempfile.TemporaryDirectory(
            prefix="repro-torch-dur-")
        tiers = [LocalDiskTier(trace.dur_tmpdir.name)]
        if sc.durability.object_store:
            tiers.append(ObjectStoreTier(
                latency_s=sc.durability.object_latency_s))
        for tf in sc.schedule.tier_fail:
            for t in tiers:
                if t.name == tf.tier:
                    t.fail_steps.add(tf.step)
        dur = DurableShadow(tiers, FlushPolicy(
            every_steps=sc.durability.every_steps,
            compress=sc.durability.compress,
            rebase_every=sc.durability.rebase_every)).attach(shadow)
        trace.durability, trace.tiers = dur, tiers
    shadow.bootstrap(params, zeros, zeros, 0)
    # the seed replica is a state too: a tier restore may land on it
    trace.states.setdefault(
        0, {"params": params, "mu": zeros, "nu": zeros, "step": 0})
    trace.shadow_partition = _partition(shadow)
    chan = InstrumentedChannel(sc.channel.build(
        sc.schedule.failures_at(), n_shadow_nodes=sc.shadow_nodes))
    ck = CheckmateCheckpointer(shadow, channel=chan)
    trace.checkpointer, trace.channel = ck, chan
    trace.compressor = getattr(chan.inner, "compressor", None)

    # the reference trainer: the port trainer's update over the RAW stream
    def as_state(p, m, v, step):
        return state_from_checkpoint(
            {"params": p, "mu": m, "nu": v, "step": step}, device)

    state = as_state(params, zeros, zeros, 0)
    pending_restore: Optional[int] = None
    pending_plane = False
    pending_elastic = False
    fails = set(sc.schedule.train_fail_steps)
    planes = {p.step for p in sc.schedule.plane_loss}
    shrinks = {t.step: t for t in sc.schedule.train_node_loss}
    # the train-side world the channel models; shrink drills cut it down
    world_ranks = list(range(sc.channel.n_dp_groups
                             * sc.channel.ranks_per_group))
    last_ckpt = None
    step, executed = 0, 0
    try:
        while step < sc.steps:
            executed += 1
            if executed > 6 * sc.steps + 12:
                raise RuntimeError(f"{sc.name}: runaway recovery loop")
            nxt = step + 1
            if nxt in fails:                 # training node dies mid-step
                fails.discard(nxt)
                restored = ck.restore()
                state = as_state(restored["params"], restored["mu"],
                                 restored["nu"], restored["step"])
                pending_restore = int(restored["step"])
                step = int(restored["step"])
                continue
            deaths = [d for d in sc.schedule.shadow_death if d.step == nxt]
            for d in deaths:            # phase "step": dies before the send
                if d.phase == "step":
                    chan.kill_shadow_node(d.node)
                    shadow.kill_node(d.node)
            grads = {k: torch.from_numpy(g).to(device)
                     for k, g in _grads_at(sc, params, nxt).items()}
            state = apply_updates(state, grads, opt, sc.lr)
            ckpt = checkpoint_from_state(state)
            wedged = (sc.schedule.wedge_node is not None and nxt == sc.steps)
            if wedged:
                _install_wedge(shadow, sc.schedule.wedge_node,
                               sc.schedule.wedge_release_s)
            before = (ck.n_checkpoints, len(ck.skipped_steps),
                      len(ck.resyncs), len(ck.partial_steps))
            stall = ck.on_step(StepEvent(
                step=nxt, grads=grads, lr=sc.lr,
                state_fn=(lambda c=ckpt: c) if sc.resync else None))
            if dur is not None:
                # settle this step's flush epoch (harness time, never the
                # trainer's) so the invariants see the tiers as of step nxt
                dur.drain()

            rec = StepRecord(step=nxt, stall=stall)
            if sc.shadow_async:
                # backlog sample point: right after ingest, before any
                # consolidation settles it — the apply-lag-bound invariant
                # checks this never exceeds max_lag_steps
                rec.shadow_lag = int(shadow.stats().lag)
            rec.resync = len(ck.resyncs) > before[2]
            rec.gated = len(ck.skipped_steps) > before[1]
            rec.applied = ck.n_checkpoints > before[0] and not rec.resync
            rec.partial_applied = len(ck.partial_steps) > before[3]
            rec.restored_step, pending_restore = pending_restore, None
            rec.plane_restore, pending_plane = pending_plane, False
            rec.elastic, pending_elastic = pending_elastic, False
            rec.sends, rec.polls = chan.take_sends(), chan.take_polls()
            for d in deaths:            # phase "consolidate": dies between
                if d.phase == "consolidate":    # the apply and the gather
                    chan.kill_shadow_node(d.node)
                    shadow.kill_node(d.node)
            if wedged:
                # the deadline drill replaces this step's consolidate
                try:
                    shadow.consolidate(timeout=WEDGE_TIMEOUT_S)
                    raised, lagging, partial = False, [], -1
                except ConsolidationTimeout as e:
                    raised, lagging = True, list(e.lagging_nodes)
                    partial = int(e.partial["step"])
                shadow_ck = shadow.consolidate(timeout=WEDGE_RETRY_S)
                trace.wedge = {"raised": raised, "lagging": lagging,
                               "partial_step": partial,
                               "final_step": int(shadow_ck["step"])}
            elif sc.max_lag_steps is not None and nxt < sc.steps:
                # bounded-lag drill: consolidating every step would drain
                # the very backlog the bound exists to absorb — settle only
                # at the final step (bit-identity is still checked there,
                # and the per-step lag bound via rec.shadow_lag)
                shadow_ck = None
            else:
                try:
                    shadow_ck = shadow.consolidate()
                except ShadowNodeLoss as e:
                    # dead owners: the gather serves the survivors' shards
                    # and names exactly the dead buckets as missing
                    shadow_ck = e.partial
                    rec.shadow_missing = {
                        int(n): tuple(int(b) for b in bids)
                        for n, bids in e.missing_buckets.items()}
                    rec.dead_nodes = tuple(sorted(e.dead_nodes))
            if shadow_ck is not None:
                rec.shadow_step = int(shadow_ck["step"])
                rec.shadow_ckpt = shadow_ck
                trace.final_shadow = shadow_ck
            rec.state = ckpt
            rec.first_seen = nxt not in trace.states
            if rec.first_seen:
                trace.states[nxt] = ckpt
            trace.records.append(rec)
            engine.step(rec)
            rec.shadow_ckpt = None          # free the per-step tree
            if not rec.first_seen:          # replays: first-seen copy is
                rec.state = None            # already kept in trace.states
            last_ckpt = ckpt
            step = nxt
            if nxt in shrinks:      # train ranks die AFTER the step: shrink
                tl = shrinks.pop(nxt)
                if dur is not None:
                    dur.drain()     # settle in-flight epochs pre-migration
                restored = ck.restore()          # books consolidate-wait
                survivors = [r for r in world_ranks
                             if r not in set(tl.ranks)]
                plan = plan_elastic_mesh(survivors, ElasticMeshBudget())
                old_world, new_world = len(world_ranks), plan.n_ranks
                world_ranks = list(plan.survivors)
                # the shrunken channel geometry: keep the group size if the
                # new world still fills whole groups, else keep the group
                # count, else collapse to one group of survivors
                if new_world % sc.channel.ranks_per_group == 0:
                    geo = (new_world // sc.channel.ranks_per_group,
                           sc.channel.ranks_per_group)
                elif new_world % sc.channel.n_dp_groups == 0:
                    geo = (sc.channel.n_dp_groups,
                           new_world // sc.channel.n_dp_groups)
                else:
                    geo = (1, new_world)
                remaining = {s: f for s, f
                             in sc.schedule.failures_at().items() if s > nxt}
                spec = dataclasses.replace(
                    sc.channel, n_dp_groups=geo[0], ranks_per_group=geo[1],
                    ranks_per_leaf=min(sc.channel.ranks_per_leaf, geo[1]))
                new_chan = InstrumentedChannel(
                    spec.build(remaining, n_shadow_nodes=sc.shadow_nodes))
                # the bucket layout + ownership map are re-derived for the
                # new world; durability migrates (reattach) and the rebuilt
                # plane cuts a fresh base at the resume step
                shadow = rebuild_shadow(shadow, restored,
                                        n_nodes=sc.shadow_nodes,
                                        cap_bytes=sc.cap_bytes,
                                        device=device)
                layout = shadow.layout
                ck.reconfigure(shadow, channel=new_chan)  # elastic-reshard
                chan = new_chan
                trace.channel, trace.layout = chan, layout
                trace.compressor = getattr(chan.inner, "compressor", None)
                trace.shadow_partition = _partition(shadow)
                trace.elastic_events.append({
                    "step": nxt, "killed": sorted(tl.ranks),
                    "old_world": old_world, "new_world": new_world,
                    "dp": plan.dp, "fsdp": plan.fsdp,
                    "survivors": list(plan.survivors),
                    "geometry": list(geo),
                    "resumed_step": int(restored["step"])})
                state = as_state(restored["params"], restored["mu"],
                                 restored["nu"], restored["step"])
                pending_restore = int(restored["step"])
                pending_elastic = True
                step = int(restored["step"])
            if nxt in planes:       # total shadow-plane loss AFTER the step
                planes.discard(nxt)
                from repro_torch.durability.restore import restore_from_tiers
                dur.drain()         # everything notified so far is durable
                for n in shadow.nodes:
                    chan.kill_shadow_node(n.node_id)
                    shadow.kill_node(n.node_id)
                try:
                    shadow.consolidate()
                    raise RuntimeError(f"{sc.name}: the whole plane is dead "
                                       f"but consolidate served a checkpoint")
                except ShadowNodeLoss as e:
                    trace.plane_losses.append({
                        "step": nxt, "total": bool(e.total),
                        "durable_hint": e.durable_hint,
                        "dead_nodes": sorted(e.dead_nodes)})
                restored = restore_from_tiers(dur.tiers, layout,
                                              n_nodes=sc.shadow_nodes)
                trace.plane_losses[-1]["restored_step"] = int(restored["step"])
                # both planes rewind to the newest durable step: the trainer
                # resumes there and the shadow re-seeds from the same state
                # (bootstrap revives the dead nodes and cuts a fresh base)
                state = as_state(restored["params"], restored["mu"],
                                 restored["nu"], restored["step"])
                shadow.bootstrap(restored["params"], restored["mu"],
                                 restored["nu"], int(restored["step"]))
                chan.revive_all()
                ck._desynced = ck._dead_desynced = False
                pending_restore = int(restored["step"])
                pending_plane = True
                step = int(restored["step"])
        trace.final = last_ckpt
    finally:
        trace.shadow_stats = shadow.stats()
        chan.close()
        if dur is not None:
            dur.drain()
            dur.close()             # idempotent vs shutdown()'s own close
        if sc.shadow_async:
            shadow.shutdown()


# -- full-stack co-simulation -------------------------------------------------

def _run_full(sc: Scenario, trace: Trace, engine: _Engine,
              device: torch.device, cfg=None):
    if sc.schedule.train_node_loss:
        raise NotImplementedError(
            f"{sc.name}: a full-level train_node_loss restores onto "
            f"FSDP-flipped sharding rules (ShardingRules(fsdp=), "
            f"train(elastic_rules=)), which the port has not got yet — "
            f"ROADMAP item 11")
    cfg = cfg if cfg is not None else configs.get(sc.arch).reduced()
    opt = sc.opt_config()

    def lr_fn(_):
        return sc.lr

    # uninterrupted reference from the seed's state: the bit-identity target
    ref_state, ref_stats = train(
        cfg, steps=sc.steps, batch=sc.batch, seq=sc.seq, opt=opt,
        lr_fn=lr_fn, seed=sc.seed,
        state=make_train_state(cfg, sc.seed, device), device=device)
    trace.ref_losses = list(ref_stats.losses)
    trace.ref_final = checkpoint_from_state(ref_state)
    del ref_state

    s0 = make_train_state(cfg, sc.seed, device)
    shadow = None
    if sc.checkpointer == "checkmate":
        shadow = ShadowCluster(layout_for_tree(s0.params), opt,
                               n_nodes=sc.shadow_nodes,
                               async_mode=sc.shadow_async,
                               max_lag_steps=sc.max_lag_steps, device=device)
        shadow.bootstrap(s0.params, s0.mu, s0.nu, 0)
        chan = InstrumentedChannel(sc.channel.build(
            sc.schedule.failures_at(), n_shadow_nodes=sc.shadow_nodes))
        ck = CheckmateCheckpointer(shadow, channel=chan)
        trace.channel = chan
        trace.compressor = getattr(chan.inner, "compressor", None)
    elif sc.checkpointer == "sync":
        ck = SyncCheckpointer(freq=sc.ckpt_freq)
    else:
        ck = NoCheckpointer()
    trace.checkpointer = ck

    seen = {"ncp": 0, "skip": 0, "resync": 0, "recov": 0}

    def hook(step, state, stats):
        rec = StepRecord(step=step, stall=stats.stall_times[-1],
                         loss=stats.losses[-1])
        if stats.recoveries > seen["recov"]:
            seen["recov"] = stats.recoveries
            rec.restored_step = stats.recovered_at[-1]
        if shadow is not None:
            rec.resync = len(ck.resyncs) > seen["resync"]
            rec.gated = len(ck.skipped_steps) > seen["skip"]
            rec.applied = ck.n_checkpoints > seen["ncp"] and not rec.resync
            seen.update(ncp=ck.n_checkpoints, skip=len(ck.skipped_steps),
                        resync=len(ck.resyncs))
            shadow_ck = ck.shadow.consolidate()
            rec.shadow_step = int(shadow_ck["step"])
            rec.shadow_ckpt = shadow_ck
            trace.final_shadow = shadow_ck
        if trace.channel is not None:
            rec.sends = trace.channel.take_sends()
            rec.polls = trace.channel.take_polls()
        rec.state = checkpoint_from_state(state)
        rec.first_seen = step not in trace.states
        if rec.first_seen:
            trace.states[step] = rec.state
        trace.records.append(rec)
        engine.step(rec)
        rec.shadow_ckpt = None
        if not rec.first_seen:              # replays: first-seen copy is
            rec.state = None                # already kept in trace.states

    state, stats = train(
        cfg, steps=sc.steps, batch=sc.batch, seq=sc.seq, opt=opt,
        lr_fn=lr_fn, seed=sc.seed, state=s0, checkpointer=ck,
        failure_plan=FailurePlan(tuple(sc.schedule.train_fail_steps)),
        step_hook=hook, device=device)
    trace.stats = stats
    trace.final = checkpoint_from_state(state)
    if shadow is not None and sc.shadow_async:
        ck.shadow.shutdown()


def run_scenario(scenario: Scenario, *, bundle_dir=None, device=None,
                 cfg=None) -> ScenarioResult:
    """Run one scenario end to end and evaluate its invariants.

    ``device``: the card unless ``"cpu"`` is asked for (it raises where
    that device is absent). ``cfg``: the full level's model config (the
    reference's ``configs.get(scenario.arch).reduced()`` by default). With
    ``bundle_dir``, any violation writes a minimal repro bundle (seed +
    scenario JSON + failing step) that `replay_bundle` re-runs
    bit-identically; the bundle JSON embeds the trailing trace window and
    the full Chrome trace lands beside it.

    Unless an observability session is already active (``repro_torch.obs
    .enabled_session`` — e.g. the ``repro_torch.obs`` CLI), the runner
    installs its own ring-buffer tracer (metrics stay disabled) so every
    result carries the trailing trace window in ``trace_export``.
    """
    from repro_torch.obs import Observability
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer

    device = resolve(device)
    scenario.validate()
    own_session = not _obs.get().tracer.enabled
    prev = None
    if own_session:
        prev = _obs.install(Observability(
            MetricsRegistry(enabled=False),
            Tracer(maxlen=512)))
    trace = Trace(scenario)
    try:
        engine = _Engine(trace)
        if scenario.level == "channel":
            _run_channel(scenario, trace, engine, device)
        else:
            _run_full(scenario, trace, engine, device, cfg)
        engine.end()
        result = ScenarioResult(scenario=scenario,
                                violations=tuple(trace.violations),
                                trace=trace)
        result.trace_export = _obs.get().tracer.export()
    finally:
        # the end-of-run invariants read the disk tier — drop it only now
        if trace.dur_tmpdir is not None:
            trace.dur_tmpdir.cleanup()
            trace.dur_tmpdir = None
        if own_session:
            _obs.install(prev)
    if bundle_dir is not None and result.violations:
        result.bundle_path = write_bundle(result, bundle_dir)
    return result
