"""System-wide invariants the chaos harness checks after every step — the
port of ``repro.harness.invariants``: the same registry, the same 16
claims with the same ``applies`` and the same messages. Trees compare
with `torch.equal` on host copies, bit for bit, as the reference's
``np.array_equal`` does.

Each `Invariant` inspects the run's `Trace` (see `repro_torch.harness.runner`)
— per-step records of sends, polls, stalls, checkpointer counters, the
consolidated shadow state, and the trainer/reference state — and yields
`Violation`s. ``applies()`` scopes an invariant to the scenarios where
its claim holds (e.g. the sharp error-feedback bound needs momentum-free
SGD); a scenario can force a specific set by name instead
(`Scenario.invariants`), which is how the violation-bundle machinery is
demonstrated against a knowingly-inapplicable check.

The registry is open: ``@register`` a new `Invariant` subclass and every
scenario (golden corpus, random sweeps, refactored failure drills) checks
it for free.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch

REGISTRY: dict[str, type] = {}


def register(cls):
    REGISTRY[cls.name] = cls
    return cls


@dataclass(frozen=True)
class Violation:
    """One invariant breach: the minimal fact a repro bundle must replay."""
    invariant: str
    step: Optional[int]
    message: str

    def to_dict(self) -> dict:
        return {"invariant": self.invariant, "step": self.step,
                "message": self.message}


class Invariant:
    """One checkable claim about a run. Instances are per-run (they may
    carry state across ``check_step`` calls, e.g. the contiguity model)."""
    name = "base"

    def applies(self, trace) -> bool:
        return True

    def check_step(self, trace, rec) -> Iterable[Violation]:
        return ()

    def check_end(self, trace) -> Iterable[Violation]:
        return ()

    def _v(self, step, message) -> Violation:
        return Violation(self.name, step, message)


def host(x) -> torch.Tensor:
    """``x`` (a tensor anywhere, or an array) as a tensor on the host."""
    return torch.as_tensor(x).to("cpu")


def tree_mismatch(a: dict, b: dict, parts=("params", "mu", "nu")
                  ) -> Optional[str]:
    """First bitwise mismatch between two checkpoint trees, or None."""
    for part in parts:
        pa, pb = a[part], b[part]
        if set(pa) != set(pb):
            return f"{part} leaf sets differ"
        for k in sorted(pa):
            x, y = host(pa[k]), host(pb[k])
            if not torch.equal(x, y):
                d = float(torch.max(torch.abs(x.double() - y.double())))
                return f"{part}[{k}] differs (max|delta|={d:.3e})"
    return None


@register
class ExactlyOnceDelivery(Invariant):
    """Every complete capture was reassembled exactly-once on the fabric
    (no missing replica spans, no duplicate mirror bytes on clean steps,
    no drops/retransmits without an injected failure), and the gating
    verdict the channel reports agrees with the fabric's own account."""
    name = "exactly-once"

    def applies(self, trace) -> bool:
        return trace.scenario.channel.has_fabric

    def check_step(self, trace, rec):
        clean = rec.step not in trace.fabric_steps
        for p in rec.polls:
            f = p.fabric
            if f is None:
                continue
            if p.complete != f.reassembled_ok:
                yield self._v(p.step, f"delivery complete={p.complete} but "
                                      f"fabric reassembled_ok="
                                      f"{f.reassembled_ok}")
            if p.complete and f.missing_captures:
                yield self._v(p.step, f"complete delivery with "
                                      f"{f.missing_captures} missing "
                                      f"capture spans")
            if not p.complete and not (f.missing_captures
                                       or not f.ring_completed):
                yield self._v(p.step, "gated delivery but the fabric "
                                      "reports a full capture")
            if clean:
                for attr in ("duplicate_mirror_bytes", "mirror_lost_frames",
                             "drops", "retransmits"):
                    n = getattr(f, attr)
                    if n:
                        yield self._v(p.step, f"clean step (no injected "
                                              f"failure) but {attr}={n}")
                if not f.reassembled_ok:
                    yield self._v(p.step, "clean step but capture not "
                                          "reassembled exactly-once")


@register
class ZeroOverheadAccounting(Invariant):
    """The packetized transport's sender-visible stall is exactly 0.0:
    the event-loop wall time (host CPU *simulating* the fabric) is never
    booked on the training critical path (§4 zero-overhead claim)."""
    name = "zero-overhead"

    def applies(self, trace) -> bool:
        return trace.scenario.channel.kind == "packetized"

    def check_step(self, trace, rec):
        # NOTE: messages stay free of wall-clock values — replay_bundle
        # verifies reproduction by exact message equality
        for s in rec.sends:
            if s.reported != 0.0:
                stages = sorted(k for k, v in s.parts.items() if v != 0.0)
                extra = f" [stages: {', '.join(stages)}]" if stages else ""
                yield self._v(s.step, "packetized send reported nonzero "
                                      "stall (the simulator's event-loop "
                                      "wall time must not be booked)"
                                      + extra)


@register
class StallAccounting(Invariant):
    """Gated/frozen steps book zero stall and no checkpoint; every
    consumed event is either a checkpoint, a skipped capture, or a
    resync-counted checkpoint — nothing double-counts."""
    name = "stall-accounting"

    def applies(self, trace) -> bool:
        return trace.scenario.checkpointer == "checkmate"

    def check_step(self, trace, rec):
        if rec.gated and not rec.applied and not rec.resync:
            if rec.stall != 0.0:
                # no wall-clock value in the message: bundles must replay
                # bit-identically
                yield self._v(rec.step, "gated step booked nonzero stall")

    def check_end(self, trace):
        ck = trace.checkpointer
        n_events = len(trace.records)
        if ck.n_checkpoints + ck.skipped_captures != n_events:
            yield self._v(None, f"accounting leak: n_checkpoints="
                                f"{ck.n_checkpoints} + skipped_captures="
                                f"{ck.skipped_captures} != {n_events} "
                                f"consumed events")
        if len(ck.skipped_steps) != ck.skipped_captures:
            yield self._v(None, f"skipped_steps={ck.skipped_steps} vs "
                                f"skipped_captures={ck.skipped_captures}")


@register
class StallAttribution(Invariant):
    """Every booked stall second is attributed to a known stage, and the
    attribution is bit-exact: each send's per-stage parts sum in order to
    exactly the stall the channel reported, a packetized channel's "send"
    component is exactly 0.0, and the checkpointer's stage ledger sums in
    order to exactly ``stall_total`` (repro_torch.obs.stalls)."""
    name = "stall-attribution"

    KNOWN = frozenset(("send", "quantize", "inline-apply", "apply-lag",
                       "resync", "consolidate-wait", "copy-persist",
                       "elastic-reshard"))

    def applies(self, trace) -> bool:
        return trace.scenario.checkpointer == "checkmate"

    def check_step(self, trace, rec):
        # messages carry stage NAMES only, never wall-clock values —
        # replay_bundle compares them bit-identically
        for s in rec.sends:
            if not s.parts:
                yield self._v(s.step, "channel send set no stall "
                                      "decomposition (last_send_parts)")
                continue
            total = 0.0
            for sec in s.parts.values():
                total += sec
            if total != s.reported:
                yield self._v(s.step, f"send parts "
                                      f"{sorted(s.parts)} do not sum "
                                      f"bit-exactly to the reported stall")
            unknown = sorted(set(s.parts) - self.KNOWN)
            if unknown:
                yield self._v(s.step, f"unknown stall stages {unknown}")
        if trace.scenario.channel.kind == "packetized":
            for s in rec.sends:
                if s.parts.get("send", 0.0) != 0.0:
                    yield self._v(s.step, "packetized send booked a nonzero "
                                          "'send' stage")

    def check_end(self, trace):
        ck = trace.checkpointer
        stages = getattr(ck, "stall_stages", None)
        if stages is None:
            return
        total = 0.0
        for sec in stages.values():
            total += sec
        if total != ck.stall_total:
            yield self._v(None, f"stage ledger {sorted(stages)} does not "
                                f"sum bit-exactly to stall_total")
        unknown = sorted(set(stages) - self.KNOWN)
        if unknown:
            yield self._v(None, f"unknown ledger stages {unknown}")


@register
class CheckpointContiguity(Invariant):
    """The shadow replays a contiguous gradient stream: its consolidated
    step only ever advances one applied step at a time, never across a
    gated gap, and only jumps at an explicit resync or a recovery rewind.
    While desynced it stays frozen at the last fully-captured step. A
    sharded partial apply (survivors replaying past dead owners) advances
    the stream the same single step — every serving node moves in
    lockstep, so the consolidated tree is never torn across steps."""
    name = "contiguity"

    def __init__(self):
        self.expected: Optional[int] = None

    def applies(self, trace) -> bool:
        return trace.scenario.checkpointer == "checkmate"

    def check_step(self, trace, rec):
        if self.expected is None:
            self.expected = trace.bootstrap_step
        if rec.restored_step is not None:
            if rec.plane_restore:
                # a total plane loss rewinds BOTH planes onto the tiers'
                # newest durable step — at or behind the live stream by
                # exactly the flush lag, never ahead of it
                if rec.restored_step > self.expected:
                    yield self._v(rec.step,
                                  f"tier restore landed at "
                                  f"{rec.restored_step}, AHEAD of the "
                                  f"stream at {self.expected}")
                self.expected = rec.restored_step
            elif rec.restored_step != self.expected:
                yield self._v(rec.step, f"restore() returned step "
                                        f"{rec.restored_step}, shadow "
                                        f"should be at {self.expected}")
                self.expected = rec.restored_step
        if rec.resync:
            self.expected = rec.step
        elif rec.applied or rec.partial_applied:
            if rec.step != self.expected + 1:
                yield self._v(rec.step, f"applied step {rec.step} onto a "
                                        f"shadow at {self.expected} — the "
                                        f"stream skipped a gap")
            self.expected = rec.step
        if rec.shadow_step is not None and rec.shadow_step != self.expected:
            yield self._v(rec.step, f"shadow consolidated at "
                                    f"{rec.shadow_step}, contiguous stream "
                                    f"ends at {self.expected}")


@register
class ShadowTrainerBitIdentity(Invariant):
    """At every sync point the shadow's consolidated params/mu/nu are
    bit-identical to the trainer's state at the shadow's step — the
    functional-optimizer replay claim (§4.2.4)."""
    name = "shadow-bit-identity"

    def applies(self, trace) -> bool:
        return (trace.scenario.checkpointer == "checkmate"
                and trace.scenario.channel.kind != "compressed")

    def check_step(self, trace, rec):
        if rec.shadow_ckpt is None or rec.shadow_step is None:
            return
        if rec.shadow_missing:               # partial tree (dead owners):
            return                           # shadow-node-death checks it
        ref = trace.states.get(rec.shadow_step)
        if ref is None:                      # e.g. the bootstrap step
            return
        bad = tree_mismatch(rec.shadow_ckpt, ref)
        if bad:
            yield self._v(rec.step, f"shadow@{rec.shadow_step} != "
                                    f"trainer@{rec.shadow_step}: {bad}")


@register
class ApplyLagBound(Invariant):
    """A bounded-lag shadow honors its contract end to end: the applier
    never trails the trainer by more than ``max_lag_steps`` queued
    deliveries (sampled right after every ingest), the trainer's wait on a
    backlogged applier is booked as the named ``apply-lag`` stage, and a
    throttled applier actually exercises the machinery — the bound blocks
    at least once and (for bounds >= 3) a multi-step batched catch-up
    replay runs. Bit-identity of lagged applies is not re-proved here: the
    batched replay feeds the same consolidated tree `shadow-bit-identity`
    checks at every consolidation point."""
    name = "apply-lag-bound"

    def applies(self, trace) -> bool:
        return (trace.scenario.checkpointer == "checkmate"
                and trace.scenario.max_lag_steps is not None)

    def check_step(self, trace, rec):
        k = trace.scenario.max_lag_steps
        if rec.shadow_lag is not None and rec.shadow_lag > k:
            yield self._v(rec.step, f"shadow lag {rec.shadow_lag} exceeds "
                                    f"max_lag_steps={k}")

    def check_end(self, trace):
        st = trace.shadow_stats
        if st is None:
            return                  # full level: no cluster stats recorded
        sc = trace.scenario
        k = sc.max_lag_steps
        if st.max_queue_depth > k:
            yield self._v(None, f"delivery queue reached depth "
                                f"{st.max_queue_depth}, past the lag bound "
                                f"{k}")
        if st.max_batch > max(k, 1):
            yield self._v(None, f"a worker drained {st.max_batch} steps in "
                                f"one batch, past the lag bound {k}")
        stages = dict(getattr(trace.checkpointer, "stall_stages", {}) or {})
        if st.lag_waits > 0 and "apply-lag" not in stages:
            yield self._v(None, "trainer waited on a backlogged applier "
                                "but no 'apply-lag' stage was booked")
        if not (sc.apply_delay_s > 0 and sc.steps > k):
            return                  # bound never provably under pressure
        if sc.schedule.fabric or sc.schedule.train_fail_steps:
            return                  # resync / restore settles the backlog
            #                         mid-run, so pressure isn't guaranteed
        if st.lag_waits == 0:
            yield self._v(None, "throttled applier never backlogged to the "
                                "bound — the apply-lag machinery was not "
                                "exercised")
        if k >= 3 and st.max_batch < 2:
            # the gate admits at most k pending (one in flight + k-1
            # queued), so a wake can only see a multi-item backlog for
            # bounds >= 3
            yield self._v(None, f"lag bound {k} under a throttled applier "
                                f"but no multi-step batched apply ran")


@register
class ShadowNodeDeath(Invariant):
    """Killing a sharded shadow owner loses exactly that owner's shard and
    nothing else: consolidation raises `ShadowNodeLoss` naming precisely
    the dead owners and their buckets, the dead owners' leaves are absent
    from the partial checkpoint, every surviving owner's leaf stays
    bit-identical to the trainer at the consolidated step, and a resync
    (full-state copy onto replacement hardware) makes the cluster whole
    again. Stateful: models the dead set across steps, honoring the
    kill phase ("step" kills land before that step's capture,
    "consolidate" kills after its apply) and resync revivals."""
    name = "shadow-node-death"

    def __init__(self):
        self.dead: set[int] = set()

    def applies(self, trace) -> bool:
        return bool(trace.scenario.schedule.shadow_death)

    def check_step(self, trace, rec):
        deaths = [d for d in trace.scenario.schedule.shadow_death
                  if d.step == rec.step]
        for d in deaths:
            if d.phase == "step":
                self.dead.add(d.node)
        if rec.resync:          # replacement racked + full-state copy
            self.dead.clear()
        for d in deaths:
            if d.phase == "consolidate":
                self.dead.add(d.node)
        part = trace.shadow_partition or {}
        expected = {n: tuple(part[n]["buckets"]) for n in sorted(self.dead)}
        got = {int(n): tuple(b)
               for n, b in (rec.shadow_missing or {}).items()}
        if got != expected:
            yield self._v(rec.step,
                          f"consolidate reported missing buckets {got} but "
                          f"dead owners {sorted(self.dead)} own {expected}")
        if tuple(rec.dead_nodes or ()) != tuple(sorted(self.dead)):
            yield self._v(rec.step,
                          f"consolidate named dead nodes "
                          f"{list(rec.dead_nodes)}, killed: "
                          f"{sorted(self.dead)}")
        if rec.shadow_ckpt is None or rec.shadow_step is None:
            return
        dead_leaves = {lf for n in self.dead for lf in part[n]["leaves"]}
        still_there = sorted(dead_leaves & set(rec.shadow_ckpt["params"]))
        if still_there:
            yield self._v(rec.step,
                          f"dead owners' leaves {still_there} still served "
                          f"by the consolidated tree")
        ref = trace.states.get(rec.shadow_step)
        if ref is None:                      # e.g. the bootstrap step
            return
        for part_name in ("params", "mu", "nu"):
            for k in sorted(rec.shadow_ckpt[part_name]):
                a = host(rec.shadow_ckpt[part_name][k])
                if not torch.equal(a, host(ref[part_name][k])):
                    yield self._v(rec.step,
                                  f"surviving shard leaf {part_name}[{k}] "
                                  f"diverged from trainer@{rec.shadow_step}")


@register
class ElasticResume(Invariant):
    """An elastic shrink is invisible in the training trajectory: every
    scheduled `TrainNodeLoss` actually reconfigured the run onto the
    survivors, the reconfiguration is booked as the named
    ``elastic-reshard`` stall stage, the rebuilt shadow plane re-attaches
    bit-identical to the trainer at the resumed step and keeps advancing
    on the shrunken layout, and the drill's world accounting is exact —
    the new world is the old world minus the killed ranks and the
    replanned DP width spans exactly the survivors. (Post-shrink steps
    stay covered by replay-determinism / resume-bit-identity, whose
    reference targets are DP-width-independent by construction.)"""
    name = "elastic-resume"

    def applies(self, trace) -> bool:
        return bool(trace.scenario.schedule.train_node_loss)

    def check_step(self, trace, rec):
        if not rec.elastic:
            return
        if rec.restored_step is None:
            yield self._v(rec.step, "elastic resume recorded without a "
                                    "restore() having run")
        if trace.scenario.channel.kind == "compressed":
            return      # the shadow stream is intentionally lossy there
        if rec.shadow_ckpt is None or rec.shadow_step is None:
            return
        ref = trace.states.get(rec.shadow_step)
        if ref is None:
            return
        bad = tree_mismatch(rec.shadow_ckpt, ref)
        if bad:
            yield self._v(rec.step,
                          f"re-attached shadow@{rec.shadow_step} != "
                          f"trainer@{rec.shadow_step}: {bad}")

    def check_end(self, trace):
        sched = trace.scenario.schedule.train_node_loss
        evs = trace.elastic_events
        if len(evs) != len(sched):
            yield self._v(None, f"{len(sched)} shrink(s) scheduled but "
                                f"{len(evs)} reconfiguration(s) ran")
            return
        stages = getattr(trace.checkpointer, "stall_stages", None) or {}
        if "elastic-reshard" not in stages:
            yield self._v(None, "reconfiguration ran but no "
                                "'elastic-reshard' stage was booked in the "
                                "checkpointer's stall ledger")
        for tl, ev in zip(sched, evs):
            if ev["step"] != tl.step:
                yield self._v(tl.step,
                              f"shrink scheduled after step {tl.step} but "
                              f"the drill ran at {ev['step']}")
            if sorted(ev["killed"]) != sorted(tl.ranks):
                yield self._v(tl.step,
                              f"drill killed ranks {sorted(ev['killed'])}, "
                              f"schedule names {sorted(tl.ranks)}")
            if ev["resumed_step"] > ev["step"]:
                yield self._v(tl.step,
                              f"resume landed at {ev['resumed_step']}, "
                              f"AHEAD of the shrink at {ev['step']}")
            if trace.scenario.level != "channel":
                continue            # full level: no modeled rank world
            if ev["new_world"] != ev["old_world"] - len(ev["killed"]):
                yield self._v(tl.step,
                              f"world went {ev['old_world']} -> "
                              f"{ev['new_world']} after killing "
                              f"{len(ev['killed'])} rank(s)")
            if ev["dp"] != ev["new_world"]:
                yield self._v(tl.step,
                              f"replanned dp={ev['dp']} does not span the "
                              f"{ev['new_world']} survivors")
            dead = set(ev["killed"]) & set(ev["survivors"])
            if dead:
                yield self._v(tl.step, f"killed ranks {sorted(dead)} "
                                       f"listed as survivors")
        last = evs[-1]
        if (last["resumed_step"] < trace.scenario.steps
                and not any(f > last["resumed_step"]
                            for f in trace.scenario.schedule.fabric_steps)):
            post = [r for r in trace.records
                    if r.step > last["resumed_step"]
                    and (r.applied or r.partial_applied or r.resync)]
            if not post:
                yield self._v(None, "no shadow apply ever landed on the "
                                    "shrunken layout after the last shrink")


@register
class ReplayDeterminism(Invariant):
    """Re-executed iterations (after a recovery rewind) reproduce the
    original trainer state and loss bit-identically — the PRNG-counter
    data pipeline plus deterministic step make resume exact (Fig 9)."""
    name = "replay-determinism"

    def applies(self, trace) -> bool:
        # recovery onto a compressed shadow stream rewinds the trainer
        # onto a state its original trajectory never visited, so replays
        # legitimately diverge (same scope as resume-bit-identity)
        return not (trace.scenario.channel.kind == "compressed"
                    and trace.scenario.schedule.train_fail_steps)

    def check_step(self, trace, rec):
        if rec.state is None:
            return
        if not rec.first_seen:       # a replay: the runner kept the original
            bad = tree_mismatch(rec.state, trace.states[rec.step])
            if bad:
                yield self._v(rec.step, f"replayed step diverged from its "
                                        f"original execution: {bad}")
        if rec.loss is not None and trace.ref_losses is not None:
            ref = trace.ref_losses[rec.step - 1]
            if rec.loss != ref:
                yield self._v(rec.step, f"loss {rec.loss!r} != reference "
                                        f"run's {ref!r}")


@register
class BitIdenticalResume(Invariant):
    """The chaos run's final trainer state equals the uninterrupted
    reference run's, bit for bit — failures + recovery are invisible in
    the training trajectory (§6.5 / Fig 9)."""
    name = "resume-bit-identity"

    def applies(self, trace) -> bool:
        # a compressed shadow stream intentionally diverges from raw
        # training, so a recovery onto it rewrites the trajectory
        return (trace.ref_final is not None
                and not (trace.scenario.channel.kind == "compressed"
                         and trace.scenario.schedule.train_fail_steps))

    def check_end(self, trace):
        if trace.final is None:
            return
        bad = tree_mismatch(trace.final, trace.ref_final)
        if bad:
            yield self._v(None, f"final state != uninterrupted reference: "
                                f"{bad}")


@register
class CompressedDivergenceBound(Invariant):
    """Error-feedback invariant, sharp in the momentum-free SGD regime:
    the shadow (which consumed the compressed stream) diverges from the
    raw-gradient trainer by exactly lr * residual — bounded by one
    quantization step, not by the number of iterations."""
    name = "compressed-ef-bound"
    ATOL = 5e-6

    def applies(self, trace) -> bool:
        sc = trace.scenario
        return (sc.channel.kind == "compressed" and sc.optimizer == "sgd"
                and sc.momentum == 0.0 and not sc.schedule.fabric
                and not sc.schedule.train_fail_steps
                and trace.compressor is not None
                and trace.final_shadow is not None)

    def check_end(self, trace):
        ef = trace.compressor.ef
        lr = trace.scenario.lr
        shadow, ref = trace.final_shadow, trace.final
        for k in sorted(shadow["params"]):
            div = (host(shadow["params"][k]).double()
                   - host(ref["params"][k]).double())
            res = lr * host(ef[k]).double()
            # numpy's allclose: rtol 1e-5 beside the atol
            if not torch.allclose(div, res, rtol=1e-5, atol=self.ATOL):
                gap = float(torch.max(torch.abs(div - res)))
                yield self._v(None, f"params[{k}]: shadow-ref divergence "
                                    f"is not lr*residual (max|delta|="
                                    f"{gap:.3e})")
            bound = lr * float(torch.max(torch.abs(host(ef[k])))) + self.ATOL
            if float(torch.max(torch.abs(div))) > bound:
                yield self._v(None, f"params[{k}]: divergence "
                                    f"{float(torch.max(torch.abs(div))):.3e} "
                                    f"exceeds the EF bound {bound:.3e}")


@register
class ConsolidateTimeout(Invariant):
    """A wedged shadow worker cannot hang recovery: consolidation honors
    its deadline, names exactly the lagging node, and a retry after the
    wedge releases completes at the true step."""
    name = "consolidate-timeout"

    def applies(self, trace) -> bool:
        return trace.scenario.schedule.wedge_node is not None

    def check_end(self, trace):
        w = trace.wedge
        sc = trace.scenario
        if w is None:
            yield self._v(None, "wedge scheduled but the runner recorded "
                                "no consolidation attempt")
            return
        if not w["raised"]:
            yield self._v(None, "consolidate() returned despite a wedged "
                                "worker inside the deadline")
            return
        if w["lagging"] != [sc.schedule.wedge_node]:
            yield self._v(None, f"lagging nodes {w['lagging']} != "
                                f"[{sc.schedule.wedge_node}]")
        if w["partial_step"] >= w["final_step"]:
            yield self._v(None, f"partial checkpoint at {w['partial_step']} "
                                f"not older than the completed one at "
                                f"{w['final_step']}")


@register
class ZeroFlushStall(Invariant):
    """Durability flushing adds ZERO training stall: the flush plane runs
    entirely on background worker threads, so no flush-named stage ever
    appears in a send's stall decomposition or in the checkpointer's
    stage ledger — the paper's zero-overhead claim extended through the
    durability tiers (`repro_torch.durability.flush`)."""
    name = "zero-flush-stall"

    FORBIDDEN = ("flush", "durability", "tier")

    def applies(self, trace) -> bool:
        return trace.scenario.durability.enabled

    def _bad(self, names) -> list:
        return sorted(n for n in names
                      if any(f in n for f in self.FORBIDDEN))

    def check_step(self, trace, rec):
        for s in rec.sends:
            bad = self._bad(s.parts)
            if bad:
                yield self._v(s.step, f"flush stage(s) {bad} booked on the "
                                      f"training critical path")

    def check_end(self, trace):
        stages = getattr(trace.checkpointer, "stall_stages", None) or {}
        bad = self._bad(stages)
        if bad:
            yield self._v(None, f"flush stage(s) {bad} in the "
                                f"checkpointer's stall ledger")
        dur = trace.durability
        if dur is None or dur.epochs_started == 0:
            yield self._v(None, "durability enabled but no flush epoch "
                                "ever started — the claim was never "
                                "exercised")


@register
class TierRestore(Invariant):
    """Every durability tier rebuilds a full checkpoint bit-identical to
    the trainer at that tier's newest complete epoch (its recorded lag),
    and a total plane loss recovers through the tiers to the newest
    flushed step, with `ShadowNodeLoss` naming the serving tier."""
    name = "tier-restore"

    def applies(self, trace) -> bool:
        sc = trace.scenario
        # compressed flush (or a compressed channel stream) restores are
        # intentionally approximate — bit-identity is out of scope there
        return (sc.durability.enabled and not sc.durability.compress
                and sc.channel.kind != "compressed")

    def check_end(self, trace):
        from repro_torch.durability.restore import (TierRestoreError,
                                                    restore_from_tiers)
        dur = trace.durability
        if dur is None:
            yield self._v(None, "durability enabled but the runner "
                                "attached no DurableShadow")
            return
        n_nodes = trace.scenario.shadow_nodes
        for tier in trace.tiers:
            want = dur.last_complete_step(tier.name)
            try:
                ckpt = restore_from_tiers([tier], trace.layout,
                                          n_nodes=n_nodes)
            except TierRestoreError:
                if want is None:
                    continue       # tier never completed an epoch: fine
                yield self._v(None, f"tier '{tier.name}' books a complete "
                                    f"epoch at step {want} but restore "
                                    f"found no usable point")
                continue
            got = int(ckpt["step"])
            if got != want:
                yield self._v(None, f"tier '{tier.name}' restored step "
                                    f"{got}, its newest complete epoch "
                                    f"is at step {want}")
            ref = trace.states.get(got)
            if ref is None:
                yield self._v(None, f"tier '{tier.name}' restored step "
                                    f"{got}, a step the trainer never "
                                    f"executed")
                continue
            bad = tree_mismatch(ckpt, ref)
            if bad:
                yield self._v(None, f"tier '{tier.name}' restore@{got} != "
                                    f"trainer@{got}: {bad}")
        ev = trace.scenario.durability.every_steps
        for pl in trace.plane_losses:
            if not pl["total"]:
                yield self._v(pl["step"], "whole-plane kill did not "
                                          "surface as a total "
                                          "ShadowNodeLoss")
            hint = pl["durable_hint"]
            if hint is None:
                yield self._v(pl["step"], "total loss carried no durable "
                                          "hint despite attached tiers")
            elif pl["restored_step"] != hint[1]:
                yield self._v(pl["step"],
                              f"restore landed at {pl['restored_step']} "
                              f"but the loss named tier '{hint[0]}' at "
                              f"step {hint[1]}")
            # the drill drains flushes before the kill, so the durable
            # point trails the kill step by exactly the cadence remainder
            if pl["restored_step"] != (pl["step"] // ev) * ev:
                yield self._v(pl["step"],
                              f"restored step {pl['restored_step']} != "
                              f"newest flushed step "
                              f"{(pl['step'] // ev) * ev} "
                              f"(cadence every_steps={ev})")


class _TornTier:
    """Read-through tier proxy serving ONE record as a torn write (its
    byte stream cut mid-payload) — the torn-delta invariant's probe."""

    def __init__(self, inner, torn_key: str):
        self.inner = inner
        self.torn_key = torn_key
        self.name = inner.name

    def entries(self):
        return self.inner.entries()

    def read(self, entry):
        from repro_torch.durability.record import FlushRecord
        rec = self.inner.read(entry)
        if entry.key != self.torn_key:
            return rec
        raw = rec.to_bytes()
        return FlushRecord.from_bytes(raw[:len(raw) // 2])  # raises Torn...


@register
class TornDeltaDetection(Invariant):
    """A flush record cut anywhere mid-write is rejected by its checksum
    — never silently half-applied — and restore falls back past it to an
    older complete epoch that is still bit-identical to the trainer."""
    name = "torn-delta"

    def applies(self, trace) -> bool:
        sc = trace.scenario
        return (sc.durability.enabled and not sc.durability.compress
                and sc.channel.kind != "compressed")

    def check_end(self, trace):
        from repro_torch.durability.record import (FlushRecord,
                                                   TornRecordError)
        from repro_torch.durability.restore import (TierRestoreError,
                                                    restore_from_tiers)
        dur = trace.durability
        if dur is None or not trace.tiers:
            return
        tier = trace.tiers[0]            # the local-disk tier
        target = None                    # newest payload-carrying record
        for e in sorted(tier.entries(), key=lambda e: (e.epoch, e.node)):
            if e.kind in ("base", "delta"):
                target = e
        if target is None:
            return
        raw = tier.read(target).to_bytes()
        try:
            FlushRecord.from_bytes(raw[:len(raw) // 2])
            yield self._v(None, f"record {target.key} truncated to half "
                                f"parsed cleanly — torn write undetected")
            return
        except TornRecordError:
            pass
        try:
            ckpt = restore_from_tiers([_TornTier(tier, target.key)],
                                      trace.layout,
                                      n_nodes=trace.scenario.shadow_nodes)
        except TierRestoreError:
            if target.kind == "delta":
                # a torn DELTA must only cost its own epoch — an older
                # complete one (the base, at minimum) must still serve
                yield self._v(None, f"torn delta {target.key} made the "
                                    f"whole tier unrestorable instead of "
                                    f"falling back one epoch")
            return
        got = int(ckpt["step"])
        ref = trace.states.get(got)
        if ref is None:
            yield self._v(None, f"fallback restore past torn "
                                f"{target.key} landed at step {got}, a "
                                f"step the trainer never executed")
            return
        bad = tree_mismatch(ckpt, ref)
        if bad:
            yield self._v(None, f"fallback restore past torn "
                                f"{target.key} diverged: {bad}")


def select(trace) -> list[Invariant]:
    """Instantiate the invariants for one run: the scenario's forced list,
    or every registered invariant (``applies()`` scopes them per check)."""
    names = trace.scenario.invariants or tuple(sorted(REGISTRY))
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        raise KeyError(f"unknown invariants {unknown}; "
                       f"registered: {sorted(REGISTRY)}")
    return [REGISTRY[n]() for n in names]
