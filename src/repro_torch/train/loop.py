"""Training loop with Checkmate, failure injection, recovery and straggler
flags — the port of ``repro.train.loop.train``.

The train step returns the gradients it applied; the capture packs them on
the device into one flat buffer per bucket (the bucket-pack kernel), copies
each bucket once into pinned host memory, and hands the host flats to the
checkpointer as ``StepEvent.flats``. A channel that transforms the capture
on the card (``device_flats``, the compressed channel) is handed the device
buckets instead and brings its own output to the host. Copy-persist
baselines read the state through ``StepEvent.state_fn`` instead, and the
loop skips the capture for them. On an injected failure the loop restores
the checkpointer's latest checkpoint and replays from its step, onto new
sharding rules where the caller asks for an elastic restart.

On ``rules`` over more than one rank every rank runs ``train`` in its own
process (`_train_over_ranks`). Global rank 0 hosts the checkpointer and
its shadow, where the reference's single controller holds the host tree.
The capture is the owned slices (`RankCapture`): each rank packs only the
reduced slices its reduce-scatter (and, for a tensor-parallel family, its
model cut) left it, a dim held whole is sent by the first rank along it
alone, and each rank with a share sends it to rank 0, which assembles
the bucket flats, so every reduced element reaches the shadow exactly
once. A checkpointer's ``state_fn`` is the state gather
(`RankStateGather`): each rank packs its slices of params, mu and nu, a
tree at a time, and rank 0 assembles the whole state on its host. Only
rank 0's checkpointer knows when it reads the state (a baseline at its
frequency, Checkmate at a resync), so after each step the other ranks
wait on rank 0's word: send your slices, or go on.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs as _obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import (BucketLayout, alloc_flat, bucket_dtype,
                                      build_buckets, layout_for_tree,
                                      pack_bucket_into)
from repro_torch.core.channel import GradientChannel, StepEvent, to_host
from repro_torch.core.checkpoint import (BaseCheckpointer,
                                         CheckmateCheckpointer,
                                         NoCheckpointer)
from repro_torch.core.recovery import (FailurePlan, broadcast_checkpoint,
                                       checkpoint_from_state,
                                       placement_device,
                                       state_from_checkpoint)
from repro_torch.core.shadow import ShadowCluster
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.device import resolve
from repro_torch.dist.sharding import (ShardingRules, unravel,
                                       make_smoke_mesh)
from repro_torch.kernels import ops
from repro_torch.optim.functional import OptimizerConfig, TrainState
from repro_torch.train.step import build_train_step, make_train_state


class TrainingFailure(RuntimeError):
    pass


@dataclass
class LoopStats:
    steps: int = 0
    losses: list = field(default_factory=list)
    iter_times: list = field(default_factory=list)
    stall_times: list = field(default_factory=list)
    capture_times: list = field(default_factory=list)
    failures: int = 0
    recoveries: int = 0
    recovered_at: list = field(default_factory=list)
    straggler_flags: list = field(default_factory=list)
    checkpointer: Optional[BaseCheckpointer] = None

    @property
    def throughput(self) -> float:
        """Steps per second of step and stall time, as in the JAX loop
        (the capture's time is in ``capture_times``, outside both)."""
        total = sum(self.iter_times) + sum(self.stall_times)
        return self.steps / total if total else 0.0

    @property
    def mean_iter(self) -> float:
        return float(np.mean(self.iter_times)) if self.iter_times else 0.0

    @property
    def steady_iter(self) -> float:
        """Median iteration time excluding the first (warm-up) step."""
        xs = self.iter_times[1:] if len(self.iter_times) > 1 \
            else self.iter_times
        return float(np.median(xs)) if xs else 0.0


class Capture:
    """Gradient leaves -> per-bucket flats, once per step.

    On the card each bucket is packed into a device buffer reused across
    steps; with ``host`` (the default) each is then copied into fresh
    pinned host memory (a shadow may still hold the previous step's) and
    the copies are awaited. Without ``host`` the device buffers themselves
    are returned, valid until the next call. On the CPU the pack writes a
    fresh host buffer directly.

    The packs are the span ``bucket.pack`` and the copy to the host
    (allocation, copies and their wait) the span ``capture.to_host``,
    whose ``bytes`` are the bytes copied off the card; both carry
    ``step``, the iteration the call serves, which the loop sets.
    """

    def __init__(self, layout: BucketLayout, device: torch.device,
                 host: bool = True):
        self.layout = layout
        self.device = device
        self.host = host
        self.step = 0
        self._dev: dict[int, torch.Tensor] = {}

    def __call__(self, grads: dict) -> dict:
        tracer = _obs.get().tracer
        flats = {}
        with tracer.span("bucket.pack", args={"step": self.step}):
            for b in self.layout.buckets:
                dt = bucket_dtype(b)
                if self.device.type != "cuda":
                    flats[b.bucket_id] = pack_bucket_into(
                        b, grads, alloc_flat(b.size, dt))
                    continue
                buf = self._dev.get(b.bucket_id)
                if buf is None:
                    buf = self._dev[b.bucket_id] = alloc_flat(
                        b.size, dt, self.device)
                flats[b.bucket_id] = pack_bucket_into(b, grads, buf)
        if not self.host:
            return flats
        nbytes = sum(t.nbytes for t in flats.values() if t.is_cuda)
        with tracer.span("capture.to_host",
                         args={"step": self.step, "bytes": nbytes}):
            return to_host(flats)


def _flag_straggler(stats: LoopStats, step: int, iter_time: float, ema,
                    decay: float, factor: float) -> float:
    """Straggler observability: flag ``step`` in ``stats`` when its
    iteration is slower than ``factor`` times the EMA of earlier ones;
    returns the EMA updated with it (weight ``decay``)."""
    if ema is None:
        return iter_time
    if iter_time > factor * ema:
        stats.straggler_flags.append(step)
    return decay * ema + (1 - decay) * iter_time


class RankCapture:
    """The capture over ranks: this rank's owned reduced slices -> global
    rank 0, which packs the full bucket flats (a `Capture`).

    ``sharding`` is the step's `StateSharding`. A leaf's reduced gradient
    may be cut over the dp axes (its ZeRO-1 dim) and over ``model`` (a
    tensor-parallel family's model dim); each cut is sent by every rank
    along it, and a dim held whole by the first rank along it alone. Each
    rank with a share packs it into one flat (one pack launch) and sends
    it to global rank 0, which receives exactly those flats, each at its
    own size, and rebuilds each global leaf from its cuts. A rank with no
    share (a model index above 0 of a family whose layers are whole over
    ``model``, were one taken out of ``registry.TENSOR_PARALLEL``) sends
    nothing; under moe's expert
    parallelism every rank sends its experts' slices. A leaf cut nowhere
    is taken from rank 0's own reduced leaf. ``marks`` lists what this rank contributed at the last call, as
    (leaf, ((dim, first, end), ...)), the cuts along which its slice was
    taken (empty: the whole leaf); ``received`` is the number of elements
    rank 0 received from the other ranks.
    """

    def __init__(self, sharding, layout: BucketLayout, device: torch.device,
                 host: bool = True):
        self.sh = sharding
        self.device = device
        mesh = sharding.mesh
        self.group = mesh.mesh_group
        self.ranks = mesh.ranks
        # each mesh rank's share, in mesh order
        self.plans = _shares(sharding.state, sharding.shapes, mesh,
                             whole=False)
        self.sizes = [sum(e[3] for e in plan) for plan in self.plans]
        self.index = mesh.ranks.index(dist.get_rank())
        self.whole = [k for k, z in sharding.state.items()
                      if z.n == 1 and z.m == 1]
        self.host_rank = dist.get_rank() == 0
        self.inner = Capture(layout, device, host) if self.host_rank \
            else None
        self.marks: list = []
        self.received = 0
        self.step = 0                  # handed to rank 0's `Capture`

    def __call__(self, owned: dict) -> Optional[dict]:
        mine = self.plans[self.index]
        self.marks = [(k, cuts) for k, cuts, _, _ in mine]
        if self.index == 0:
            self.marks += [(k, ()) for k in self.whole]
        flat = alloc_flat(self.sizes[self.index], torch.float32, self.device)
        if mine:
            ops.pack_bucket([owned[k].reshape(-1) for k, _, _, _ in mine],
                            [off for _, _, off, _ in mine], flat)
        if not self.host_rank:
            if mine:
                _wait([dist.P2POp(dist.isend, flat, 0, self.group)])
            return None
        flats = [flat if i == self.index else
                 alloc_flat(size, torch.float32, self.device) if size
                 else None for i, size in enumerate(self.sizes)]
        recv = [(i, f) for i, f in enumerate(flats)
                if f is not None and i != self.index]
        _wait([dist.P2POp(dist.irecv, f, self.ranks[i], self.group)
               for i, f in recv])
        self.received = sum(f.numel() for _, f in recv)
        full = {k: owned[k] if k in self.whole else
                torch.empty(s, dtype=torch.float32, device=self.device)
                for k, s in self.sh.shapes.items()}
        for plan, f in zip(self.plans, flats):
            _place(full, plan, f)
        self.inner.step = self.step
        return self.inner(full)


def _wait(p2p: list) -> None:
    """Issue the point-to-point ops ``p2p`` together and wait for all."""
    if p2p:
        for req in dist.batch_isend_irecv(p2p):
            req.wait()


def _shares(shardings: dict, shapes: dict, mesh, whole: bool) -> list:
    """Each mesh rank's share of a tree laid out by ``shardings`` (leaf ->
    `NamedSharding`), in mesh order: (leaf, cuts, offset, size) of each
    slice it sends (`NamedSharding.owned_cuts`), at its offset in the
    rank's flat. A leaf whole on every rank is left out unless ``whole``
    (then mesh rank 0 sends it)."""
    names = mesh.axis_names
    extents = [mesh.shape[a] for a in names]
    plans = []
    for i in range(mesh.size):
        coords = dict(zip(names, unravel(i, extents)))
        plan, off = [], 0
        for k, z in shardings.items():
            if not whole and z.n == 1 and z.m == 1:
                continue
            cuts = z.owned_cuts(coords, shapes[k])
            if cuts is None:
                continue
            size = math.prod(shapes[k])
            for d, lo, hi in cuts:
                size = size // shapes[k][d] * (hi - lo)
            plan.append((k, cuts, off, size))
            off += size
        plans.append(plan)
    return plans


def _place(tree: dict, plan: list, flat: torch.Tensor) -> None:
    """Copy each slice of ``plan`` out of ``flat`` (on any device) into
    its place in the whole leaves of ``tree``: one copy a slice, straight
    into a leaf where the slice is contiguous in it."""
    for k, cuts, off, size in plan:
        idx = [slice(None)] * tree[k].dim()
        for d, lo, hi in cuts:
            idx[d] = slice(lo, hi)
        dst = tree[k][tuple(idx)]
        dst.copy_(flat[off:off + size].view(dst.shape))


class RankStateGather:
    """The whole trainer state on global rank 0's host, from every rank's
    slices: over ranks, what `checkpoint_from_state` gives on one rank
    (params, mu and nu as whole host tensors, and the step), the
    ``state_fn`` of rank 0's checkpointer.

    ``sharding`` is the step's `StateSharding`: params travel by their
    param sharding, mu and nu by ``sharding.state`` (ZeRO-1), each element
    once (`NamedSharding.owned_cuts`). For each tree every rank with a
    share packs it into one flat (one pack launch) and sends it to rank
    0, which copies its own flat and then each peer's, received one at a
    time, into the whole leaves on the host. So beyond the trainer's state
    rank 0's device holds one rank's share of one tree at a time, and any
    other rank's one flat of its own share. Collective over the mesh;
    returns None off rank 0.
    """

    def __init__(self, sharding, device: torch.device):
        mesh = sharding.mesh
        self.shapes = sharding.shapes
        self.device = device
        self.group = mesh.mesh_group
        self.ranks = mesh.ranks
        self.index = mesh.ranks.index(dist.get_rank())
        self.plans = {"params": _shares(sharding.params, self.shapes, mesh,
                                        whole=True)}
        self.plans["mu"] = self.plans["nu"] = _shares(
            sharding.state, self.shapes, mesh, whole=True)

    def __call__(self, state: TrainState) -> Optional[dict]:
        out = {"step": int(state.step)}
        for tree, plans in self.plans.items():
            leaves = getattr(state, tree)
            dtype = next(iter(leaves.values())).dtype
            mine = plans[self.index]
            flat = None
            if mine:
                flat = alloc_flat(sum(e[3] for e in mine), dtype, self.device)
                ops.pack_bucket([leaves[k].reshape(-1) for k, *_ in mine],
                                [off for _, _, off, _ in mine], flat)
            if self.index:
                if flat is not None:
                    _wait([dist.P2POp(dist.isend, flat, 0, self.group)])
                continue
            whole = out[tree] = {k: torch.empty(s, dtype=dtype)
                                 for k, s in self.shapes.items()}
            for i, plan in enumerate(plans):
                if i and plan:
                    flat = alloc_flat(sum(e[3] for e in plan), dtype,
                                      self.device)
                    _wait([dist.P2POp(dist.irecv, flat, self.ranks[i],
                                      self.group)])
                if plan:
                    _place(whole, plan, flat)
                flat = None              # free it before the next peer's
        return out if self.index == 0 else None


def train(cfg: ModelConfig, *,
          steps: int,
          batch: int,
          seq: int,
          opt: OptimizerConfig = OptimizerConfig(),
          lr_fn: Callable = lambda s: 1e-3,
          checkpointer: Optional[BaseCheckpointer] = None,
          channel: Optional[GradientChannel] = None,
          shadow_nodes: int = 2,
          shadow_async: bool = False,
          failure_plan: Optional[FailurePlan] = None,
          seed: int = 0,
          straggler_ema: float = 0.9,
          straggler_factor: float = 2.0,
          state: Optional[TrainState] = None,
          step_hook: Optional[Callable] = None,
          device=None,
          rules: Optional[ShardingRules] = None,
          elastic_rules=None) -> tuple[TrainState, LoopStats]:
    """Run ``steps`` iterations; on an injected failure, restore from the
    checkpointer (Checkmate: shadow consolidation) and continue.

    ``channel`` builds a bootstrapped `ShadowCluster` (``shadow_nodes``
    nodes on ``device``, worker threads if ``shadow_async``) and a
    `CheckmateCheckpointer` wired through that channel, exposed as
    ``stats.checkpointer``. Mutually exclusive with ``checkpointer``.
    ``step_hook(step, state, stats)`` runs after every completed iteration.
    An iteration slower than ``straggler_factor`` times the EMA of earlier
    ones (weight ``straggler_ema``) is flagged in ``stats.straggler_flags``.

    ``rules`` are the run's sharding rules (default: the one-rank smoke
    mesh on ``device``). On a mesh of more than one rank every rank calls
    ``train`` with the same arguments, in its own process; global rank 0
    hosts the checkpointer (``checkpointer`` or the one ``channel``
    builds) and the other ranks pass no ``checkpointer`` (they ignore
    ``channel``). Any checkpointer runs there: its ``state_fn`` gathers
    the whole state from every rank's slices to rank 0's host
    (`RankStateGather`), and the other ranks follow rank 0's word after
    each step (send their slices, or go on), each booking the wall time
    of that exchange as its stall. ``stats.losses`` are the global losses;
    the returned state is this rank's slices.
    ``elastic_rules`` is the elastic-restart path (`repro_torch.core
    .elastic`): rules for the post-failure mesh, or a callable
    ``(failed_step) -> rules | None`` (None keeps the current layout). On
    the first recovery that yields other rules the loop rebuilds the step
    function, the shadow plane and channel against the re-derived bucket
    layout (`CheckmateCheckpointer.reconfigure`, booked as the
    ``elastic-reshard`` stall stage) and the capture against the new
    plane's layout, lands the checkpoint on the new mesh's device, and
    resumes; the switch fires once. The data stream needs no rebuild: it
    is the global batch as a pure function of (seed, step). Over ranks,
    every rank calls ``elastic_rules`` (building a mesh is collective); a
    rank outside the new mesh leaves and returns (None, stats).
    """
    device = resolve(device)
    if rules is not None and rules.mesh.size > 1:
        if placement_device(rules) != device:
            raise ValueError(f"rules on {rules.mesh.device}, run on {device}")
        return _train_over_ranks(
            cfg, steps=steps, batch=batch, seq=seq, opt=opt, lr_fn=lr_fn,
            checkpointer=checkpointer, channel=channel,
            shadow_nodes=shadow_nodes, shadow_async=shadow_async,
            failure_plan=failure_plan, seed=seed,
            straggler_ema=straggler_ema, straggler_factor=straggler_factor,
            state=state, step_hook=step_hook, device=device, rules=rules,
            elastic_rules=elastic_rules)
    if rules is None:
        rules = ShardingRules(make_smoke_mesh(device))
    elif placement_device(rules) != device:
        raise ValueError(f"rules on {rules.mesh.device}, run on {device}")
    failure_plan = failure_plan or FailurePlan()
    stream = SyntheticStream(cfg, batch, seq, seed=seed)
    if state is None:
        state = make_train_state(cfg, seed, device)
    if channel is not None:
        if checkpointer is not None:
            raise ValueError("pass either checkpointer= or channel=, not both")
        shadow = ShadowCluster(layout_for_tree(state.params), opt,
                               n_nodes=shadow_nodes, async_mode=shadow_async,
                               device=device)
        shadow.bootstrap(state.params, state.mu, state.nu, state.step)
        checkpointer = CheckmateCheckpointer(shadow, channel=channel)
    checkpointer = checkpointer or NoCheckpointer()

    def make_capture():
        if not checkpointer.consumes_grads:
            return None
        return Capture(checkpointer.shadow.layout, device,
                       host=not getattr(checkpointer.channel,
                                        "device_flats", False))

    capture = make_capture()
    step_fn = build_train_step(cfg, opt, lr_fn, rules)
    stats = LoopStats(checkpointer=checkpointer)
    ema_iter = None
    step = int(state.step)
    ob = _obs.get()
    while step < steps:
        with ob.tracer.span("data.batch", args={"step": step + 1}):
            dbatch = device_batch(stream.batch_at(step), device)
        if failure_plan.should_fail(step + 1):
            # fail mid-iteration: the device state for this step is lost
            stats.failures += 1
            with ob.tracer.span("recovery.restore", track="recovery",
                                args={"failed_step": step + 1}):
                restored = checkpointer.restore()
            if restored is None:
                raise TrainingFailure(f"injected failure at step {step + 1} "
                                      f"and no checkpoint to restore")
            state = None                 # free the lost state first
            nr = (elastic_rules(step + 1) if callable(elastic_rules)
                  else elastic_rules)
            if nr is not None and nr is not rules:
                # elastic restart: land the checkpoint on the new rules'
                # mesh and rebuild everything the old layout derived (step
                # function, shadow plane and channel, and the capture,
                # whose buffers follow the old plane's layout)
                rules, device = nr, placement_device(nr)
                step_fn = build_train_step(cfg, opt, lr_fn, rules)
                if isinstance(checkpointer, CheckmateCheckpointer):
                    from repro_torch.core.elastic import rebuild_shadow
                    checkpointer.reconfigure(rebuild_shadow(
                        checkpointer.shadow, restored, device=device))
                    capture = make_capture()
                elastic_rules = None     # the switch fires once
            state = state_from_checkpoint(restored, device)
            step = int(restored["step"])
            stats.recoveries += 1
            stats.recovered_at.append(step)
            ob.tracer.instant("recovery.resume", track="recovery",
                              args={"resumed_step": step})
            ob.metrics.counter("train_recoveries_total",
                               "Recoveries from injected failures").inc(1)
            continue
        t0 = time.perf_counter()
        with ob.tracer.span("step.compute", args={"step": step + 1}):
            state, metrics, grads = step_fn(state, dbatch)
            loss = float(metrics["loss"])    # waits for the step
        iter_time = time.perf_counter() - t0
        step += 1
        stats.steps += 1
        stats.iter_times.append(iter_time)
        stats.losses.append(loss)

        ema_iter = _flag_straggler(stats, step, iter_time, ema_iter,
                                   straggler_ema, straggler_factor)

        flats = None
        if capture is not None:
            t1 = time.perf_counter()
            capture.step = step
            with ob.tracer.span("capture.d2h", args={"step": step}):
                flats = capture(grads)
            stats.capture_times.append(time.perf_counter() - t1)
        del grads
        stall = checkpointer.on_step(StepEvent(
            step=step, flats=flats, lr=metrics["lr"],
            grad_scale=metrics["grad_scale"], iter_time=iter_time,
            state_fn=lambda: checkpoint_from_state(state)))
        stats.stall_times.append(stall)
        ob.metrics.counter("train_steps_total", "Completed iterations").inc(1)
        if step_hook is not None:
            step_hook(step, state, stats)

    checkpointer.finalize()
    return state, stats


# rank 0's word to the other ranks after a step (`_train_over_ranks`)
_DONE, _GATHER = 0, 1


def _train_over_ranks(cfg: ModelConfig, *, steps, batch, seq, opt, lr_fn,
                      checkpointer, channel, shadow_nodes, shadow_async,
                      failure_plan, seed, straggler_ema, straggler_factor,
                      state, step_hook, device, rules, elastic_rules):
    """`train` on a mesh of more than one rank, in this rank's process."""
    mesh = rules.mesh
    rank0 = dist.get_rank() == 0
    if not mesh.is_member or 0 not in mesh.ranks:
        raise ValueError(f"train over {mesh.ranks}: this rank and global "
                         f"rank 0 (the shadow's host) must be in the mesh")
    failure_plan = failure_plan or FailurePlan()
    stream = SyntheticStream(cfg, batch, seq, seed=seed)
    if state is None:
        state = make_train_state(cfg, seed, device, rules)
    step_fn = build_train_step(cfg, opt, lr_fn, rules)
    specs = step_fn.sharding
    layout = build_buckets([(k, specs.shapes[k], "float32")
                            for k in state.params])
    error = None
    if not rank0 and checkpointer is not None:
        error = "over ranks only global rank 0 hosts a checkpointer"
    elif rank0 and channel is not None and checkpointer is not None:
        error = "pass either checkpointer= or channel=, not both"
    elif rank0 and channel is None:
        checkpointer = checkpointer or NoCheckpointer()
    # every rank learns every rank's error (all raise together) and rank
    # 0's plan: whether it builds Checkmate's shadow from ``channel``,
    # whether its checkpointer consumes gradients (on the host or the
    # card) and whether it may read the state (then the others follow its
    # word after every step)
    build = rank0 and channel is not None and error is None
    ch = channel if build else getattr(checkpointer, "channel", None)
    consumes = build or getattr(checkpointer, "consumes_grads", False)
    reads = build or (checkpointer is not None
                      and not isinstance(checkpointer, NoCheckpointer))
    flags = [None] * len(mesh.ranks)
    dist.all_gather_object(flags, (
        error, build, bool(consumes), not getattr(ch, "device_flats", False),
        reads), group=mesh.mesh_group)
    errors = [f[0] for f in flags if f[0] is not None]
    if errors:
        raise ValueError(errors[0])
    _, build, consumes, host, reads = flags[0]
    gather = RankStateGather(specs, device) if reads else None
    if build:                            # rank 0's shadow from the whole state
        whole = gather(state)
        if rank0:
            shadow = ShadowCluster(layout, opt, n_nodes=shadow_nodes,
                                   async_mode=shadow_async, device=device)
            shadow.bootstrap(whole["params"], whole["mu"], whole["nu"],
                             whole["step"])
            checkpointer = CheckmateCheckpointer(shadow, channel=channel)
        del whole
    word = torch.zeros(1, dtype=torch.int32, device=device)

    def say(w: int):
        """Rank 0's word to the others: _GATHER or _DONE."""
        word.fill_(w)
        dist.broadcast(word, src=0, group=rules.mesh.mesh_group)

    def state_fn() -> dict:
        say(_GATHER)
        return gather(state)

    def follow() -> float:
        """Another rank's side of a step's exchange: send its slices at
        each _GATHER until _DONE; returns the exchange's wall time."""
        t = time.perf_counter()
        while True:
            dist.broadcast(word, src=0, group=rules.mesh.mesh_group)
            if int(word.item()) == _DONE:
                return time.perf_counter() - t
            gather(state)

    def make_capture(step_fn):
        if not consumes:
            return None
        plane = getattr(checkpointer, "shadow", None)
        return RankCapture(step_fn.sharding,
                           plane.layout if plane is not None else layout,
                           device, host=host)

    capture = make_capture(step_fn)
    stats = LoopStats(checkpointer=checkpointer if rank0 else None)
    ema_iter = None
    step = int(state.step)
    ob = _obs.get()
    while step < steps:
        with ob.tracer.span("data.batch", args={"step": step + 1}):
            dbatch = device_batch(stream.batch_at(step), device, rules,
                                  cfg.microbatches)
        if failure_plan.should_fail(step + 1):
            stats.failures += 1
            restored = None
            if rank0:
                with ob.tracer.span("recovery.restore", track="recovery",
                                    args={"failed_step": step + 1}):
                    restored = checkpointer.restore()
            ok = [restored is not None]
            dist.broadcast_object_list(ok, src=0, group=rules.mesh.mesh_group)
            if not ok[0]:
                raise TrainingFailure(f"injected failure at step {step + 1} "
                                      f"and no checkpoint to restore")
            state = None
            nr = (elastic_rules(step + 1) if callable(elastic_rules)
                  else elastic_rules)
            if nr is not None and nr is not rules:
                rules, device = nr, placement_device(nr)
                elastic_rules = None     # the switch fires once
                if not rules.mesh.is_member:
                    return None, stats   # this rank left the world
                if rank0 and isinstance(checkpointer, CheckmateCheckpointer):
                    from repro_torch.core.elastic import rebuild_shadow
                    checkpointer.reconfigure(rebuild_shadow(
                        checkpointer.shadow, restored, device=device))
                step_fn = build_train_step(cfg, opt, lr_fn, rules)
                capture = make_capture(step_fn)
                if reads:
                    gather = RankStateGather(step_fn.sharding, device)
            restored = broadcast_checkpoint(restored, rules.mesh)
            state = state_from_checkpoint(restored, device, rules, cfg)
            step = int(restored["step"])
            del restored
            stats.recoveries += 1
            stats.recovered_at.append(step)
            ob.tracer.instant("recovery.resume", track="recovery",
                              args={"resumed_step": step})
            ob.metrics.counter("train_recoveries_total",
                               "Recoveries from injected failures").inc(1)
            continue
        t0 = time.perf_counter()
        with ob.tracer.span("step.compute", args={"step": step + 1}):
            state, metrics, grads = step_fn(state, dbatch)
            loss = float(metrics["loss"])
        iter_time = time.perf_counter() - t0
        step += 1
        stats.steps += 1
        stats.iter_times.append(iter_time)
        stats.losses.append(loss)
        ema_iter = _flag_straggler(stats, step, iter_time, ema_iter,
                                   straggler_ema, straggler_factor)
        flats = None
        if capture is not None:
            t1 = time.perf_counter()
            capture.step = step
            with ob.tracer.span("capture.d2h", args={"step": step}):
                flats = capture(grads)
            stats.capture_times.append(time.perf_counter() - t1)
        del grads
        stall = 0.0
        if rank0:
            stall = checkpointer.on_step(StepEvent(
                step=step, flats=flats, lr=metrics["lr"],
                grad_scale=metrics["grad_scale"], iter_time=iter_time,
                state_fn=state_fn if reads else None))
            if reads:
                say(_DONE)
        elif reads:
            stall = follow()
        stats.stall_times.append(stall)
        ob.metrics.counter("train_steps_total", "Completed iterations").inc(1)
        if step_hook is not None:
            step_hook(step, state, stats)
    if rank0:
        checkpointer.finalize()
    return state, stats
