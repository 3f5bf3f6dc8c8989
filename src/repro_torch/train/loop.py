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
once.
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
from repro_torch.dist.sharding import (ShardingRules, unravel, dp_axes,
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
    """

    def __init__(self, layout: BucketLayout, device: torch.device,
                 host: bool = True):
        self.layout = layout
        self.device = device
        self.host = host
        self._dev: dict[int, torch.Tensor] = {}

    def __call__(self, grads: dict) -> dict:
        flats = {}
        for b in self.layout.buckets:
            dt = bucket_dtype(b)
            if self.device.type != "cuda":
                flats[b.bucket_id] = pack_bucket_into(
                    b, grads, alloc_flat(b.size, dt))
                continue
            buf = self._dev.get(b.bucket_id)
            if buf is None:
                buf = self._dev[b.bucket_id] = alloc_flat(b.size, dt,
                                                          self.device)
            flats[b.bucket_id] = pack_bucket_into(b, grads, buf)
        return to_host(flats) if self.host else flats


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
        dp = dp_axes(mesh)
        extents = [mesh.shape[a] for a in mesh.axis_names]
        # each mesh rank's share, in mesh order
        self.plans = []
        for i in range(mesh.size):
            c = dict(zip(mesh.axis_names, unravel(i, extents)))
            a = 0
            for ax in dp:
                a = a * mesh.shape[ax] + c[ax]
            self.plans.append(self._plan(a, c.get("model", 0)))
        self.sizes = [sum(e[3] for e in plan) for plan in self.plans]
        self.index = mesh.ranks.index(dist.get_rank())
        self.whole = [k for k, z in sharding.state.items()
                      if z.n == 1 and z.m == 1]
        self.host_rank = dist.get_rank() == 0
        self.inner = Capture(layout, device, host) if self.host_rank \
            else None
        self.marks: list = []
        self.received = 0

    def _plan(self, a: int, b: int) -> list:
        """(leaf, cuts, offset, size) of what the rank at dp index ``a``
        and model index ``b`` sends."""
        plan, off = [], 0
        for k, z in self.sh.state.items():
            if z.n == 1 and z.m == 1:
                continue
            if (z.n == 1 and a) or (z.m == 1 and b):
                continue
            shape, cuts = list(self.sh.shapes[k]), []
            for d, k_, i in ((z.dim, z.n, a), (z.model_dim, z.m, b)):
                if k_ > 1:
                    s = shape[d] // k_
                    cuts.append((d, i * s, (i + 1) * s))
            size = math.prod(self.sh.shapes[k])
            for d, lo, hi in cuts:
                size = size // shape[d] * (hi - lo)
            plan.append((k, tuple(cuts), off, size))
            off += size
        return plan

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
        full = {k: owned[k] for k in self.whole}
        for plan, f in zip(self.plans, flats):
            for k, cuts, off, size in plan:
                if k not in full:
                    full[k] = torch.empty(self.sh.shapes[k],
                                          dtype=torch.float32,
                                          device=self.device)
                idx = [slice(None)] * len(self.sh.shapes[k])
                for d, lo, hi in cuts:
                    idx[d] = slice(lo, hi)
                dst = full[k][tuple(idx)]
                dst.copy_(f[off:off + size].reshape(dst.shape))
        return self.inner({k: full[k] for k in self.sh.shapes})


def _wait(p2p: list) -> None:
    """Issue the point-to-point ops ``p2p`` together and wait for all."""
    if p2p:
        for req in dist.batch_isend_irecv(p2p):
            req.wait()


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
    ``channel``). There the checkpointer is Checkmate or none: a
    copy-persist baseline would need every rank's state at its own
    moments, which is not ported. ``stats.losses`` are the global losses;
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
    params, mu, nu = specs.full(state.params, state.mu, state.nu)
    error = None
    if not rank0 and checkpointer is not None:
        error = "over ranks only global rank 0 hosts a checkpointer"
    elif rank0 and channel is not None and checkpointer is not None:
        error = "pass either checkpointer= or channel=, not both"
    elif rank0:
        if channel is not None:
            shadow = ShadowCluster(layout, opt, n_nodes=shadow_nodes,
                                   async_mode=shadow_async, device=device)
            shadow.bootstrap(params, mu, nu, state.step)
            checkpointer = CheckmateCheckpointer(shadow, channel=channel)
        checkpointer = checkpointer or NoCheckpointer()
        if not (checkpointer.consumes_grads
                or isinstance(checkpointer, NoCheckpointer)):
            error = (f"{type(checkpointer).__name__} over ranks: only "
                     f"Checkmate or no checkpointer is ported")
    del params, mu, nu
    # every rank learns every rank's error (all raise together) and rank
    # 0's capture: whether its checkpointer consumes gradients, and on
    # the host or the card
    flags = [None] * len(mesh.ranks)
    dist.all_gather_object(flags, (
        error, bool(getattr(checkpointer, "consumes_grads", False)),
        not getattr(getattr(checkpointer, "channel", None), "device_flats",
                    False)), group=mesh.mesh_group)
    errors = [f[0] for f in flags if f[0] is not None]
    if errors:
        raise ValueError(errors[0])
    _, consumes, host = flags[0]

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
            with ob.tracer.span("capture.d2h", args={"step": step}):
                flats = capture(grads)
            stats.capture_times.append(time.perf_counter() - t1)
        del grads
        stall = 0.0
        if rank0:
            stall = checkpointer.on_step(StepEvent(
                step=step, flats=flats, lr=metrics["lr"],
                grad_scale=metrics["grad_scale"], iter_time=iter_time))
        stats.stall_times.append(stall)
        ob.metrics.counter("train_steps_total", "Completed iterations").inc(1)
        if step_hook is not None:
            step_hook(step, state, stats)
    if rank0:
        checkpointer.finalize()
    return state, stats
