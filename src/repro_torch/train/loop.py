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
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import (BucketLayout, alloc_flat, bucket_dtype,
                                      layout_for_tree, pack_bucket_into)
from repro_torch.core.channel import GradientChannel, StepEvent, to_host
from repro_torch.core.checkpoint import (BaseCheckpointer,
                                         CheckmateCheckpointer,
                                         NoCheckpointer)
from repro_torch.core.recovery import (FailurePlan, checkpoint_from_state,
                                       placement_device,
                                       state_from_checkpoint)
from repro_torch.core.shadow import ShadowCluster
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.device import resolve
from repro_torch.dist.sharding import ShardingRules, make_smoke_mesh
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
    mesh on ``device``; a mesh of more ranks raises, ROADMAP item 11b).
    ``elastic_rules`` is the elastic-restart path (`repro_torch.core
    .elastic`): rules for the post-failure mesh, or a callable
    ``(failed_step) -> rules | None`` (None keeps the current layout). On
    the first recovery that yields other rules the loop rebuilds the step
    function, the shadow plane and channel against the re-derived bucket
    layout (`CheckmateCheckpointer.reconfigure`, booked as the
    ``elastic-reshard`` stall stage) and the capture against the new
    plane's layout, lands the checkpoint on the new mesh's device, and
    resumes; the switch fires once. The data stream needs no rebuild: it
    is the global batch as a pure function of (seed, step).
    """
    device = resolve(device)
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
    step_fn = build_train_step(cfg, opt, lr_fn)
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
                step_fn = build_train_step(cfg, opt, lr_fn)
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

        # straggler observability: EMA-based slow-iteration flag
        if ema_iter is None:
            ema_iter = iter_time
        else:
            if iter_time > straggler_factor * ema_iter:
                stats.straggler_flags.append(step)
            ema_iter = (straggler_ema * ema_iter
                        + (1 - straggler_ema) * iter_time)

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
