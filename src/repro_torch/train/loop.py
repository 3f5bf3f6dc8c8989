"""Training loop with Checkmate, failure injection and recovery — the port
of ``repro.train.loop.train``.

The train step returns the gradients it applied; the capture packs them on
the device into one flat buffer per bucket (the bucket-pack kernel), copies
each bucket once into pinned host memory, and hands the host flats to the
checkpointer as ``StepEvent.flats``. On an injected failure the loop
restores the shadow's consolidated checkpoint and replays from its step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.buckets import (BucketLayout, alloc_flat, bucket_dtype,
                                      layout_for_tree, pack_bucket_into)
from repro_torch.core.channel import GradientChannel, StepEvent
from repro_torch.core.checkpoint import (BaseCheckpointer,
                                         CheckmateCheckpointer,
                                         NoCheckpointer)
from repro_torch.core.recovery import (FailurePlan, checkpoint_from_state,
                                       state_from_checkpoint)
from repro_torch.core.shadow import ShadowCluster
from repro_torch.data.synthetic import SyntheticStream, device_batch
from repro_torch.device import resolve
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
    checkpointer: Optional[BaseCheckpointer] = None

    @property
    def steady_iter(self) -> float:
        """Median iteration time excluding the first (warm-up) step."""
        xs = self.iter_times[1:] if len(self.iter_times) > 1 \
            else self.iter_times
        return float(np.median(xs)) if xs else 0.0


class Capture:
    """Gradient leaves -> per-bucket host flats, once per step.

    On the card each bucket is packed into a device buffer reused across
    steps, then copied into a fresh pinned host buffer (a shadow may still
    hold the previous step's); the copies are awaited before returning.
    On the CPU the pack writes the host buffer directly.
    """

    def __init__(self, layout: BucketLayout, device: torch.device):
        self.layout = layout
        self.device = device
        self._dev: dict[int, torch.Tensor] = {}

    def __call__(self, grads: dict) -> dict:
        flats = {}
        cuda = self.device.type == "cuda"
        for b in self.layout.buckets:
            dt = bucket_dtype(b)
            if not cuda:
                flats[b.bucket_id] = pack_bucket_into(
                    b, grads, alloc_flat(b.size, dt))
                continue
            buf = self._dev.get(b.bucket_id)
            if buf is None:
                buf = self._dev[b.bucket_id] = alloc_flat(b.size, dt,
                                                          self.device)
            pack_bucket_into(b, grads, buf)
            host = alloc_flat(b.size, dt, "cpu", pin=True)
            host.copy_(buf, non_blocking=True)
            flats[b.bucket_id] = host
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return flats


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
          state: Optional[TrainState] = None,
          step_hook: Optional[Callable] = None,
          device=None) -> tuple[TrainState, LoopStats]:
    """Run ``steps`` iterations; on an injected failure, restore from the
    checkpointer (Checkmate: shadow consolidation) and continue.

    ``channel`` builds a bootstrapped `ShadowCluster` (``shadow_nodes``
    nodes on ``device``, worker threads if ``shadow_async``) and a
    `CheckmateCheckpointer` wired through that channel, exposed as
    ``stats.checkpointer``. Mutually exclusive with ``checkpointer``.
    ``step_hook(step, state, stats)`` runs after every completed iteration.
    """
    device = resolve(device)
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
    capture = None
    if checkpointer.consumes_grads:
        capture = Capture(checkpointer.shadow.layout, device)

    step_fn = build_train_step(cfg, opt, lr_fn)
    stats = LoopStats(checkpointer=checkpointer)
    step = int(state.step)
    while step < steps:
        dbatch = device_batch(stream.batch_at(step), device)
        if failure_plan.should_fail(step + 1):
            # fail mid-iteration: the device state for this step is lost
            stats.failures += 1
            restored = checkpointer.restore()
            if restored is None:
                raise TrainingFailure(f"injected failure at step {step + 1} "
                                      f"and no checkpoint to restore")
            state = None                 # free the lost state first
            state = state_from_checkpoint(restored, device)
            step = int(restored["step"])
            stats.recoveries += 1
            stats.recovered_at.append(step)
            continue
        t0 = time.perf_counter()
        state, metrics, grads = step_fn(state, dbatch)
        loss = float(metrics["loss"])    # waits for the step
        iter_time = time.perf_counter() - t0
        step += 1
        stats.steps += 1
        stats.iter_times.append(iter_time)
        stats.losses.append(loss)

        flats = None
        if capture is not None:
            t1 = time.perf_counter()
            flats = capture(grads)
            stats.capture_times.append(time.perf_counter() - t1)
        del grads
        stall = checkpointer.on_step(StepEvent(
            step=step, flats=flats, lr=metrics["lr"],
            grad_scale=metrics["grad_scale"], iter_time=iter_time,
            state_fn=lambda: checkpoint_from_state(state)))
        stats.stall_times.append(stall)
        if step_hook is not None:
            step_hook(step, state, stats)

    checkpointer.finalize()
    return state, stats
