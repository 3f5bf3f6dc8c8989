"""Failure injection and recovery from the shadow checkpoint, the port of
``repro.core.recovery`` (no durability tiers, no elastic restart yet).

Recovery consolidates the shadow partitions into a full checkpoint,
rebuilds the trainer's state from it on the device, and resumes the
data stream at the checkpoint step; the stream is a pure function of
(seed, step), so the recovered run replays the identical batches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.shadow import ShadowCluster
from repro_torch.device import resolve
from repro_torch.optim.functional import TrainState


@dataclass
class FailurePlan:
    """Deterministic failure injection: each planned failure fires once."""
    fail_at_steps: tuple[int, ...] = ()
    fired: set = dataclasses.field(default_factory=set)

    def should_fail(self, step: int) -> bool:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            return True
        return False


def _to_device(tree: dict, device) -> dict:
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(v))
            .to(device, copy=True) for k, v in tree.items()}


def state_from_checkpoint(ckpt: dict, device=None) -> TrainState:
    """A trainer state on ``device`` from a consolidated checkpoint (its
    own copies: the checkpoint's tensors are never aliased)."""
    device = resolve(device)
    return TrainState(params=_to_device(ckpt["params"], device),
                      mu=_to_device(ckpt["mu"], device),
                      nu=_to_device(ckpt["nu"], device),
                      step=int(ckpt["step"]))


def checkpoint_from_state(state: TrainState) -> dict:
    """Host snapshot of a TrainState (the resync path and tests)."""
    return {
        "params": {k: v.detach().to("cpu", copy=True)
                   for k, v in state.params.items()},
        "mu": {k: v.to("cpu", copy=True) for k, v in state.mu.items()},
        "nu": {k: v.to("cpu", copy=True) for k, v in state.nu.items()},
        "step": int(state.step),
    }


def recover(shadow: ShadowCluster, device=None,
            timeout: Optional[float] = None) -> tuple[TrainState, int]:
    """Consolidate the shadow cluster and rebuild the trainer's state;
    returns (state, resume_step). A lost shadow node raises
    `repro_torch.core.shadow.ShadowNodeLoss`."""
    ckpt = shadow.consolidate(timeout=timeout)
    return state_from_checkpoint(ckpt, device), int(ckpt["step"])
