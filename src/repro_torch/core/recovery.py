"""Failure injection and recovery from the shadow checkpoint, including
elastic restart (restore onto other sharding rules) — the port of
``repro.core.recovery``.

Recovery consolidates the shadow partitions into a full checkpoint — or,
when shadow nodes are lost, rebuilds what they held from the durability
tiers — rebuilds the trainer's state from it on the device, and resumes
the data stream at the checkpoint step; the stream is a pure function of
(seed, step), so the recovered run replays the identical batches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.shadow import ShadowCluster, ShadowNodeLoss
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


def placement_device(rules) -> torch.device:
    """The device a state lands on under ``rules``: its mesh's, which
    must be a one-rank mesh (more ranks is ROADMAP item 11b)."""
    if rules.mesh.size > 1:
        raise NotImplementedError(
            f"a trainer state over a mesh of {rules.mesh.size} ranks "
            f"({rules.mesh.shape}) is ROADMAP item 11b")
    return rules.mesh.device


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
            timeout: Optional[float] = None,
            allow_partial: bool = False,
            tiers=None,
            new_rules=None) -> tuple[TrainState, int]:
    """Consolidate the shadow cluster and rebuild the trainer's state on
    ``device``; returns (state, resume_step).

    A lost shadow node surfaces as `ShadowNodeLoss` naming exactly the
    missing buckets, and by default that propagates: recovery never hands
    back a checkpoint with holes. ``tiers`` (`repro_torch.durability`
    tiers) is the durable fallback. On a *partial* loss the dead owners'
    shards are rebuilt from the tiers at exactly the survivors' step and
    merged with the live partial; on a *total* loss
    (``ShadowNodeLoss.total``) the whole checkpoint is restored from the
    newest durable epoch (the one ``ShadowNodeLoss.durable_hint`` names).
    Only where the tiers cannot serve does ``allow_partial=True`` rebuild
    the surviving leaves alone.

    ``new_rules`` (a `repro_torch.dist.sharding.ShardingRules`) is the
    elastic-restart path (`repro_torch.core.elastic`): the consolidated
    checkpoint — a full unsharded tree, from the live plane or the tiers —
    lands on a mesh other than the run's. The tiers are always read with
    the OLD capture layout (``shadow.layout`` and ``shadow.n_nodes`` wrote
    those records); only the final placement follows the new rules, on
    the new mesh's device (``device`` is then not used). A mesh of more
    than one rank raises: laying the state out over ranks is ROADMAP item
    11b. The caller then rebuilds what the old layout derived
    (`repro_torch.core.elastic.rebuild_shadow` +
    `CheckmateCheckpointer.reconfigure`).
    """
    if new_rules is not None:
        device = placement_device(new_rules)
    try:
        ckpt = shadow.consolidate(timeout=timeout)
    except ShadowNodeLoss as e:
        ckpt = None
        if tiers:
            from repro_torch.durability.restore import (
                TierRestoreError, restore_from_tiers,
                restore_shards_from_tiers)
            try:
                if e.total:
                    ckpt = restore_from_tiers(tiers, shadow.layout,
                                              n_nodes=shadow.n_nodes)
                else:
                    p, m, v = restore_shards_from_tiers(
                        tiers, shadow.layout, e.dead_nodes,
                        at_step=int(e.partial["step"]))
                    ckpt = {"params": {**e.partial["params"], **p},
                            "mu": {**e.partial["mu"], **m},
                            "nu": {**e.partial["nu"], **v},
                            "step": int(e.partial["step"])}
            except TierRestoreError:
                ckpt = None          # the tiers cannot serve: fall through
        if ckpt is None:
            if not allow_partial:
                raise
            ckpt = e.partial
    return state_from_checkpoint(ckpt, device), int(ckpt["step"])
