"""Failure injection and recovery from the shadow checkpoint, including
elastic restart (restore onto other sharding rules) — the port of
``repro.core.recovery``.

Recovery consolidates the shadow partitions into a full checkpoint — or,
when shadow nodes are lost, rebuilds what they held from the durability
tiers — rebuilds the trainer's state from it on the device, and resumes
the data stream at the checkpoint step; the stream is a pure function of
(seed, step), so the recovered run replays the identical batches.

Over more than one rank (one process per rank) the shadow lives on global
rank 0: it consolidates, ``broadcast_checkpoint`` sends the full
checkpoint to every rank of the mesh, and each rank keeps its slices of
it (``state_from_checkpoint`` with ``rules``: a leaf's dp cut and, for a
tensor-parallel family, its model cut).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

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


def state_from_checkpoint(ckpt: dict, device=None, rules=None,
                          cfg=None) -> TrainState:
    """A trainer state on ``device`` from a consolidated checkpoint (its
    own copies: the checkpoint's tensors are never aliased). On ``rules``
    over more than one dp rank each leaf lands by its spec, this rank's
    slice of it: params by the param spec, mu and nu by the ZeRO-1 spec
    (``cfg`` gives the leaves' logical specs)."""
    device = resolve(device)
    params = _to_device(ckpt["params"], device)
    mu = _to_device(ckpt["mu"], device)
    nu = _to_device(ckpt["nu"], device)
    if rules is not None and rules.mesh.size > 1:
        if cfg is None:
            raise ValueError("landing a checkpoint over ranks needs cfg "
                             "(the leaves' logical specs)")
        from repro_torch.train.step import state_sharding
        params, mu, nu = state_sharding(cfg, rules).local(params, mu, nu)
    return TrainState(params=params, mu=mu, nu=nu, step=int(ckpt["step"]))


def placement_device(rules) -> torch.device:
    """The device a state lands on under ``rules``: its mesh's (each rank
    of a larger mesh holds its slices there)."""
    return rules.mesh.device


def broadcast_checkpoint(ckpt: Optional[dict], mesh) -> dict:
    """Global rank 0's full checkpoint on every rank of ``mesh``
    (collective over the mesh's ranks; the leaves travel on the mesh's
    device, and land on the host). Rank 0 passing None (it could not
    consolidate) raises on every rank."""
    group = mesh.mesh_group
    meta = [None]
    if dist.get_rank() == 0 and ckpt is not None:
        meta = [{t: [(k, tuple(v.shape), v.dtype) for k, v in ckpt[t].items()]
                 for t in ("params", "mu", "nu")} | {"step": int(ckpt["step"])}]
    dist.broadcast_object_list(meta, src=0, group=group)
    if meta[0] is None:
        raise RuntimeError("global rank 0 has no checkpoint to broadcast")
    out = {"step": meta[0]["step"]}
    for t in ("params", "mu", "nu"):
        out[t] = {}
        for k, shape, dtype in meta[0][t]:
            x = (ckpt[t][k].to(mesh.device, copy=True) if ckpt is not None
                 else torch.empty(shape, dtype=dtype, device=mesh.device))
            dist.broadcast(x, src=0, group=group)
            out[t][k] = x.cpu()
    return out


def checkpoint_from_state(state: TrainState) -> dict:
    """Host snapshot of a TrainState (the resync path and tests)."""
    return {
        "params": {k: v.detach().to("cpu", copy=True)
                   for k, v in state.params.items()},
        "mu": {k: v.to("cpu", copy=True) for k, v in state.mu.items()},
        "nu": {k: v.to("cpu", copy=True) for k, v in state.nu.items()},
        "step": int(state.step),
    }


def recover(shadow: Optional[ShadowCluster], device=None,
            timeout: Optional[float] = None,
            allow_partial: bool = False,
            tiers=None,
            new_rules=None,
            cfg=None) -> tuple[TrainState, int]:
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
    the new mesh's device (``device`` is then not used). On a mesh of
    more than one rank this is collective over its ranks: global rank 0
    passes the shadow and consolidates, the others pass None, rank 0
    broadcasts the checkpoint, and each rank keeps its slices (``cfg``
    gives the leaves' specs). The caller then rebuilds what the old
    layout derived (`repro_torch.core.elastic.rebuild_shadow` +
    `CheckmateCheckpointer.reconfigure`, on rank 0).
    """
    over_ranks = new_rules is not None and new_rules.mesh.size > 1
    if new_rules is not None:
        device = placement_device(new_rules)
    if over_ranks and dist.get_rank() != 0:
        ckpt = broadcast_checkpoint(None, new_rules.mesh)
    else:
        try:
            ckpt = _consolidate(shadow, timeout, allow_partial, tiers)
        except BaseException:
            if over_ranks:     # the others wait on the broadcast
                dist.broadcast_object_list([None], src=0,
                                           group=new_rules.mesh.mesh_group)
            raise
        if over_ranks:
            ckpt = broadcast_checkpoint(ckpt, new_rules.mesh)
    return (state_from_checkpoint(ckpt, device, new_rules, cfg),
            int(ckpt["step"]))


def _consolidate(shadow: ShadowCluster, timeout, allow_partial: bool,
                 tiers) -> dict:
    """The full checkpoint from the live plane, else from the tiers."""
    try:
        return shadow.consolidate(timeout=timeout)
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
        return ckpt
