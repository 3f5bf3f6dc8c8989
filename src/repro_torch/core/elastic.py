"""Elastic restore, the mesh-free half: re-derive the shadow plane for a
re-partitioned world — the port of ``repro.core.elastic``.

The shadow's consolidated checkpoint is already a full unsharded tree, so
landing it on a different parallelism layout needs no data movement
beyond the normal restore; what has to be rebuilt is everything the old
layout derived:

* the capture-side `BucketLayout` and the bucket -> shadow-node ownership
  map (``rebuild_shadow``);
* the shadow plane itself: a fresh `ShadowCluster` re-seeded from the
  checkpoint, with the attached `repro_torch.durability.DurableShadow`
  (if any) migrated over — its tiers keep every durable epoch written
  under the old layout, and the re-seed forces a new full base at the
  resume step so ``newest_durable`` never moves backwards;
* the `GradientChannel` + checkpointer wiring
  (`CheckmateCheckpointer.reconfigure`), booked on the stall ledger as the
  named ``elastic-reshard`` stage.

The physical mesh (``mesh_from_plan``, ``rules_from_plan``) waits for the
port's multi-GPU slice; `plan_elastic_mesh` is the port's `costmodel`'s.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.buckets import layout_for_tree
from repro_torch.core.costmodel import (ElasticMeshBudget, ElasticPlan,
                                        ElasticPlanError, plan_elastic_mesh)
from repro_torch.core.shadow import ShadowCluster

__all__ = ["ElasticMeshBudget", "ElasticPlan", "ElasticPlanError",
           "ELASTIC_STAGE", "plan_elastic_mesh", "rebuild_shadow"]

#: Stall-ledger stage name for the whole plane reconfiguration (channel
#: close/open + shadow swap), in `repro_torch.obs.stalls.KNOWN_STAGES`.
ELASTIC_STAGE = "elastic-reshard"


def rebuild_shadow(old: ShadowCluster, ckpt: dict, *,
                   n_nodes: Optional[int] = None,
                   cap_bytes: Optional[int] = None,
                   layout=None, device=None) -> ShadowCluster:
    """Re-derive the shadow plane for a re-partitioned world.

    Builds a fresh `BucketLayout` from the checkpoint's param tree (pass
    ``cap_bytes`` to keep the old bucketing granularity, or ``layout`` to
    inject one), re-derives the bucket ownership map for ``n_nodes``
    (default: the old fleet size) on ``device`` (the card unless the
    caller passes ``device="cpu"``; it raises before touching ``old``
    where that device is absent), migrates the attached `DurableShadow`
    (old durable epochs stay on the tiers; epoch numbering continues),
    shuts the old cluster down, and seeds the new one from ``ckpt`` —
    which, with durability attached, forces a fresh full base at the
    resume step.
    """
    if layout is None:
        layout = (layout_for_tree(ckpt["params"], cap_bytes)
                  if cap_bytes is not None
                  else layout_for_tree(ckpt["params"]))
    new = ShadowCluster(layout, old.opt,
                        n_nodes=old.n_nodes if n_nodes is None else n_nodes,
                        async_mode=old.async_mode, device=device,
                        flat=old.flat)
    dur = old.durability
    old.durability = None          # keep shutdown() from closing the tiers
    if dur is not None:
        dur.reattach(new)          # drains + retires the old flush workers
    old.shutdown()
    new.bootstrap(ckpt["params"], ckpt["mu"], ckpt["nu"],
                  int(ckpt["step"]))
    return new
