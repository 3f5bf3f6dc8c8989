"""Tier-aware restore: base + delta chain -> full consolidated checkpoint,
the port of ``repro.durability.restore``.

`restore_from_tiers` walks a tier's manifest epochs **newest first** and
returns the first epoch it can fully reconstruct: every cluster node
present at one common step, every record chain (latest base + subsequent
deltas) intact. A torn record anywhere in a chain — detected by the
checksums of `repro_torch.durability.record` — disqualifies that epoch
and the walk falls back to the previous one; if a whole tier is unusable
the next tier is tried. The reconstruction itself replays exactly the flush
arithmetic: raw records overwrite bucket flats; compressed deltas add
their dequantized int8 diffs to an f32 accumulator (matching the
worker's reconstruction buffer bit for bit, which is why a raw-policy
restore is bit-identical to the shadow state it snapshotted). Records are
read through `FlushRecord.read_from`, one array buffer at a time; raw f32
arrays are adopted as they were read, never copied again. The result is
host tensors, as `ShadowCluster.consolidate` returns.

`restore_shards_from_tiers` is the partial-loss composition path used
by `repro_torch.core.recovery.recover`: rebuild ONLY the dead owners'
buckets at exactly the surviving nodes' step, so survivors' live
fragments and the tiers' durable shards merge into one consistent
checkpoint.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import torch

from repro_torch.core.buckets import BucketLayout, unpack_bucket
from repro_torch.dist.compression import dequantize_flat_stateless
from repro_torch.durability.record import TornRecordError
from repro_torch.durability.tiers import ManifestEntry, Tier


class TierRestoreError(RuntimeError):
    """No tier holds a consistent, intact restore point."""


def _per_node(entries: list[ManifestEntry]) -> dict[int, list[ManifestEntry]]:
    out: dict[int, list[ManifestEntry]] = {}
    for e in entries:
        out.setdefault(e.node, []).append(e)
    for lst in out.values():
        lst.sort(key=lambda e: e.epoch)
    return out


def _chain(node_entries: list[ManifestEntry], target_epoch: int
           ) -> list[ManifestEntry]:
    """Latest base at/before ``target_epoch`` through ``target_epoch``."""
    upto = [e for e in node_entries if e.epoch <= target_epoch]
    base_idx = None
    for i, e in enumerate(upto):
        if e.kind == "base":
            base_idx = i
    if base_idx is None:
        raise TierRestoreError(
            f"no base record at/before epoch {target_epoch}")
    return upto[base_idx:]


def _reconstruct_node(tier: Tier, chain: list[ManifestEntry], by_id: dict
                      ) -> dict[int, tuple]:
    """Replay one node's chain -> {bucket_id: (p, m, v) host tensors}.

    Raises `TornRecordError` if any record in the chain fails
    validation — the caller falls back to an older epoch.
    """
    # f32 accumulators + the param wire dtype remembered from the base
    acc: dict[int, dict[str, torch.Tensor]] = {}
    pdtype: dict[int, torch.dtype] = {}
    for entry in chain:
        rec = tier.read(entry)
        if rec.kind == "mark":
            continue
        if not rec.compressed:
            for bid, fields in rec.payload.items():
                if rec.kind == "base" or bid not in acc:
                    pdtype[bid] = fields["p"].dtype
                acc[bid] = {"p": fields["p"].float(),
                            "m": fields["m"].float(),
                            "v": fields["v"].float()}
        else:
            for bid, fields in rec.payload.items():
                b = by_id[bid]
                cur = acc[bid]
                for name in ("p", "m", "v"):
                    # in place: the accumulators are this restore's own
                    cur[name].add_(dequantize_flat_stateless(
                        b, fields[name], fields[name + "s"]))
    return {bid: (a["p"].to(pdtype[bid]), a["m"], a["v"])
            for bid, a in acc.items()}


def _each_node(fn, node_ids) -> list:
    """``fn(nid)`` for every node id, the nodes' chains read concurrently
    (file reads and the CRC release the GIL); the first exception in
    node order propagates."""
    ids = sorted(node_ids)
    if len(ids) < 2:
        return [fn(nid) for nid in ids]
    with ThreadPoolExecutor(max_workers=len(ids)) as ex:
        return list(ex.map(fn, ids))


def _unpack(layout: BucketLayout, flats: dict[int, tuple], step: int
            ) -> dict:
    by_id = {b.bucket_id: b for b in layout.buckets}
    params: dict = {}
    mu: dict = {}
    nu: dict = {}
    for bid, (p, m, v) in flats.items():
        b = by_id[bid]
        params.update(unpack_bucket(b, p))
        mu.update(unpack_bucket(b, m))
        nu.update(unpack_bucket(b, v))
    return {"params": params, "mu": mu, "nu": nu, "step": int(step)}


def restore_from_tiers(tiers: Iterable[Tier], layout: BucketLayout,
                       n_nodes: Optional[int] = None) -> dict:
    """Reconstruct the newest full consolidated checkpoint any tier holds.

    Returns ``{"params", "mu", "nu", "step"}`` exactly like
    `ShadowCluster.consolidate`. ``n_nodes`` pins the completeness bar
    (how many shadow nodes a full epoch must cover); by default it is
    inferred as every node id the tier has ever seen.
    """
    all_buckets = {b.bucket_id for b in layout.buckets}
    by_id = {b.bucket_id: b for b in layout.buckets}
    reasons = []
    best: Optional[tuple[int, dict]] = None      # (step, flats)
    for tier in tiers:
        try:
            entries = list(tier.entries())
        except Exception as e:               # unreadable manifest: next tier
            reasons.append(f"{tier.name}: manifest unreadable ({e})")
            continue
        if not entries:
            reasons.append(f"{tier.name}: empty")
            continue
        need = (set(range(n_nodes)) if n_nodes is not None
                else {e.node for e in entries})
        per_node = _per_node(entries)
        by_epoch: dict[int, dict[int, ManifestEntry]] = {}
        for e in entries:
            by_epoch.setdefault(e.epoch, {})[e.node] = e
        served = False
        for epoch in sorted(by_epoch, reverse=True):
            at = by_epoch[epoch]
            if not need <= set(at):
                continue                     # incomplete epoch (dead nodes)
            steps = {at[n].step for n in need}
            if len(steps) != 1:
                continue                     # nodes landed at unequal steps
            step = steps.pop()
            try:
                flats: dict[int, tuple] = {}
                for part in _each_node(lambda nid: _reconstruct_node(
                        tier, _chain(per_node[nid], epoch), by_id), need):
                    flats.update(part)
            except (TornRecordError, TierRestoreError, KeyError):
                continue                     # torn/missing: older epoch
            if set(flats) != all_buckets:
                continue                     # nodes don't cover the layout
            # a slower tier may still hold the newest epoch (e.g. the
            # faster one refused a write): keep the best across ALL tiers
            if best is None or step > best[0]:
                best = (step, flats)
            served = True
            break                            # this tier's newest; next tier
        if not served:
            reasons.append(f"{tier.name}: no consistent intact epoch")
    if best is not None:
        return _unpack(layout, best[1], best[0])
    raise TierRestoreError(
        "restore_from_tiers found no usable restore point: "
        + "; ".join(reasons))


def restore_shards_from_tiers(tiers: Iterable[Tier], layout: BucketLayout,
                              node_ids: Iterable[int], at_step: int
                              ) -> tuple[dict, dict, dict]:
    """Rebuild ONLY ``node_ids``'s buckets at exactly ``at_step``.

    Returns ``(params, mu, nu)`` leaf trees covering just those nodes'
    partitions — the merge fragment `recover` composes with the
    survivors' live partial after a non-total `ShadowNodeLoss`. Raises
    `TierRestoreError` if no tier holds every requested node at that
    exact step with an intact chain.
    """
    node_ids = sorted(set(node_ids))
    by_id = {b.bucket_id: b for b in layout.buckets}
    reasons = []
    for tier in tiers:
        try:
            entries = list(tier.entries())
        except Exception as e:
            reasons.append(f"{tier.name}: manifest unreadable ({e})")
            continue
        per_node = _per_node(entries)

        def rebuild(nid):
            cands = [e.epoch for e in per_node.get(nid, [])
                     if e.step == at_step]
            for epoch in sorted(cands, reverse=True):
                try:
                    return _reconstruct_node(
                        tier, _chain(per_node[nid], epoch), by_id)
                except (TornRecordError, TierRestoreError, KeyError):
                    continue
            return None

        flats: dict[int, tuple] = {}
        missing = None
        for nid, rebuilt in zip(node_ids, _each_node(rebuild, node_ids)):
            if rebuilt is None:
                missing = nid
                break
            flats.update(rebuilt)
        if missing is not None:
            reasons.append(
                f"{tier.name}: node {missing} has no intact record at "
                f"step {at_step}")
            continue
        params: dict = {}
        mu: dict = {}
        nu: dict = {}
        for bid, (p, m, v) in flats.items():
            b = by_id[bid]
            params.update(unpack_bucket(b, p))
            mu.update(unpack_bucket(b, m))
            nu.update(unpack_bucket(b, v))
        return params, mu, nu
    raise TierRestoreError(
        f"no tier holds nodes {node_ids} at step {at_step}: "
        + "; ".join(reasons))
