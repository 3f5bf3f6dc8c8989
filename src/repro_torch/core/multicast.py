"""Bucket ownership across shadow nodes (paper §4.2.4), the port's copy of
``repro.core.multicast.assign_buckets``. The switch control plane comes
with the fabric's port."""
from __future__ import annotations

from repro_torch.core.buckets import BucketLayout


def assign_buckets(layout: BucketLayout, n_nodes: int) -> dict[int, int]:
    """bucket_id -> shadow node, byte-balanced greedy partition.

    Deterministic: buckets in id order onto the currently-lightest node, so
    training side and shadow nodes all derive the same mapping.
    """
    load = [0] * n_nodes
    out = {}
    for b in layout.buckets:
        node = min(range(n_nodes), key=lambda i: (load[i], i))
        out[b.bucket_id] = node
        load[node] += b.nbytes
    return out
