"""ZeRO-1 optimizer-state specs over the data axes, the port of
``repro.optim.sharded``.

The gradient all-reduce decomposes into reduce-scatter -> sharded update ->
param all-gather. The reduce-scatter *output* is Checkmate's capture point:
each rank owns a disjoint slice of the final reduced gradients
(`repro_torch.dist.collectives.ring_all_reduce_rs_ag`).

For each leaf the largest dim divisible by the DP extent is sharded (leaves
with no such dim stay replicated — they are tiny). This module is the shape
logic; laying the state out over ranks by these specs
(``constrain_zero1``) is ROADMAP item 11b.
"""
from __future__ import annotations

import math

from repro_torch.dist.sharding import P, ShardingRules, dp_axes


def zero1_spec(shape, param_spec: P, mesh) -> P:
    """Extend a param spec with DP sharding on the best free dim."""
    dp = dp_axes(mesh)
    if not dp:
        return param_spec
    n = math.prod(mesh.shape[a] for a in dp)
    parts = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = {a for p in parts if p is not None
            for a in ((p,) if isinstance(p, str) else p)}
    if used & set(dp):
        return P(*parts)        # FSDP already shards over the dp axes
    best, best_size = -1, 0
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is not None:
            continue
        if dim % n == 0 and dim > best_size:
            best, best_size = i, dim
    if best >= 0:
        parts[best] = dp if len(dp) > 1 else dp[0]
    return P(*parts)


def zero1_shardings(specs: dict, rules: ShardingRules) -> dict:
    """ZeRO-1 spec of every leaf of a ``{name: ParamSpec}`` dict: the
    leaf's param spec under ``rules``, extended over the dp axes."""
    return {name: zero1_spec(ps.shape,
                             rules.spec(*ps.logical, dims=ps.shape),
                             rules.mesh)
            for name, ps in specs.items()}
