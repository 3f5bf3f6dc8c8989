"""ZeRO-1 optimizer-state specs over the data axes, the port of
``repro.optim.sharded``.

The gradient all-reduce decomposes into reduce-scatter -> sharded update ->
param all-gather. The reduce-scatter *output* is Checkmate's capture point:
each rank owns a disjoint slice of the final reduced gradients
(`repro_torch.dist.collectives.ring_all_reduce_rs_ag`).

For each leaf the largest dim divisible by the DP extent is sharded (leaves
with no such dim stay replicated — they are tiny). ``constrain_zero1``
cuts a tree of full tensors to this rank's ZeRO-1 slices and
``gather_zero1`` is the way back; `StateSharding` holds, per leaf, where a
trainer's params and its mu, nu and reduced gradient live over the ranks.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import (P, NamedSharding, ShardingRules,
                                       dp_axes, dp_size)


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


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` (a slice never aliases the full tensor)."""
    return t.clone(memory_format=torch.contiguous_format)


def constrain_zero1(tree: dict, specs: dict, rules: ShardingRules,
                    model: bool = True) -> dict:
    """Each full leaf of ``tree`` cut to this rank's ZeRO-1 slice, as its
    own contiguous copy (the reference's constraint to the ZeRO-1 layout,
    the RS point). ``specs`` are the leaves' ParamSpecs; ``model`` is
    `StateSharding`'s."""
    z = StateSharding(specs, rules, model=model).state
    return {k: _own(z[k].local(x)) for k, x in tree.items()}


def gather_zero1(tree: dict, specs: dict, rules: ShardingRules,
                 model: bool = True) -> dict:
    """The way back from `constrain_zero1`: every full leaf, on every rank
    (collective over the ranks that cut each leaf: its dp ranks, and its
    model ranks where ``model``)."""
    z = StateSharding(specs, rules, model=model).state
    return {k: z[k].gather(x) for k, x in tree.items()}


class StateSharding:
    """Where each leaf of a trainer state lives on ``rules``' mesh.

    ``params[k]`` is the leaf's param sharding (its logical spec: cut over
    ``model`` where ``model`` is set, the layout of a tensor-parallel
    family, else whole over it, and over the dp axes only for an FSDP
    ``wemb`` dim),
    ``state[k]`` that of its mu, nu and reduced gradient: the ZeRO-1 spec
    where ``zero1`` (the reference's ``cfg.zero1``), else the param spec,
    so a ZeRO-1 leaf of a tensor-parallel family is cut over both.
    ``specs`` are the leaves' ParamSpecs, in the tree's order.
    """

    def __init__(self, specs: dict, rules: ShardingRules,
                 zero1: bool = True, model: bool = True):
        self.mesh = rules.mesh
        self.shapes = {k: tuple(ps.shape) for k, ps in specs.items()}
        self.params = {k: rules.sharding(*ps.logical, dims=ps.shape,
                                         model=model)
                       for k, ps in specs.items()}
        self.state = ({k: NamedSharding(self.mesh, spec, model=model)
                       for k, spec in zero1_shardings(specs, rules).items()}
                      if zero1 else dict(self.params))
        self.n = dp_size(self.mesh)
        self.m = self.mesh.shape.get("model", 1) if model else 1

    def local(self, params: dict, mu: dict, nu: dict) -> tuple:
        """(params, mu, nu) of full trees cut to this rank's slices, each
        an own contiguous copy on the tree's device."""
        return ({k: _own(self.params[k].local(x)) for k, x in params.items()},
                {k: _own(self.state[k].local(x)) for k, x in mu.items()},
                {k: _own(self.state[k].local(x)) for k, x in nu.items()})

    def full(self, params: dict, mu: dict, nu: dict) -> tuple:
        """The way back: full trees on every rank (collective)."""
        return ({k: self.params[k].gather(x) for k, x in params.items()},
                {k: self.state[k].gather(x) for k, x in mu.items()},
                {k: self.state[k].gather(x) for k, x in nu.items()})
