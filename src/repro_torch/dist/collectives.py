"""Explicit ring collectives, the port of ``repro.dist.collectives``.

Checkmate's capture point exists because a ring AllReduce *is* a
ReduceScatter followed by an AllGather: after the RS phase each rank owns
a disjoint, fully-reduced chunk of the gradient — everything a checkpoint
needs already sits in the network. This module runs the ring schedule
explicitly over the mesh axis's process group, point to point
(``batch_isend_irecv``), so tests can check the exactly-once coverage on
the dataflow itself.

Both phases run the classic n-1-step ring: at RS step ``s`` rank ``i``
sends chunk ``(i - s - 1) mod n`` to rank ``i + 1`` and accumulates what
rank ``i - 1`` sent into chunk ``(i - s - 2) mod n``, ending with rank
``i`` owning fully-reduced chunk ``i``; the AG phase circulates the owned
chunks until every rank holds the full result. The accumulation order of
each chunk is a function of ring position only — chunk ``c`` is the fold
``acc = x[c+1][c]``, then ``acc = x[c+m][c] + acc`` for m = 2..n (ranks
mod n) — so the reduction is bitwise the same on every run, the property
the shadow replay relies on.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _exchange(send: torch.Tensor, recv: torch.Tensor, group, nxt: int,
              prv: int):
    """Send ``send`` to global rank ``nxt`` while receiving ``recv`` from
    global rank ``prv``; returns when both are done."""
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)]):
        req.wait()


def _ring(mesh, axis):
    """(group, n, this rank's index, next global rank, previous one)."""
    group = mesh.group_over(axis)
    n = mesh.extent(axis)
    i = dist.get_rank(group)
    return (group, n, i, dist.get_global_rank(group, (i + 1) % n),
            dist.get_global_rank(group, (i - 1) % n))


def ring_reduce_scatter_(acc: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The ring's reduce-scatter half, in place on ``acc`` (n, chunk),
    contiguous: after n-1 steps this rank's row ``i`` holds chunk ``i``
    reduced over ``axis`` (a name, or the tuple of the dp axes), by the
    fold the module docstring states. Returns that row (a view)."""
    n = mesh.extent(axis)
    if n == 1:
        return acc[0]
    group, n, i, nxt, prv = _ring(mesh, axis)
    recv = torch.empty_like(acc[0])
    for s in range(n - 1):
        _exchange(acc[(i - s - 1) % n], recv, group, nxt, prv)
        acc[(i - s - 2) % n] += recv
    return acc[i]


def ring_all_gather_(acc: torch.Tensor, mesh, axis) -> torch.Tensor:
    """The ring's all-gather half, in place on ``acc`` (n, chunk): row
    ``i`` of each rank ``i`` circulates until every rank holds every
    row. Returns ``acc``."""
    n = mesh.extent(axis)
    if n == 1:
        return acc
    group, n, i, nxt, prv = _ring(mesh, axis)
    recv = torch.empty_like(acc[0])
    for s in range(n - 1):
        _exchange(acc[(i - s) % n], recv, group, nxt, prv)
        acc[(i - s - 1) % n] = recv
    return acc


def ring_all_reduce_rs_ag(x: torch.Tensor, mesh, axis):
    """Ring AllReduce over ``axis`` decomposed as ReduceScatter ->
    AllGather (`ring_reduce_scatter_`, then `ring_all_gather_`).

    Each rank contributes its local ``x`` (a replicated input gives
    ``n * x``). Returns ``(all_reduced, owned)``:

    * ``all_reduced`` — the full reduction, of ``x``'s shape, on every
      rank (the AG output);
    * ``owned`` — this rank's chunk ``i`` of the zero-padded flat, as the
      RS phase left it. Concatenating the ranks' ``owned`` chunks and
      trimming the padding IS the AllReduce result — the exactly-once
      gradient coverage Checkmate captures. (The reference returns the
      chunks as one global array sharded over ``axis``; a process per
      rank holds its own chunk.)
    """
    n = mesh.extent(axis)
    if n == 1:
        return x, x
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    acc = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat.clone()
    acc = acc.reshape(n, -1)
    owned = ring_reduce_scatter_(acc, mesh, axis).clone()
    ring_all_gather_(acc, mesh, axis)
    return acc.reshape(-1)[:flat.numel()].reshape(x.shape), owned
