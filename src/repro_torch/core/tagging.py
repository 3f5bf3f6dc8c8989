"""Heartbeat-based gradient tagging for Ring AllGather (paper §4.1, Fig 4),
the port's copy of ``repro.core.tagging``.

Ring AllGather over n ranks: after ReduceScatter, rank ``r`` holds reduced
chunk ``(r + 1) % n``; in round ``t`` (of n-1 rounds) it sends chunk
``(r + 1 - t) % n`` to rank ``(r + 1) % n``.

The heartbeat rule tags on the *boundary ranks only*:
  * rank 0 tags only in round 0,
  * rank n-1 tags in every round.

This yields exactly-once coverage of all n chunks (property-tested), with at
most two concurrent taggers per round (round 0), which is why the paper gives
each shadow node two NICs.

Sequence numbers: the network layer keeps one counter per channel,
incremented only for tagged chunks and carried in a custom TCP option; the
switch rewrites the stream's TCP sequence so the shadow node sees one
continuous stream per channel (§4.1.2). ``tag_schedule`` emits those
per-channel sequence numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator


def chunk_at(rank: int, rnd: int, n: int) -> int:
    """Chunk held/sent by ``rank`` in AllGather round ``rnd`` (0-based)."""
    return (rank + 1 - rnd) % n


def is_tagged(rank: int, rnd: int, n: int) -> bool:
    if n == 1:
        return rnd == 0
    return (rank == 0 and rnd == 0) or rank == n - 1


def tagged_chunks_per_rank(n: int) -> dict[int, list[int]]:
    """rank -> chunks it tags, in round order."""
    out: dict[int, list[int]] = {}
    rounds = max(n - 1, 1)
    for rnd in range(rounds):
        for rank in range(n):
            if is_tagged(rank, rnd, n):
                out.setdefault(rank, []).append(chunk_at(rank, rnd, n))
    return out


@dataclass(frozen=True)
class TagEvent:
    """One tagged chunk transmission observed by the switch."""
    round: int
    src_rank: int
    chunk: int
    channel: int
    seq: int          # per-channel shadow-stream sequence number
    shadow_node: int  # destination shadow node id (optimizer scale-out)


def tag_schedule(n_ranks: int, n_channels: int = 1,
                 n_shadow_nodes: int = 1,
                 chunk_to_node=None) -> list[TagEvent]:
    """Full per-iteration tag schedule across channels.

    ``chunk_to_node``: optional fn(channel, chunk) -> shadow node id; default
    round-robins chunks over shadow nodes (the paper encodes the node id in
    the packet for the switch, §4.2.4).
    """
    if chunk_to_node is None:
        def chunk_to_node(ch, c):
            return (ch * n_ranks + c) % n_shadow_nodes
    events = []
    seq = [0] * n_channels
    rounds = max(n_ranks - 1, 1)
    for rnd in range(rounds):
        for rank in range(n_ranks):
            if not is_tagged(rank, rnd, n_ranks):
                continue
            for ch in range(n_channels):
                c = chunk_at(rank, rnd, n_ranks)
                events.append(TagEvent(round=rnd, src_rank=rank, chunk=c,
                                       channel=ch, seq=seq[ch],
                                       shadow_node=chunk_to_node(ch, c)))
                seq[ch] += 1
    return events


def fabric_tag_schedule(n_dp_groups: int, ranks_per_group: int,
                        n_channels: int = 1,
                        n_shadow_nodes: int = 1) -> dict[int, list[TagEvent]]:
    """Per-DP-group tag schedules for a shared fabric (§4.4).

    Every DP group runs its own ring AllGather concurrently; each group has
    its own pair of tagging (boundary) ranks and its own per-channel
    shadow-stream sequence space.  ``TagEvent.src_rank`` stays *group-local*
    (0..ranks_per_group-1): callers translate to global ranks via
    ``dp * ranks_per_group + src_rank``.

    Chunks are spread over shadow nodes with a per-group offset so that
    multiple groups do not all hammer shadow node 0 first.

    Returns ``{dp_group: [TagEvent, ...]}``.
    """
    out: dict[int, list[TagEvent]] = {}
    for dp in range(n_dp_groups):
        def chunk_to_node(ch, c, _dp=dp):
            return (_dp + ch * ranks_per_group + c) % n_shadow_nodes
        out[dp] = tag_schedule(ranks_per_group, n_channels=n_channels,
                               n_shadow_nodes=n_shadow_nodes,
                               chunk_to_node=chunk_to_node)
    return out


def verify_exactly_once(n_ranks: int) -> bool:
    """Every chunk tagged exactly once across the schedule."""
    seen: dict[int, int] = {}
    for ev in tag_schedule(n_ranks):
        seen[ev.chunk] = seen.get(ev.chunk, 0) + 1
    return (set(seen) == set(range(n_ranks))
            and all(v == 1 for v in seen.values()))


def incast_per_round(n_ranks: int) -> dict[int, int]:
    """round -> number of simultaneous taggers (shadow-bound flows)."""
    out: dict[int, int] = {}
    for ev in tag_schedule(n_ranks):
        out[ev.round] = out.get(ev.round, 0) + 1
    return out
