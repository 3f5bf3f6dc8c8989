"""GPipe pipeline parallelism over a ("stage", "data") mesh, the port of
``repro.dist.pipeline``.

``pipeline_apply`` runs the classic fill/steady/drain schedule: each rank
of the "stage" axis applies its stage's weights, and microbatch
activations move stage to stage, point to point. With M microbatches and
S stages the schedule takes M + S - 1 ticks, so utilization is
M / (M + S - 1) — ``gpipe_utilization`` is that closed form (the bubble
the paper's §2.1 training-stack background assumes).

The reference computes on every stage every tick (a branch-free SPMD
program); a process per stage computes only on its M useful ticks, which
gives the same result.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import Mesh


def make_pp_mesh(n_stages: int, n_data: int, device=None) -> Mesh:
    """("stage", "data") mesh over the first n_stages * n_data ranks."""
    return Mesh.over_ranks((n_stages, n_data), ("stage", "data"),
                           device=device)


def pipeline_apply(fn, stage_weights: torch.Tensor,
                   microbatches: torch.Tensor, mesh) -> torch.Tensor:
    """Apply ``fn(stage_weight, x)`` through all stages, GPipe-scheduled.

    ``stage_weights``: (S, ...), the whole stack on every rank (the
    reference's global array); stage ``s`` applies row ``s``.
    ``microbatches``: (M, mb, ...), the same on every rank; stage 0 feeds
    microbatch ``t`` at tick ``t``, the last stage emits microbatch
    ``t - S + 1``. ``fn`` keeps its input's shape and dtype. Returns the
    (M, mb, ...) outputs on every rank (equal to applying the stages
    sequentially).
    """
    S = mesh.shape["stage"]
    M = microbatches.shape[0]
    group = mesh.group("stage")
    stage = dist.get_rank(group) if group is not None else 0
    w = stage_weights[stage]
    outs = torch.zeros_like(microbatches)
    sends = []
    for t in range(M + S - 1):
        m = t - stage                     # the microbatch of this tick
        if not 0 <= m < M:
            continue                      # fill or drain: idle this tick
        if stage == 0:
            inp = microbatches[m]
        else:                             # what stage - 1 made last tick
            inp = torch.empty_like(microbatches[0])
            dist.recv(inp, dist.get_global_rank(group, stage - 1), group)
        out = fn(w, inp)
        if stage < S - 1:
            out = out.contiguous()
            sends.append((out, dist.isend(
                out, dist.get_global_rank(group, stage + 1), group)))
        else:
            outs[m] = out
    for _, req in sends:
        req.wait()
    if S > 1:
        # only the last stage's outputs are the results: sum over stages
        dist.all_reduce(outs, group=group)
    return outs


def gpipe_utilization(n_micro: int, n_stages: int) -> float:
    """Fraction of stage-ticks doing useful work: M / (M + S - 1)."""
    return n_micro / (n_micro + n_stages - 1)
