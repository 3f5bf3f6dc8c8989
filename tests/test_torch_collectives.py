"""The port's explicit collectives on four gloo ranks on the CPU.

Each test spawns four processes that join one gloo process group through a
file store under the test's own directory (no port to collide on under
xdist) and run the collective; a failed check in any rank fails the test
with that rank's traceback. The reference's own runs of these schedules
(tests/test_multidevice.py) cannot run on the installed jax, so the port
is held against the closed forms they state:

* ring RS+AG: the full result is, chunk by chunk, the fold
  ``acc = x[c+1][c]``, then ``acc = x[c+m][c] + acc`` for m = 2..n — bit
  for bit — and the ranks' owned chunks, gathered and trimmed, are the
  full result (exactly-once coverage); a replicated ``arange(32)`` gives
  ``4 x``; a second call gives the same bits;
* GPipe at S = 4, M = 6: the sequential ``tanh(x @ w)`` stages to rtol
  1e-5 / atol 1e-6, and utilization M / (M + S - 1) = 6/9.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.costmodel import ElasticMeshBudget, plan_elastic_mesh
from repro_torch.core.elastic import rules_from_plan
from repro_torch.dist.collectives import ring_all_reduce_rs_ag
from repro_torch.dist.pipeline import (gpipe_utilization, make_pp_mesh,
                                       pipeline_apply)
from repro_torch.dist.sharding import Mesh, make_smoke_mesh

WORLD = 4
JOIN_TIMEOUT_S = 120


def _entry(rank, worker, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        globals()[worker](rank, *args)
    finally:
        dist.destroy_process_group()


def _spawn(worker, tmp_path, *args):
    """Run ``worker(rank, *args)`` on WORLD gloo ranks; a rank that raises
    fails the test, and so does a run past JOIN_TIMEOUT_S."""
    ctx = mp.start_processes(
        _entry, args=(worker, os.path.join(tmp_path, "store"), args),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{worker} did not end within {JOIN_TIMEOUT_S} s")
    assert all(p.exitcode == 0 for p in ctx.processes)


def _inputs(size, seed):
    """Distinct f32 inputs, one per global rank, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(size).astype(np.float32))
            for _ in range(WORLD)]


def _fold(xs):
    """The ring's per-chunk accumulation order, written out: chunk c is
    ``x[c+1][c]``, then ``x[c+m][c] + acc`` for m = 2..n (mod n)."""
    n = len(xs)
    pad = (-xs[0].numel()) % n
    ch = [torch.cat([x, x.new_zeros(pad)]).reshape(n, -1) for x in xs]
    out = []
    for c in range(n):
        acc = ch[(c + 1) % n][c].clone()
        for m in range(2, n + 1):
            acc = ch[(c + m) % n][c] + acc
        out.append(acc)
    return torch.cat(out)[:xs[0].numel()]


def _check_ring(mesh, axis, x, xs_of_group):
    """One rank's checks of the ring over ``axis`` on its input ``x``."""
    group = mesh.group(axis)
    n = mesh.shape[axis]
    full, owned = ring_all_reduce_rs_ag(x, mesh, axis)
    assert full.shape == x.shape and full.dtype == x.dtype
    assert torch.equal(full, _fold(xs_of_group))
    assert owned.numel() == -(-x.numel() // n)
    chunks = [torch.empty_like(owned) for _ in range(n)]
    dist.all_gather(chunks, owned, group=group)
    assert torch.equal(torch.cat(chunks)[:x.numel()], full)
    again, owned2 = ring_all_reduce_rs_ag(x, mesh, axis)
    assert torch.equal(again, full) and torch.equal(owned2, owned)


def _ring_data(rank):
    mesh = Mesh.over_ranks((WORLD,), ("data",), device="cpu")
    assert dist.get_rank(mesh.group("data")) == rank
    for size, seed in ((32, 0), (37, 1)):      # 37: zero padding, trim
        xs = _inputs(size, seed)
        _check_ring(mesh, "data", xs[rank], xs)
    x = torch.arange(32, dtype=torch.float32)  # replicated: sum = 4x
    full, _ = ring_all_reduce_rs_ag(x, mesh, "data")
    assert torch.equal(full, 4 * x)
    y = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        (3, 5)).astype(np.float32))          # a 2-D leaf keeps its shape
    assert ring_all_reduce_rs_ag(y, mesh, "data")[0].shape == (3, 5)


def _ring_planned(rank):
    plan = plan_elastic_mesh(WORLD, ElasticMeshBudget(model_parallel=2))
    assert plan.mesh_shape == (2, 2) and plan.axis_names[:2] == \
        ("data", "model")
    mesh = rules_from_plan(plan, device="cpu").mesh
    group = mesh.group("data")
    members = [dist.get_global_rank(group, j) for j in range(2)]
    assert members == [rank % 2, rank % 2 + 2]   # a column of [[0,1],[2,3]]
    xs = _inputs(37, 2)
    _check_ring(mesh, "data", xs[rank], [xs[r] for r in members])


def _gpipe(rank):
    S, M, mb, d = 4, 6, 2, 8
    mesh = make_pp_mesh(n_stages=S, n_data=1, device="cpu")
    rng = np.random.default_rng(0)
    ws = torch.from_numpy(
        (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((M, mb, d)).astype(np.float32))
    out = pipeline_apply(lambda w, x: torch.tanh(x @ w), ws, xs, mesh)
    ref = xs
    for i in range(S):
        ref = torch.tanh(ref @ ws[i])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_ring_rs_ag_on_four_ranks(tmp_path):
    _spawn("_ring_data", tmp_path)


def test_ring_rs_ag_on_the_data_axis_of_a_planned_mesh(tmp_path):
    _spawn("_ring_planned", tmp_path)


def test_gpipe_on_four_stages(tmp_path):
    _spawn("_gpipe", tmp_path)


def test_one_rank_paths_need_no_process_group():
    """The n = 1 schedules (the one the card runs): the ring hands back
    its input twice, and a one-stage pipeline applies its one stage."""
    mesh = make_smoke_mesh("cpu")
    x = torch.arange(6.0).reshape(2, 3)
    full, owned = ring_all_reduce_rs_ag(x, mesh, "data")
    assert full is x and owned is x
    pp = make_pp_mesh(1, 1, device="cpu")
    assert pp.shape == {"stage": 1, "data": 1} and pp.group("stage") is None
    w = torch.eye(3).mul(0.5)[None]
    xs = torch.arange(12.0).reshape(2, 2, 3)
    assert torch.equal(pipeline_apply(lambda w, x: x @ w, w, xs, pp),
                       xs @ w[0])
    assert not dist.is_initialized()


def test_gpipe_utilization_closed_form():
    assert abs(gpipe_utilization(6, 4) - 6 / 9) < 1e-9
    assert gpipe_utilization(8, 1) == 1.0
