"""Run a test's worker on several gloo ranks on the CPU.

Each rank is a process (``torch.multiprocessing``, ``spawn``) that joins
one gloo process group through a file store under the test's own directory
(no port to collide on under xdist), with one thread. A rank that raises
fails the test with its traceback, and so does a run past the join
deadline. The worker is named by module and function, so spawn imports it
by name: keep JAX out of that module.
"""
import importlib
import os
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 120


def _entry(rank, module, worker, store, world, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        getattr(importlib.import_module(module), worker)(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(module: str, worker: str, world: int, tmp_path, *args,
          timeout: float = JOIN_TIMEOUT_S):
    """Run ``module.worker(rank, *args)`` on ``world`` gloo ranks."""
    ctx = mp.start_processes(
        _entry, args=(module, worker, os.path.join(str(tmp_path), "store"),
                      world, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{worker} did not end within {timeout} s")
    assert all(p.exitcode == 0 for p in ctx.processes)
