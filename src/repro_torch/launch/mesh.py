"""Production meshes, the port of ``repro.launch.mesh``, and the fake world
the dry run builds them in.

A production mesh is a named mesh over the ranks of the default process
group: single pod (data=16, model=16), 256 ranks; multi-pod (pod=2,
data=16, model=16), 512. A real run gets them from ``torchrun`` with one
process per card; the dry run (`repro_torch.launch.dryrun`) gets them
from `fake_world`, one process that plays rank 0 of a world whose other
ranks do not exist.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import Mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def world_size(multi_pod: bool = False) -> int:
    """The ranks a production mesh spans: 256, or 512 with ``multi_pod``."""
    return math.prod((MULTI_POD if multi_pod else SINGLE_POD)[0])


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Single pod: (data=16, model=16) over 256 ranks; multi-pod: (pod=2,
    data=16, model=16) over 512. Collective over the default process
    group, which must hold exactly that many ranks (``ValueError``
    otherwise, naming the count). ``device`` is the mesh's placement (the
    card unless the caller asks for the CPU, as `Mesh` resolves it)."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    need = world_size(multi_pod)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world != need:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod production mesh "
            f"{dict(zip(axes, shape))} needs a world of {need} ranks (one "
            f"process per rank, e.g. torchrun --nproc-per-node ... with "
            f"{need} in all), not {world}")
    return Mesh.over_ranks(shape, axes, device=device)


def join_world(device: torch.device):
    """Join the default process group a launcher describes (``torchrun``
    sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the rendezvous
    address): NCCL for the card, each process on its ``LOCAL_RANK``'s
    card; gloo for the CPU. Does nothing where a group is up or no
    launcher set a world of more than one rank."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks in which this
    process is rank 0 and no other rank exists: every collective returns
    at once without moving data, so a step can be traced for one rank of a
    production mesh on a host with no card.

    The ``fake`` c10d backend is registered by importing
    ``torch.testing._internal.distributed.fake_pg``; without that import
    ``init_process_group`` raises ``Unknown c10d backend type FAKE``. The
    backend string maps ``cpu``, ``meta`` and ``cuda`` tensors to it: with
    the ``cpu`` entry alone, a collective on a meta tensor works but a
    point-to-point send or receive (the ring's ``batch_isend_irecv``)
    raises ``No backend type associated with device type meta``; the
    ``cuda`` entry lets one rank's local step run on a card, its
    collectives moving nothing (a yardstick of the time and memory a
    rank's own work takes). The group is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already up")
    dist.init_process_group("cpu:fake,meta:fake,cuda:fake",
                            store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
