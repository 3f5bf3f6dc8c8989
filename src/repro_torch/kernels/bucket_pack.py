"""Bucket pack wrapper: the CUDA gather kernel for tensors on the card, the
plain version (`ref.bucket_pack_ref`) for tensors on the CPU.

One launch writes up to 128 leaves of a bucket into the bucket's flat
buffer at their element offsets (`repro_torch.core.buckets.LeafSlot.offset`);
:func:`launch_plan` cuts a bucket into such launches. The leaf table goes to
the kernel by value, so a launch copies nothing from host to device first.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.kernels import build
from repro_torch.kernels.ref import bucket_pack_ref

launches = build.LaunchCounter()
CHUNK = 16                  # bytes; the kernel's grid is over these
CHUNKS_PER_BLOCK = 512      # kChunksPerBlock in csrc/bucket_pack.cu
MAX_CHUNKS = 2 ** 31        # per launch, so chunk indices fit the kernel's


class LaunchPlan(NamedTuple):
    """One launch: ``rows[i] = (source address, destination byte offset,
    byte count)`` of leaf ``leaves[i]``; ``first[i]`` counts the 16-byte
    chunks of rows 0..i-1 (the last chunk of a row may be partial)."""
    leaves: list[int]
    rows: list[tuple[int, int, int]]
    first: list[int]

    def blocks(self) -> int:
        return -(-self.first[-1] // CHUNKS_PER_BLOCK)


def launch_plan(leaves, offsets, item: int) -> list[LaunchPlan]:
    """The launches that pack ``leaves`` (flat tensors, ``item`` bytes an
    element) at element ``offsets``: at most ``build.MAX_PACK_LEAVES`` rows
    and ``MAX_CHUNKS`` chunks each, empty leaves dropped."""
    plans: list[LaunchPlan] = []
    cur = LaunchPlan([], [], [0])
    for i, (leaf, off) in enumerate(zip(leaves, offsets)):
        nbytes = leaf.numel() * item
        if not nbytes:
            continue
        chunks = -(-nbytes // CHUNK)
        if chunks > MAX_CHUNKS:
            raise ValueError(f"bucket_pack: a leaf of {nbytes} bytes is "
                             f"larger than one launch takes")
        if cur.rows and (len(cur.rows) == build.MAX_PACK_LEAVES
                         or cur.first[-1] + chunks > MAX_CHUNKS):
            plans.append(cur)
            cur = LaunchPlan([], [], [0])
        cur.leaves.append(i)
        cur.rows.append((leaf.data_ptr(), off * item, nbytes))
        cur.first.append(cur.first[-1] + chunks)
    if cur.rows:
        plans.append(cur)
    return plans


def table(plan: LaunchPlan) -> build.PackTable:
    """``plan`` as the kernel's by-value parameter."""
    t = build.PackTable()
    n = len(plan.rows)
    t.src[:n] = [r[0] for r in plan.rows]
    t.dst[:n] = [r[1] for r in plan.rows]
    t.nbytes[:n] = [r[2] for r in plan.rows]
    t.first[:n + 1] = plan.first
    t.n = n
    return t


def launch(t: build.PackTable, out):
    """One kernel launch of a prepared table into ``out`` on the card."""
    code = build.load().repro_bucket_pack(t, out.data_ptr(),
                                          build.stream_ptr(out.device))
    build.check(code, "bucket_pack")
    launches.add()


def pack(leaves, offsets, out):
    """Write ``leaves[i].reshape(-1)`` into ``out[offsets[i]:...]``."""
    if len(leaves) != len(offsets):
        raise ValueError("bucket_pack: one offset per leaf")
    if out.dim() != 1 or not out.is_contiguous():
        raise ValueError("bucket_pack: out must be a contiguous flat tensor")
    for leaf, off in zip(leaves, offsets):
        if leaf.dtype != out.dtype:
            raise TypeError(f"bucket_pack: leaf {leaf.dtype} into "
                            f"{out.dtype} bucket")
        if leaf.device != out.device:
            raise ValueError(f"bucket_pack: leaf on {leaf.device}, bucket "
                             f"on {out.device}")
        if not leaf.is_contiguous():
            raise ValueError("bucket_pack: leaf is not contiguous")
        if off < 0 or off + leaf.numel() > out.numel():
            raise ValueError(f"bucket_pack: leaf of {leaf.numel()} at "
                             f"{off} overruns a bucket of {out.numel()}")
    if out.device.type == "cpu":
        return bucket_pack_ref(leaves, offsets, out)
    if out.device.type != "cuda":
        raise ValueError(f"bucket_pack: unsupported device {out.device}")
    for plan in launch_plan(leaves, offsets, out.element_size()):
        launch(table(plan), out)
    return out
