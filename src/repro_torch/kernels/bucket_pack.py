"""Bucket pack wrapper: the CUDA gather kernel for tensors on the card, the
plain version (`ref.bucket_pack_ref`) for tensors on the CPU.

One launch writes every leaf of a bucket into the bucket's flat buffer at
its element offset (`repro_torch.core.buckets.LeafSlot.offset`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bucket_pack_ref

launches = build.LaunchCounter()


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
    item = out.element_size()
    rows = [(leaf.data_ptr(), off * item, leaf.numel() * item)
            for leaf, off in zip(leaves, offsets) if leaf.numel()]
    if not rows:
        return out
    # pinned, so the copy is asynchronous; PyTorch's pinned-memory cache
    # keeps the host block until the copy has run
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        out.device, non_blocking=True)
    lib = build.load()
    code = lib.repro_bucket_pack(table.data_ptr(), len(rows), out.data_ptr(),
                                 max(r[2] for r in rows),
                                 build.stream_ptr(out.device))
    build.check(code, "bucket_pack")
    # ``table`` was allocated on this stream, so the caching allocator
    # reuses its memory only after the launch has read it
    launches.add()
    return out
