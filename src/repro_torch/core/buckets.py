"""DDP-style gradient bucketing (paper §4.2.2), the port's copy of
``repro.core.buckets``.

Gradients are bin-packed into fixed-size buckets from the LAST leaf
backwards; a leaf larger than the cap gets a bucket of its own, and dtypes
never mix in one bucket. The shadow keeps the same mapping, so each leaf is
an offset inside a received bucket. Dtype names map to sizes through the
port's own table (numpy has no ``bfloat16``).
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Iterable

import torch

from repro_torch.kernels import ops

DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024       # PyTorch DDP default

TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float64": torch.float64,
    "int32": torch.int32, "int64": torch.int64,
    "int8": torch.int8, "uint8": torch.uint8,
}
ITEMSIZE = {name: torch.empty((), dtype=dt).element_size()
            for name, dt in TORCH_DTYPES.items()}


def dtype_name(dtype) -> str:
    """'float32' for torch.float32, numpy float32 or the string itself."""
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


@dataclass(frozen=True)
class LeafSlot:
    name: str
    offset: int          # element offset inside the bucket
    size: int            # element count
    shape: tuple
    dtype: str


@dataclass(frozen=True)
class Bucket:
    bucket_id: int
    slots: tuple[LeafSlot, ...]
    size: int            # total element count

    @property
    def nbytes(self) -> int:
        return sum(s.size * ITEMSIZE[s.dtype] for s in self.slots)


@dataclass(frozen=True)
class BucketLayout:
    buckets: tuple[Bucket, ...]

    @property
    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)


def build_buckets(named_leaves: Iterable[tuple[str, tuple, str]],
                  cap_bytes: int = DEFAULT_BUCKET_BYTES,
                  reverse: bool = True) -> BucketLayout:
    """named_leaves: (name, shape, dtype name) in model order."""
    leaves = list(named_leaves)
    if reverse:
        leaves = leaves[::-1]
    buckets: list[Bucket] = []
    cur: list[LeafSlot] = []
    cur_elems = 0
    cur_bytes = 0
    cur_dtype: str | None = None

    def flush():
        nonlocal cur, cur_elems, cur_bytes, cur_dtype
        if cur:
            buckets.append(Bucket(len(buckets), tuple(cur), cur_elems))
            cur, cur_elems, cur_bytes, cur_dtype = [], 0, 0, None

    for name, shape, dtype in leaves:
        size = 1
        for d in shape:
            size *= int(d)
        nbytes = size * ITEMSIZE[dtype]
        if nbytes >= cap_bytes:                  # dedicated bucket
            flush()
            buckets.append(Bucket(
                len(buckets),
                (LeafSlot(name, 0, size, tuple(shape), dtype),), size))
            continue
        if cur_bytes + nbytes > cap_bytes or (cur_dtype is not None
                                              and dtype != cur_dtype):
            flush()
        cur.append(LeafSlot(name, cur_elems, size, tuple(shape), dtype))
        cur_elems += size
        cur_bytes += nbytes
        cur_dtype = dtype
    flush()
    return BucketLayout(tuple(buckets))


def layout_for_tree(tree: Mapping, cap_bytes: int = DEFAULT_BUCKET_BYTES
                    ) -> BucketLayout:
    return build_buckets(
        [(k, tuple(v.shape), dtype_name(v.dtype)) for k, v in tree.items()],
        cap_bytes=cap_bytes)


def bucket_dtype(bucket: Bucket) -> str:
    """The dtype name of the bucket's flat buffer (never mixed)."""
    dtypes = {s.dtype for s in bucket.slots}
    if len(dtypes) != 1:
        raise ValueError(f"bucket {bucket.bucket_id} mixes dtypes "
                         f"{sorted(dtypes)}")
    return next(iter(dtypes))


def alloc_flat(size: int, dtype, device="cpu",
               pin: bool = False) -> torch.Tensor:
    """A flat bucket buffer. ``pin=True`` gives page-locked host memory, the
    source and target of asynchronous copies to and from the card."""
    dt = TORCH_DTYPES[dtype_name(dtype)] if not isinstance(
        dtype, torch.dtype) else dtype
    return torch.empty(size, dtype=dt, device=device, pin_memory=pin)


def pack_bucket_into(bucket: Bucket, tree: Mapping,
                     out: torch.Tensor) -> torch.Tensor:
    """Write the bucket's leaves into ``out`` with one bucket-pack launch
    (no concatenate temporary). Returns ``out``."""
    ops.pack_bucket([tree[s.name].reshape(-1) for s in bucket.slots],
                    [s.offset for s in bucket.slots], out)
    return out


def unpack_bucket(bucket: Bucket, flat) -> dict:
    """Bucket buffer -> {leaf name: view of it}."""
    return {s.name: flat[s.offset:s.offset + s.size].reshape(s.shape)
            for s in bucket.slots}


class FlatTreeView(Mapping):
    """Lazy leaf-dict view over per-bucket flat buffers: ``view[name]`` is
    a view into the bucket buffer, no element copied."""

    __slots__ = ("_layout", "_flats", "_index")

    def __init__(self, layout: BucketLayout, flats: dict):
        self._layout = layout
        self._flats = flats
        self._index = {s.name: (b.bucket_id, s) for b in layout.buckets
                       if b.bucket_id in flats for s in b.slots}

    def __getitem__(self, name: str):
        bid, s = self._index[name]
        return self._flats[bid][s.offset:s.offset + s.size].reshape(s.shape)

    def __iter__(self):
        return iter(self._index)

    def __len__(self):
        return len(self._index)
