"""Checksummed flush records: the durability wire format, the port of
``repro.durability.record`` (the same bytes).

A `FlushRecord` is one shadow node's contribution to one flush *epoch*:
a ``base`` (every owned bucket's full flat state), a ``delta`` (only the
buckets dirtied since the previous flush), or a ``mark`` (the node had
nothing dirty — still written, so the epoch is provably complete without
a coordinator journal). Payloads are the bucket wire format
(`repro_torch.core.buckets` flats) verbatim, as host tensors; a
compressed delta carries per-slot int8 payloads + f32 scales from the
stateless codec in `repro_torch.dist.compression`.

Serialization: a fixed magic, a u32 header length, a JSON header
(epoch/node/step/kind, an array table, the payload length and CRC32),
then each array's bytes in (bucket, field) order. `write_to` and
`read_from` stream it: the writer runs the CRC over the arrays in place
and writes each from its own buffer, the reader reads each array into a
fresh buffer and checks the CRC before returning, so no whole record is
ever held twice in memory. ANY truncation — mid-magic, mid-header,
mid-payload — and any bit flip in the payload raises `TornRecordError`; a
torn record is skipped, never half-applied.
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from dataclasses import dataclass, field

import torch

from repro_torch.core.buckets import ITEMSIZE, TORCH_DTYPES, dtype_name

MAGIC = b"RDUR1\n"
# payload field names: raw records carry p/m/v flats; compressed deltas
# carry int8 p/m/v plus per-slot scale vectors ps/ms/vs
RAW_FIELDS = ("p", "m", "v")
KINDS = ("base", "delta", "mark")
CHUNK = 256 << 20        # bytes per write, read and CRC call


class TornRecordError(RuntimeError):
    """A flush record failed structural or checksum validation.

    Raised for any truncation (torn write at an arbitrary byte) or
    payload corruption. Restore treats this as "the record does not
    exist" and falls back — a torn delta must never be half-applied.
    """


def _bytes_of(t: torch.Tensor) -> memoryview:
    """The tensor's bytes (a host tensor, any dtype) without a copy."""
    return memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def _chunks(mv: memoryview):
    for i in range(0, len(mv), CHUNK):
        yield mv[i:i + CHUNK]


@dataclass(frozen=True)
class FlushRecord:
    """One node's flush for one epoch, in bucket wire layout."""

    epoch: int
    node: int
    step: int
    kind: str                       # "base" | "delta" | "mark"
    compressed: bool = False
    # bucket_id -> {field name -> host tensor}
    payload: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown record kind {self.kind!r}")

    @property
    def payload_nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for fields in self.payload.values()
                   for t in fields.values())

    def write_to(self, f) -> int:
        """Write MAGIC + u32 header length + JSON header + each array's
        bytes to the binary file ``f``; returns the bytes written."""
        views, arrays, off = [], [], 0
        for bid in sorted(self.payload):
            fields = self.payload[bid]
            for name in sorted(fields):
                t = fields[name]
                mv = _bytes_of(t)
                arrays.append({"bucket": int(bid), "field": name,
                               "dtype": dtype_name(t.dtype),
                               "shape": list(t.shape),
                               "offset": off, "nbytes": len(mv)})
                views.append(mv)
                off += len(mv)
        crc = 0
        for mv in views:
            for c in _chunks(mv):
                crc = zlib.crc32(c, crc)
        header = {"epoch": int(self.epoch), "node": int(self.node),
                  "step": int(self.step), "kind": self.kind,
                  "compressed": bool(self.compressed),
                  "payload_nbytes": off,
                  "payload_crc32": crc & 0xFFFFFFFF,
                  "arrays": arrays}
        hb = json.dumps(header, sort_keys=True).encode()
        f.write(MAGIC + struct.pack("<I", len(hb)) + hb)
        for mv in views:
            for c in _chunks(mv):
                f.write(c)
        return len(MAGIC) + 4 + len(hb) + off

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.write_to(buf)
        return buf.getvalue()

    @classmethod
    def read_from(cls, f) -> "FlushRecord":
        """Read, validate and parse one record from the start of the
        binary file ``f`` to its end; raises `TornRecordError` at ANY cut
        point or payload corruption."""
        head = f.read(len(MAGIC) + 4)
        if len(head) < len(MAGIC) + 4:
            raise TornRecordError(
                f"record truncated before header ({len(head)} bytes)")
        if head[:len(MAGIC)] != MAGIC:
            raise TornRecordError("bad record magic")
        (hlen,) = struct.unpack_from("<I", head, len(MAGIC))
        hb = f.read(hlen)
        if len(hb) < hlen:
            raise TornRecordError("record truncated inside header")
        try:
            header = json.loads(hb)
            want = int(header.get("payload_nbytes", -1))
            table = [(int(a["offset"]), int(a["nbytes"]), int(a["bucket"]),
                      str(a["field"]), TORCH_DTYPES[a["dtype"]],
                      tuple(int(d) for d in a["shape"]))
                     for a in header["arrays"]]
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            raise TornRecordError(f"unparseable record header: {e}") from e
        here = f.tell()
        have = f.seek(0, os.SEEK_END) - here
        f.seek(here)
        if have != want:
            raise TornRecordError(
                f"record truncated inside payload ({have} of {want} bytes)")
        out: dict = {}
        crc, pos = 0, 0
        for off, nbytes, bid, name, dt, shape in sorted(table):
            n = 1
            for d in shape:
                n *= d
            if off != pos or nbytes != n * ITEMSIZE[dtype_name(dt)] \
                    or pos + nbytes > want:
                raise TornRecordError("record array table is inconsistent")
            buf = torch.empty(nbytes, dtype=torch.uint8)
            mv = memoryview(buf.numpy())
            for c in _chunks(mv):
                if f.readinto(c) != len(c):
                    raise TornRecordError("record truncated inside payload")
                crc = zlib.crc32(c, crc)
            out.setdefault(bid, {})[name] = buf.view(dt).reshape(shape)
            pos += nbytes
        if pos != want:
            raise TornRecordError("record array table is inconsistent")
        if (crc & 0xFFFFFFFF) != header.get("payload_crc32"):
            raise TornRecordError("record payload checksum mismatch")
        try:
            return cls(epoch=int(header["epoch"]), node=int(header["node"]),
                       step=int(header["step"]), kind=header["kind"],
                       compressed=bool(header["compressed"]), payload=out)
        except (ValueError, KeyError, TypeError) as e:
            raise TornRecordError(f"unparseable record header: {e}") from e

    @classmethod
    def from_bytes(cls, buf: bytes) -> "FlushRecord":
        return cls.read_from(io.BytesIO(buf))
