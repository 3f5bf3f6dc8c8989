"""Pluggable persistence tiers behind the shadow plane, the port of
``repro.durability.tiers`` (the same files and manifest).

A `Tier` stores `FlushRecord` blobs and a manifest of what it holds.
Two implementations:

* `LocalDiskTier` — records AND the manifest are written tmp-file +
  ``os.replace`` (atomic on POSIX), so a crash mid-flush leaves either
  the previous manifest or the new one, never a half-written entry; a
  crash mid-record leaves a torn blob the checksum rejects on read.
  Records are streamed (`FlushRecord.write_to` / `read_from`): no whole
  record is ever serialised in memory.
* `ObjectStoreTier` — in-memory stub for a remote object store with
  injectable put latency (served on the flush worker thread, never the
  trainer's) and injectable per-step failures.

Both expose ``fail_steps``: a `put` for a record at one of those steps
raises `TierPutError` — the tests drive this to prove restore falls
back across tiers.

Retention (``retain_epochs``): with unbounded epochs a tier's footprint
grows forever, so both tiers garbage-collect on every ``put``. The
pruning rule is chain-aware, not a naive count: restore walks per-node
delta chains back to each node's most recent base, so the collector
keeps the newest ``retain_epochs`` epochs PLUS everything back to (and
including) the newest *all-base anchor* epoch at or below that window —
an epoch in which every present record is a raw base, behind which no
chain can reach. If no anchor exists below the window (e.g. the bases
are still ahead of the cutoff) nothing is pruned: the newest complete
base+delta chain is never cut, and a torn record in a retained epoch can
always fall back to the anchor.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Iterable, Protocol, runtime_checkable

from repro_torch.durability.record import FlushRecord, TornRecordError

MANIFEST = "manifest.json"


class TierPutError(RuntimeError):
    """A tier refused or failed a record write (injected or real)."""


@dataclass(frozen=True)
class ManifestEntry:
    """One durable record as the manifest advertises it."""

    epoch: int
    node: int
    step: int
    kind: str
    compressed: bool
    nbytes: int
    key: str

    @classmethod
    def for_record(cls, rec: FlushRecord, key: str, nbytes: int
                   ) -> "ManifestEntry":
        return cls(epoch=rec.epoch, node=rec.node, step=rec.step,
                   kind=rec.kind, compressed=rec.compressed,
                   nbytes=nbytes, key=key)


@runtime_checkable
class Tier(Protocol):
    name: str

    def put(self, rec: FlushRecord) -> ManifestEntry: ...
    def entries(self) -> list[ManifestEntry]: ...
    def read(self, entry: ManifestEntry) -> FlushRecord: ...


def _record_key(rec: FlushRecord) -> str:
    return f"rec_e{rec.epoch:08d}_n{rec.node:03d}.bin"


def _prune_plan(ents: list[ManifestEntry],
                retain_epochs: "int | None") -> list[ManifestEntry]:
    """Entries the retention policy says to DROP (possibly empty).

    Keeps the newest ``retain_epochs`` distinct epochs, then walks down to
    the newest epoch at or below that cutoff whose every record is a raw
    base (the anchor) and drops only epochs strictly older — per-node
    delta chains re-anchor at each base, so nothing restorable is lost.
    Returns [] when no safe anchor exists.
    """
    if retain_epochs is None:
        return []
    epochs = sorted({e.epoch for e in ents}, reverse=True)
    if len(epochs) <= retain_epochs:
        return []
    cutoff = epochs[retain_epochs - 1]
    by_epoch: dict[int, list[ManifestEntry]] = {}
    for e in ents:
        by_epoch.setdefault(e.epoch, []).append(e)
    anchor = None
    for ep in sorted(by_epoch, reverse=True):
        if ep > cutoff:
            continue
        if all(e.kind == "base" for e in by_epoch[ep]):
            anchor = ep
            break
    if anchor is None:
        return []            # no full-base anchor below the window: keep all
    return [e for e in ents if e.epoch < anchor]


class LocalDiskTier:
    """Records on local disk with atomic rename + an atomic manifest."""

    name = "local-disk"

    def __init__(self, root, retain_epochs: "int | None" = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.fail_steps: set[int] = set()
        self.retain_epochs = retain_epochs
        self.put_bytes_total = 0
        self.gc_records_total = 0
        self.gc_bytes_total = 0
        # one FlushWorker per shadow node writes here concurrently; the
        # manifest update is read-modify-write and must serialize
        self._lock = threading.Lock()

    def put(self, rec: FlushRecord) -> ManifestEntry:
        if rec.step in self.fail_steps:
            raise TierPutError(
                f"{self.name}: injected put failure at step {rec.step}")
        key = _record_key(rec)
        tmp = self.root / (key + ".tmp")
        with open(tmp, "wb") as f:
            nbytes = rec.write_to(f)
        os.replace(tmp, self.root / key)        # atomic: blob visible whole
        entry = ManifestEntry.for_record(rec, key, nbytes)
        with self._lock:
            ents = self.entries()
            ents.append(entry)
            drop = _prune_plan(ents, self.retain_epochs)
            if drop:
                gone = {d.key for d in drop}
                ents = [e for e in ents if e.key not in gone]
            mtmp = self.root / (MANIFEST + ".tmp")
            mtmp.write_text(json.dumps(
                {"entries": [asdict(e) for e in ents]}, sort_keys=True))
            os.replace(mtmp, self.root / MANIFEST)  # atomic: old or new
            # blobs are unlinked only AFTER the manifest stopped naming
            # them — a crash between the two leaves orphans, never a
            # manifest entry pointing at a missing blob
            for d in drop:
                try:
                    (self.root / d.key).unlink()
                except FileNotFoundError:
                    pass
                self.gc_records_total += 1
                self.gc_bytes_total += d.nbytes
            self.put_bytes_total += nbytes
        return entry

    def disk_bytes(self) -> int:
        """Bytes currently on disk (blobs only) — the retention bound."""
        return sum(p.stat().st_size for p in self.root.glob("rec_*.bin"))

    def entries(self) -> list[ManifestEntry]:
        path = self.root / MANIFEST
        if not path.exists():
            return []
        data = json.loads(path.read_text())
        return [ManifestEntry(**e) for e in data["entries"]]

    def read(self, entry: ManifestEntry) -> FlushRecord:
        path = self.root / entry.key
        if not path.exists():
            raise TornRecordError(f"{self.name}: missing blob {entry.key}")
        with open(path, "rb") as f:
            return FlushRecord.read_from(f)


class ObjectStoreTier:
    """In-memory object-store stub: injectable latency + failures.

    Latency is paid on the *flush worker* thread — the trainer never
    blocks on it, so no flush stage ever reaches the stall ledger.

    Real object stores fail transiently, so ``put`` retries with bounded
    exponential backoff: up to ``retry_attempts`` total attempts, sleeping
    ``retry_backoff_s * 2**(attempt-1)`` between them (capped at
    ``retry_backoff_cap_s``), all of it on the flush-worker thread.
    ``transient_fail_steps`` maps a step to how many attempts fail before
    one succeeds (the retry drill); ``fail_steps`` stays permanent. When
    the budget is exhausted the final `TierPutError` propagates to the
    caller — `FlushWorker` catches it, books a put failure, and the tier
    simply lags (``durability_tier_lag_steps``); nothing raises into the
    flush loop.
    """

    name = "object-store"

    def __init__(self, latency_s: float = 0.0, retry_attempts: int = 1,
                 retry_backoff_s: float = 0.0,
                 retry_backoff_cap_s: float = 0.25,
                 retain_epochs: "int | None" = None):
        self.latency_s = float(latency_s)
        self.fail_steps: set[int] = set()
        self.transient_fail_steps: dict[int, int] = {}
        self.retry_attempts = max(1, int(retry_attempts))
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_cap_s = float(retry_backoff_cap_s)
        self.retain_epochs = retain_epochs
        self.put_bytes_total = 0
        self.retries_total = 0
        self.gc_records_total = 0
        self.gc_bytes_total = 0
        self._transient_seen: dict[tuple[int, int], int] = {}
        self._blobs: dict[str, bytes] = {}
        self._entries: list[ManifestEntry] = []
        self._lock = threading.Lock()          # concurrent worker puts

    def _put_once(self, rec: FlushRecord) -> ManifestEntry:
        if rec.step in self.fail_steps:
            raise TierPutError(
                f"{self.name}: injected put failure at step {rec.step}")
        budget = self.transient_fail_steps.get(rec.step, 0)
        if budget:
            k = (rec.step, rec.node)
            with self._lock:
                seen = self._transient_seen.get(k, 0)
                if seen < budget:
                    self._transient_seen[k] = seen + 1
            if seen < budget:
                raise TierPutError(
                    f"{self.name}: transient put failure at step "
                    f"{rec.step} (attempt {seen + 1}/{budget})")
        if self.latency_s > 0:
            time.sleep(self.latency_s)
        buf = rec.to_bytes()
        key = _record_key(rec)
        entry = ManifestEntry.for_record(rec, key, len(buf))
        with self._lock:
            self._blobs[key] = buf
            self._entries.append(entry)
            drop = _prune_plan(self._entries, self.retain_epochs)
            if drop:
                gone = {d.key for d in drop}
                self._entries = [e for e in self._entries
                                 if e.key not in gone]
                for d in drop:
                    self._blobs.pop(d.key, None)
                    self.gc_records_total += 1
                    self.gc_bytes_total += d.nbytes
            self.put_bytes_total += len(buf)
        return entry

    def put(self, rec: FlushRecord) -> ManifestEntry:
        attempt = 0
        while True:
            attempt += 1
            try:
                return self._put_once(rec)
            except TierPutError:
                if attempt >= self.retry_attempts:
                    raise          # budget spent: the worker books the lag
                with self._lock:
                    self.retries_total += 1
                if self.retry_backoff_s > 0:
                    time.sleep(min(self.retry_backoff_s * 2 ** (attempt - 1),
                                   self.retry_backoff_cap_s))

    def entries(self) -> list[ManifestEntry]:
        with self._lock:
            return list(self._entries)

    def read(self, entry: ManifestEntry) -> FlushRecord:
        try:
            buf = self._blobs[entry.key]
        except KeyError:
            raise TornRecordError(
                f"{self.name}: missing blob {entry.key}") from None
        return FlushRecord.from_bytes(buf)


def tier_names(tiers: Iterable[Tier]) -> list[str]:
    return [t.name for t in tiers]
