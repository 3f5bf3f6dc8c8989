"""Background flush plane: shadow state -> durability tiers, off the hot
path — the port of ``repro.durability.flush``.

`DurableShadow` attaches to a `repro_torch.core.shadow.ShadowCluster` and
runs one `FlushWorker` thread per shadow node. On every
`FlushPolicy.every_steps`-th applied step the cluster's ingest calls
``notify(step)`` — a dict insert + queue put, never a copy — assigning a
globally ordered flush *epoch*; each worker then snapshots its node's
dirty bucket flats apply-atomically (`ShadowNode.snapshot_dirty`) and
writes one checksummed `FlushRecord` to every tier.

Every live node writes a record every epoch — a ``mark`` when it has
nothing dirty — so an epoch is *provably complete* (all nodes present at
one step) without a coordinator journal, and
`repro_torch.durability.restore.restore_from_tiers` walks epochs newest
first. Dead nodes write nothing: their epochs stay visibly incomplete.

The snapshot lands in one host buffer per node, sized exactly to the
node's state and allocated once when the worker starts; on the card it is
a plain allocation page-locked with ``cudaHostRegister`` (PyTorch's pinned
allocator would round it up to a power of two), and the copy runs on the
node's stream under its ``state_lock``. Records are views of that buffer
and stream to the tiers from it, so the worker copies the state once.

Nothing here runs on the training thread: no flush stage ever reaches the
trainer's stall ledger. Compressed deltas quantize the *difference*
against a per-worker f32 reconstruction buffer on the node's device with
the stateless no-EF codec (`quantize_flat_stateless`), so flushing never
perturbs a channel Compressor's error-feedback residuals; bases are
always raw, so the chain re-anchors exactly every
`FlushPolicy.rebase_every` cycles.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import obs as _obs
from repro_torch.core.buckets import ITEMSIZE, TORCH_DTYPES, bucket_dtype
from repro_torch.dist.compression import (dequantize_flat_stateless,
                                          quantize_flat_stateless)
from repro_torch.durability.record import FlushRecord
from repro_torch.durability.tiers import Tier, TierPutError

_ALIGN = 64              # each field's slot in the host buffer starts here


@dataclass(frozen=True)
class FlushPolicy:
    """Knobs for the background flush plane.

    ``every_steps`` — flush epoch cadence in applied train steps (tier
    lag is bounded by ``every_steps - 1`` plus in-flight flushes).
    ``compress`` — int8-quantize delta payloads (bases stay raw; restore
    is then approximate).
    ``rebase_every`` — force a raw base every N flush cycles per node,
    bounding both the restore chain length and compression drift.
    """

    every_steps: int = 1
    compress: bool = False
    rebase_every: int = 8
    drain_timeout_s: float = 30.0


class _HostBuffer:
    """One node's snapshot buffer: a (p, m, v) host view per owned bucket
    in one allocation, page-locked in place when the node is on the card.
    """

    def __init__(self, node):
        slots, off = {}, 0
        for bid in node.bucket_ids:
            b = node._by_id[bid]
            fields = []
            for dt in (bucket_dtype(b), "float32", "float32"):
                off = -(-off // _ALIGN) * _ALIGN
                fields.append((off, b.size, dt))
                off += b.size * ITEMSIZE[dt]
            slots[bid] = fields
        self.nbytes = off
        self._buf = torch.empty(off, dtype=torch.uint8)
        self._release = None
        if node.device.type == "cuda" and off:
            err = torch.cuda.cudart().cudaHostRegister(
                self._buf.data_ptr(), off, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of {off} bytes failed "
                                   f"({err})")
            # unregistered before the memory can be freed, also if the
            # buffer is dropped without release()
            self._release = weakref.finalize(self, _unregister, self._buf)
        self.views = {
            bid: tuple(self._buf[o:o + n * ITEMSIZE[dt]].view(
                TORCH_DTYPES[dt]) for o, n, dt in fields)
            for bid, fields in slots.items()}

    def release(self):
        if self._release is not None:
            self._release()


def _unregister(buf: torch.Tensor):
    torch.cuda.cudart().cudaHostUnregister(buf.data_ptr())


class FlushWorker:
    """One background flusher per shadow node. Never blocks the trainer."""

    def __init__(self, dur: "DurableShadow", node):
        self.dur = dur
        self.node = node
        self.q: queue.Queue = queue.Queue()
        self.flush_count = 0            # cycles processed -> rebase cadence
        self.host = _HostBuffer(node)
        self.stream = (torch.cuda.Stream(node.device)
                       if node.device.type == "cuda" else None)
        # compressed path: f32 reconstruction of what the tiers can
        # rebuild, on the node's device
        self._recon: dict[int, dict[str, torch.Tensor]] = {}
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, epoch: int, step: int, force_base: bool):
        self.q.put((epoch, step, force_base))

    def join(self):
        self.q.join()

    def close(self):
        self.q.put(None)
        self._thread.join(timeout=60)
        if not self._thread.is_alive():
            self.host.release()

    def _loop(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            try:
                self._flush(*item)
            except Exception as e:     # the worker must keep serving epochs
                self.dur._failed(self, item, e)
            finally:
                self.q.task_done()

    def _flush(self, epoch: int, step: int, force_base: bool):
        node, dur = self.node, self.dur
        cluster = dur.cluster
        if cluster is not None and cluster.async_mode:
            # async ingest: the apply this epoch captures may still be in
            # the node's queue — wait (HERE, off the training thread) until
            # the node has caught up to the notified step
            deadline = time.monotonic() + dur.policy.drain_timeout_s
            while (node.step < step
                   and node.node_id not in cluster.dead_nodes
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        if cluster is not None and node.node_id in cluster.dead_nodes:
            return        # no record: the epoch stays visibly incomplete
        base = force_base or self.flush_count % dur.policy.rebase_every == 0
        self.flush_count += 1
        tracer = _obs.get().tracer
        track = f"durability{node.node_id}"
        with tracer.span("durability.flush", track=track,
                         args={"epoch": epoch, "step": step,
                               "node": node.node_id}):
            snap, snap_step = node.snapshot_dirty(force_all=base,
                                                  out=self.host.views)
            rec = self._build_record(epoch, snap_step, snap, base)
            for tier in dur.tiers:
                try:
                    with tracer.span("durability.put", track=track,
                                     args={"epoch": epoch, "tier": tier.name,
                                           "node": node.node_id}):
                        entry = tier.put(rec)
                except TierPutError as e:
                    dur._put_failed(tier, rec, e)
                else:
                    dur._ack(tier, rec, entry)

    def _build_record(self, epoch: int, step: int, snap: dict,
                      base: bool) -> FlushRecord:
        node = self.node
        compress = self.dur.policy.compress
        if base:
            payload = {bid: {"p": p, "m": m, "v": v}
                       for bid, (p, m, v) in snap.items()}
            if compress:
                with self._on_stream():
                    for bid, fields in payload.items():
                        if bid not in self._recon:
                            self._recon[bid] = {
                                name: torch.empty(t.shape,
                                                  dtype=torch.float32,
                                                  device=node.device)
                                for name, t in fields.items()}
                        for name, t in fields.items():
                            self._recon[bid][name].copy_(t,
                                                         non_blocking=True)
                    self._sync()
            return FlushRecord(epoch=epoch, node=node.node_id, step=step,
                               kind="base", compressed=False,
                               payload=payload)
        if not snap:
            return FlushRecord(epoch=epoch, node=node.node_id, step=step,
                               kind="mark")
        if not compress:
            payload = {bid: {"p": p, "m": m, "v": v}
                       for bid, (p, m, v) in snap.items()}
            return FlushRecord(epoch=epoch, node=node.node_id, step=step,
                               kind="delta", compressed=False,
                               payload=payload)
        by_id = node._by_id
        payload = {}
        with self._on_stream():
            for bid, (p, m, v) in snap.items():
                b = by_id[bid]
                recon = self._recon[bid]
                fields = {}
                for name, cur in (("p", p), ("m", m), ("v", v)):
                    # a fresh f32 copy on the device, made the difference
                    diff = cur.to(node.device, torch.float32,
                                  copy=True).sub_(recon[name])
                    q, scales = quantize_flat_stateless(b, diff)
                    del diff
                    recon[name] += dequantize_flat_stateless(b, q, scales)
                    fields[name] = q.to("cpu")
                    fields[name + "s"] = scales.to("cpu")
                payload[bid] = fields
            self._sync()
        return FlushRecord(epoch=epoch, node=node.node_id, step=step,
                           kind="delta", compressed=True, payload=payload)

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _sync(self):
        if self.stream is not None:
            self.stream.synchronize()


class DurableShadow:
    """Coordinates per-node `FlushWorker`s + epoch/ack bookkeeping."""

    def __init__(self, tiers: list[Tier],
                 policy: Optional[FlushPolicy] = None):
        self.tiers = list(tiers)
        self.policy = policy or FlushPolicy()
        self.cluster = None
        self.workers: dict[int, FlushWorker] = {}
        self._lock = threading.Lock()
        self._next_epoch = 0
        # epoch -> frozenset of node ids notified (the completeness bar)
        self._epoch_nodes: dict[int, frozenset] = {}
        # epoch -> cluster size when the epoch opened; completeness is
        # judged against THIS, not the current cluster
        self._epoch_total: dict[int, int] = {}
        # epoch -> {node id -> step its record landed at}
        self._epoch_steps: dict[int, dict[int, int]] = {}
        # tier name -> epoch -> set of acked node ids
        self._acks: dict[str, dict[int, set]] = {t.name: {}
                                                 for t in self.tiers}
        self.put_failures = 0
        self.flush_bytes_total = 0
        self.epochs_started = 0
        # (node id, epoch, exception) for each flush that raised
        self.errors: list[tuple] = []

    # -- wiring ---------------------------------------------------------------
    def attach(self, cluster) -> "DurableShadow":
        """Hook into a ShadowCluster: the cluster's ingest/bootstrap paths
        call back into :meth:`notify` / :meth:`on_bootstrap`. Starts one
        worker, with its host snapshot buffer, per node."""
        if not cluster.flat:
            raise ValueError("durability flushes wire-layout flats; "
                             "flat=False is not supported")
        self.cluster = cluster
        cluster.durability = self
        self.workers = {n.node_id: FlushWorker(self, n)
                        for n in cluster.nodes}
        return self

    def reattach(self, cluster) -> "DurableShadow":
        """Migrate the flush plane to another cluster: drain and retire
        the old workers, keep the tiers and the epoch/ack history (epoch
        numbering continues), start fresh workers for the new nodes."""
        self.drain()
        for w in self.workers.values():
            w.close()
        old = self.cluster
        if old is not None and old.durability is self:
            old.durability = None
        return self.attach(cluster)

    # -- hot-path hook (called from ShadowCluster.on_delivery) ----------------
    def notify(self, step: int, force_base: bool = False):
        """Open a flush epoch for ``step`` if the cadence says so.

        O(n_nodes) queue puts — no snapshot, no serialization, no I/O
        happens on the caller's thread.
        """
        if (not force_base and self.policy.every_steps > 1
                and step % self.policy.every_steps != 0):
            return
        cluster = self.cluster
        live = [n.node_id for n in cluster.nodes
                if n.node_id not in cluster.dead_nodes]
        if not live:
            return
        with self._lock:
            epoch = self._next_epoch
            self._next_epoch += 1
            self._epoch_nodes[epoch] = frozenset(live)
            self._epoch_total[epoch] = cluster.n_nodes
            self._epoch_steps[epoch] = {}
            self.epochs_started += 1
        for nid in live:
            self.workers[nid].submit(epoch, step, force_base)

    def on_bootstrap(self, step: int):
        """Cold path: force a raw base epoch and wait for it, so a full
        restore point exists from the moment the replica is seeded."""
        self.notify(step, force_base=True)
        self.drain()

    # -- bookkeeping (called from FlushWorker threads) ------------------------
    def _ack(self, tier: Tier, rec: FlushRecord, entry):
        with self._lock:
            self._acks[tier.name].setdefault(rec.epoch, set()).add(rec.node)
            self._epoch_steps[rec.epoch][rec.node] = rec.step
            self.flush_bytes_total += entry.nbytes
        obs = _obs.get()
        obs.metrics.counter(
            "durability_flush_bytes",
            "Bytes flushed to durability tiers").inc(
            entry.nbytes, tier=tier.name)
        last = self.last_complete_step(tier.name)
        if last is not None and self.cluster is not None:
            obs.metrics.gauge(
                "durability_tier_lag_steps",
                "Train steps the tier's newest complete epoch trails by"
            ).set(max(0, self.cluster.train_step_seen - last),
                  tier=tier.name)

    def _put_failed(self, tier: Tier, rec: FlushRecord, err: Exception):
        with self._lock:
            self.put_failures += 1
        _obs.get().metrics.counter(
            "durability_tier_put_failures_total",
            "Tier writes that failed (record not durable there)").inc(
            1, tier=tier.name)

    def _failed(self, worker: FlushWorker, item: tuple, err: Exception):
        with self._lock:
            self.errors.append((worker.node.node_id, item[0], err))

    # -- queries --------------------------------------------------------------
    def last_complete_step(self, tier_name: str) -> Optional[int]:
        """Newest step at which EVERY cluster node's record is durable on
        ``tier_name`` within one epoch — the step `restore_from_tiers`
        would recover to from that tier."""
        best = None
        with self._lock:
            acks = self._acks.get(tier_name, {})
            for epoch, nodes in self._epoch_nodes.items():
                n_total = self._epoch_total.get(epoch)
                if n_total is not None and len(nodes) < n_total:
                    continue          # some nodes dead: not a full restore
                if not nodes <= acks.get(epoch, set()):
                    continue
                steps = {self._epoch_steps[epoch][n] for n in nodes}
                if len(steps) != 1:
                    continue          # workers raced past each other
                s = steps.pop()
                if best is None or s > best:
                    best = s
        return best

    def newest_durable(self) -> Optional[tuple[str, int]]:
        """(tier name, step) of the freshest full restore point, or None."""
        best = None
        for tier in self.tiers:
            s = self.last_complete_step(tier.name)
            if s is not None and (best is None or s > best[1]):
                best = (tier.name, s)
        return best

    # -- lifecycle ------------------------------------------------------------
    def drain(self):
        """Block until every queued flush has been written (a cold-path
        helper: nothing on the trainer's path calls it)."""
        for w in self.workers.values():
            w.join()

    def close(self):
        for w in self.workers.values():
            w.close()
        self.workers = {}
