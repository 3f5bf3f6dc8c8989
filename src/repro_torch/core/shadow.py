"""Shadow cluster (paper §4.2): replicas that turn captured gradients into
per-iteration checkpoints — the port of ``repro.core.shadow``.

Each node owns a byte-balanced set of gradient buckets (§4.2.4) and keeps
params, mu and nu for exactly those buckets on its ``device``. With
``flat=True`` (default) they are per-bucket flat buffers in the layout
deliveries arrive in, and an apply is one optimizer update per bucket
(`repro_torch.optim.functional.update_`: one fused AdamW launch for
AdamW, the plain elementwise update for Adam and SGD); ``flat=False``
keeps per-leaf tensors and updates once per leaf after unpacking the
bucket (the regression oracle). Either way the update is in place under
``state_lock`` (the JAX package donates the buffers to a jit instead),
with the same host-computed f32 scalars as the trainer, so the two states
are bit-identical.

On the card every node runs its applies on a CUDA stream of its own, so
they overlap the trainer's kernels, and receives host buckets through a
copy stream and two device staging buffers sized by its largest bucket:
bucket i+1's host-to-device copy is queued before bucket i's update, each
update waits on its own copy's event, and a staging buffer is refilled
only after the update that read it has finished.

Async mode runs one worker thread per node. A worker whose apply raises
loses its node, as does `ShadowCluster.kill_node`: consolidation then
raises `ShadowNodeLoss` naming exactly that node's buckets. With
``max_lag_steps=K`` a worker drains up to K pending deliveries per wakeup
and replays them as K sequential updates (`ShadowNode.apply_batch`,
bit-identical to K separate applies), and the trainer blocks in
``_lag_gate`` while a node's backlog is at the bound; the checkpointer
books that wait as the ``apply-lag`` stall stage.

Each apply marks its buckets ``dirty``; `ShadowNode.snapshot_dirty` is
the durability flush's apply-atomic copy of them
(`repro_torch.durability`), and `plan_shadow_nodes` sizes the fleet from
one measured apply.
"""
from __future__ import annotations

import contextlib
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import obs as _obs
from repro_torch.core.buckets import (ITEMSIZE, BucketLayout, alloc_flat,
                                      bucket_dtype, pack_bucket_into,
                                      unpack_bucket)
from repro_torch.core.channel import Delivery
from repro_torch.core.multicast import assign_buckets
from repro_torch.device import resolve
from repro_torch.optim.functional import OptimizerConfig, update_


APPLY_TIMES_MAXLEN = 512       # recent-apply window kept per node


class ConsolidationTimeout(RuntimeError):
    """Consolidation hit its deadline with shadow nodes still applying.
    ``partial`` is apply-atomic per node, at the slowest node's step;
    ``lagging_buckets`` maps each lagging node to its owned bucket ids."""

    def __init__(self, lagging_nodes: list[int], partial: dict,
                 lagging_buckets: Optional[dict] = None):
        msg = (f"shadow consolidation timed out; lagging nodes: "
               f"{lagging_nodes} (partial checkpoint at step "
               f"{partial.get('step')})")
        if lagging_buckets:
            msg += f"; lagging buckets: {lagging_buckets}"
        super().__init__(msg)
        self.lagging_nodes = lagging_nodes
        self.partial = partial
        self.lagging_buckets = dict(lagging_buckets or {})


class ShadowNodeLoss(RuntimeError):
    """Consolidation found lost shadow nodes: their partitions are gone.

    ``missing_buckets`` is exactly the lost nodes' bucket ids and
    ``partial`` the survivors' fragments. ``total`` marks the loss of the
    whole plane (nothing to merge: only the durability tiers can help);
    ``durable_hint`` is ``(tier name, step)`` of the newest full restore
    point when a `repro_torch.durability.DurableShadow` is attached. The
    message is the JAX package's."""

    def __init__(self, dead_nodes: list[int], missing_buckets: dict,
                 partial: dict, total: bool = False,
                 durable_hint: Optional[tuple] = None):
        msg = (f"shadow node(s) {dead_nodes} lost; missing buckets: "
               f"{missing_buckets} (partial checkpoint at step "
               f"{partial.get('step')})")
        if total:
            msg = (f"TOTAL shadow-plane loss: all {len(dead_nodes)} "
                   f"node(s) {dead_nodes} dead, every bucket missing")
            if durable_hint is not None:
                tname, tstep = durable_hint
                msg += (f"; recover via restore_from_tiers() — newest "
                        f"durable tier '{tname}' holds step {tstep}")
            else:
                msg += ("; no durability tier attached: the checkpoint "
                        "is unrecoverable")
        elif durable_hint is not None:
            tname, tstep = durable_hint
            msg += (f"; tier '{tname}' holds the missing shards durably "
                    f"up to step {tstep}")
        super().__init__(msg)
        self.dead_nodes = list(dead_nodes)
        self.missing_buckets = dict(missing_buckets)
        self.partial = partial
        self.total = bool(total)
        self.durable_hint = durable_hint


def _as_tensor(x, device, copy: bool = False) -> torch.Tensor:
    """``x`` (tensor or array) as a contiguous tensor on ``device``; a copy
    when ``copy`` (it may otherwise alias ``x``)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t.to(device, copy=copy).contiguous()


class ShadowNode:
    """One shadow node: its buckets' state + the functional optimizer, per
    bucket (``flat=True``) or per leaf (``flat=False``)."""

    def __init__(self, node_id: int, opt: OptimizerConfig,
                 layout: BucketLayout, bucket_ids: list[int],
                 device: torch.device, flat: bool = True,
                 apply_times_maxlen: int = APPLY_TIMES_MAXLEN):
        self.node_id = node_id
        self.opt = opt
        self.layout = layout
        self.device = device
        self.flat = flat
        self.bucket_ids = sorted(bucket_ids)
        self._by_id = {b.bucket_id: b for b in layout.buckets}
        cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.copy_stream = torch.cuda.Stream(device) if cuda else None
        # two staging buffers (raw bytes, allocated at the first staged
        # receive) and the events that order their copies and updates
        self._stage_bytes = max(
            (self._by_id[b].size * ITEMSIZE[bucket_dtype(self._by_id[b])]
             for b in self.bucket_ids), default=0)
        self._stage: list[torch.Tensor] = []
        self._copied = [torch.cuda.Event(), torch.cuda.Event()] if cuda \
            else []
        self._applied = [torch.cuda.Event(), torch.cuda.Event()] if cuda \
            else []
        # flat state: bucket_id -> flat buffer
        self._pf: dict[int, torch.Tensor] = {}
        self._mf: dict[int, torch.Tensor] = {}
        self._vf: dict[int, torch.Tensor] = {}
        # per-leaf state (flat=False): leaf name -> tensor
        self.params: dict[str, torch.Tensor] = {}
        self.mu: dict[str, torch.Tensor] = {}
        self.nu: dict[str, torch.Tensor] = {}
        # bucket ids updated since a durability flush last drained them
        # (`snapshot_dirty`); kept under state_lock
        self.dirty: set[int] = set()
        self.step = 0
        # bounded recent-apply window; the counters below stay exact
        self.apply_times: deque = deque(maxlen=apply_times_maxlen)
        self.apply_count = 0
        self.apply_total_s = 0.0
        self.apply_max_s = 0.0
        # the apply updates the buffers in place while holding this lock,
        # so a snapshot never sees a torn partition
        self.state_lock = threading.Lock()

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _after_caller(self):
        """Order this node's stream after work the caller already queued
        on its own stream (device-resident inputs)."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def _sync(self):
        if self.stream is not None:
            self.stream.synchronize()

    def _names(self, bid: int) -> list[str]:
        return [s.name for s in self._by_id[bid].slots]

    def bootstrap(self, params, mu, nu, step: int):
        """Install the replica from leaf trees (copies, never aliases)."""
        self._after_caller()
        with self._on_stream():
            if self.flat:
                pf, mf, vf = {}, {}, {}
                for bid in self.bucket_ids:
                    b = self._by_id[bid]
                    for src, dst, dt in ((params, pf, bucket_dtype(b)),
                                         (mu, mf, "float32"),
                                         (nu, vf, "float32")):
                        leaves = {n: _as_tensor(src[n], self.device)
                                  for n in self._names(bid)}
                        dst[bid] = pack_bucket_into(
                            b, leaves, alloc_flat(b.size, dt, self.device))
                state = (pf, mf, vf, {}, {}, {})
            else:
                names = [n for bid in self.bucket_ids
                         for n in self._names(bid)]
                state = ({}, {}, {},
                         *({n: _as_tensor(tree[n], self.device, copy=True)
                            for n in names} for tree in (params, mu, nu)))
            self._sync()
        with self.state_lock:
            (self._pf, self._mf, self._vf,
             self.params, self.mu, self.nu) = state
            self.dirty = set(self.bucket_ids)
            self.step = int(step)

    def snapshot(self) -> tuple[dict, dict, dict, int]:
        """Apply-atomic (params, mu, nu, step) host leaf trees (copies)."""
        with self.state_lock, self._on_stream():
            step = self.step
            if not self.flat:
                return tuple({k: t.to("cpu", copy=True)
                              for k, t in tree.items()}
                             for tree in (self.params, self.mu,
                                          self.nu)) + (step,)
            pf = {bid: t.to("cpu", copy=True) for bid, t in self._pf.items()}
            mf = {bid: t.to("cpu", copy=True) for bid, t in self._mf.items()}
            vf = {bid: t.to("cpu", copy=True) for bid, t in self._vf.items()}
        params, mu, nu = {}, {}, {}
        for bid in self.bucket_ids:
            b = self._by_id[bid]
            params.update(unpack_bucket(b, pf[bid]))
            mu.update(unpack_bucket(b, mf[bid]))
            nu.update(unpack_bucket(b, vf[bid]))
        return params, mu, nu, step

    def snapshot_dirty(self, force_all: bool = False,
                       out: Optional[dict] = None) -> tuple[dict, int]:
        """Apply-atomic host copy of the dirty bucket flats; drains
        ``dirty``. Returns ``({bucket_id: (p, m, v)}, step)`` in wire
        layout, the durability flush payload. ``force_all`` copies every
        owned bucket (a base record).

        ``out`` (bucket_id -> (p, m, v) host tensors of the flats' sizes)
        receives the copies instead of fresh tensors; on the card they run
        on this node's stream, awaited before the lock is released, so the
        time under the lock is the copy's (the ``durability.snapshot``
        span).
        """
        if not self.flat:
            raise ValueError("snapshot_dirty requires the flat wire layout")
        with self.state_lock, _obs.get().tracer.span(
                "durability.snapshot", track=f"durability{self.node_id}",
                args={"node": self.node_id, "step": self.step}):
            bids = self.bucket_ids if force_all else sorted(self.dirty)
            bids = [b for b in bids if b in self._pf]      # lost: gone
            snap = {}
            with self._on_stream():
                for bid in bids:
                    src = (self._pf[bid], self._mf[bid], self._vf[bid])
                    if out is None:
                        snap[bid] = tuple(t.to("cpu", copy=True)
                                          for t in src)
                        continue
                    for d, t in zip(out[bid], src):
                        d.copy_(t, non_blocking=True)
                    snap[bid] = out[bid]
                self._sync()
            self.dirty.difference_update(bids)
            step = self.step
        return snap, step

    def _record(self, dt: float):
        self.apply_times.append(dt)
        self.apply_count += 1
        self.apply_total_s += dt
        self.apply_max_s = max(self.apply_max_s, dt)
        _obs.get().metrics.histogram(
            "shadow_apply_seconds",
            "Per-apply wall time by shadow node").observe(
            dt, node=self.node_id)

    def apply(self, step: int, lr: float, flats: dict,
              grad_scale: float = 1.0):
        """One iteration's gradients for this node's buckets (``flats``:
        bucket_id -> flat buffer, on the host or the device)."""
        with _obs.get().tracer.span("shadow.apply",
                                    track=f"shadow{self.node_id}",
                                    args={"step": step,
                                          "node": self.node_id}):
            self._apply(step, lr, flats, grad_scale)

    def apply_batch(self, items: list[tuple]):
        """Apply K pending deliveries ``[(step, lr, flats, grad_scale),
        ...]`` as K *sequential* updates, the bounded-lag catch-up path:
        bit-identical to K separate `apply` calls by construction."""
        if len(items) == 1:
            return self.apply(*items[0])
        with _obs.get().tracer.span("shadow.apply_batch",
                                    track=f"shadow{self.node_id}",
                                    args={"k": len(items),
                                          "from_step": items[0][0],
                                          "to_step": items[-1][0],
                                          "node": self.node_id}):
            for item in items:
                self._apply(*item)

    def _staging(self, k: int, like: torch.Tensor) -> torch.Tensor:
        if not self._stage:
            self._stage = [torch.empty(self._stage_bytes, dtype=torch.uint8,
                                       device=self.device) for _ in range(2)]
        nbytes = like.numel() * like.element_size()
        return self._stage[k][:nbytes].view(like.dtype)

    def _received(self, flats: dict):
        """Yield (bucket id, gradient on this node's device) in bucket
        order, on this node's stream. Host buckets on the card are staged:
        bucket j+1's copy is queued on the copy stream before bucket j is
        yielded for its update."""
        ids = self.bucket_ids
        if self.stream is None or any(flats[b].device.type == "cuda"
                                      for b in ids):
            for bid in ids:
                yield bid, flats[bid].to(self.device, non_blocking=True)
            return

        def stage(j: int) -> torch.Tensor:
            src, k = flats[ids[j]], j % 2
            buf = self._staging(k, src)
            # the buffer's previous reader (bucket j-2) must be done
            self.copy_stream.wait_event(self._applied[k])
            with torch.cuda.stream(self.copy_stream):
                buf.copy_(src, non_blocking=True)
            self._copied[k].record(self.copy_stream)
            return buf

        nxt = stage(0) if ids else None
        for j, bid in enumerate(ids):
            g = nxt
            if j + 1 < len(ids):
                nxt = stage(j + 1)
            self.stream.wait_event(self._copied[j % 2])
            yield bid, g
            self._applied[j % 2].record(self.stream)

    def _apply(self, step, lr, flats, grad_scale):
        t0 = time.perf_counter()
        opt = self.opt
        if any(flats[bid].device.type == "cuda" for bid in self.bucket_ids):
            self._after_caller()
        with self.state_lock, self._on_stream():
            for bid, g in self._received(flats):
                if self.flat:
                    update_(self._pf[bid], g, self._mf[bid], self._vf[bid],
                            step, opt, lr, grad_scale)
                    continue
                for name, gl in unpack_bucket(self._by_id[bid], g).items():
                    update_(self.params[name], gl, self.mu[name],
                            self.nu[name], step, opt, lr, grad_scale)
            # the host flats must outlive their copies: wait here
            self._sync()
            self.dirty.update(self.bucket_ids)
            self.step = step
        self._record(time.perf_counter() - t0)


@dataclass
class ShadowStats:
    steps_applied: int
    lag: int                       # training step - shadow step
    max_queue_depth: int
    mean_apply_s: float
    max_apply_s: float
    per_node_apply_s: list[float]
    lag_waits: int = 0             # times the trainer blocked on the bound
    lag_wait_s: float = 0.0        # total seconds the trainer waited
    batched_applies: int = 0       # multi-step worker drains (k >= 2)
    max_batch: int = 1             # largest k a single drain replayed


class ShadowCluster:
    """Checkmate's shadow plane: N nodes x a partitioned functional
    optimizer.

    ``assignment`` (bucket_id -> node) replaces the byte-balanced default
    ownership; ``apply_times_maxlen`` bounds each node's ``apply_times``
    window. ``durability`` is set by `repro_torch.durability.DurableShadow`
    when one attaches: every ingest then calls its ``notify``, a bootstrap
    its ``on_bootstrap`` and `shutdown` its ``close``.
    """

    def __init__(self, layout: BucketLayout, opt: OptimizerConfig,
                 n_nodes: int = 1, async_mode: bool = False, device=None,
                 flat: bool = True,
                 apply_times_maxlen: int = APPLY_TIMES_MAXLEN,
                 assignment: Optional[dict] = None,
                 max_lag_steps: Optional[int] = None):
        self.device = resolve(device)
        if max_lag_steps is not None:
            if max_lag_steps < 1:
                raise ValueError(f"max_lag_steps must be >= 1, "
                                 f"got {max_lag_steps}")
            if not async_mode:
                raise ValueError("max_lag_steps bounds the async delivery "
                                 "queue; sync mode never lags")
        self.layout = layout
        self.opt = opt
        self.n_nodes = n_nodes
        self.flat = flat
        self.assignment = (dict(assignment) if assignment is not None
                           else assign_buckets(layout, n_nodes))
        self.nodes = [
            ShadowNode(i, opt, layout,
                       [b for b, n in self.assignment.items() if n == i],
                       self.device, flat=flat,
                       apply_times_maxlen=apply_times_maxlen)
            for i in range(n_nodes)]
        self.async_mode = async_mode
        self.max_lag_steps = max_lag_steps
        self.train_step_seen = 0
        self.max_queue_depth = 0
        self.lag_waits = 0
        self.lag_wait_s_total = 0.0
        self.batched_applies = 0
        self.max_batch = 1
        self.dead_nodes: set[int] = set()
        self.errors: dict[int, BaseException] = {}
        self.durability = None
        self._queues: list[queue.Queue] = []
        self._drained: list[threading.Event] = []
        self._lag_cvs: list[threading.Condition] = []
        self._workers: list[threading.Thread] = []
        if async_mode:
            for node in self.nodes:
                q: queue.Queue = queue.Queue()
                ev = threading.Event()
                ev.set()                        # empty queue == drained
                t = threading.Thread(target=self._worker, args=(node, q, ev),
                                     daemon=True)
                t.start()
                self._queues.append(q)
                self._drained.append(ev)
                self._lag_cvs.append(threading.Condition())
                self._workers.append(t)

    # -- async plumbing --------------------------------------------------------
    def _worker(self, node: ShadowNode, q: queue.Queue,
                drained: threading.Event):
        # a bounded-lag shadow catches up by replaying up to K pending
        # deliveries per wakeup; without a bound, one per wakeup
        limit = self.max_lag_steps or 1
        while True:
            item = q.get()
            stop = item is None
            batch = [] if stop else [item]
            while not stop and len(batch) < limit:
                try:
                    nxt = q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True           # shutdown sentinel: drain then exit
                    break
                batch.append(nxt)
            # a node killed after these items were queued has no state left
            if batch and node.node_id not in self.dead_nodes:
                try:
                    node.apply_batch(batch)
                except Exception as e:  # the node is lost; keep draining
                    self.errors[node.node_id] = e
                    self.dead_nodes.add(node.node_id)
                else:
                    if len(batch) > 1:
                        self.batched_applies += 1
                        self.max_batch = max(self.max_batch, len(batch))
            self._settle(node.node_id, q, drained,
                         len(batch) + (1 if stop else 0))
            if stop:
                drained.set()
                return

    def _settle(self, node_id: int, q: queue.Queue,
                drained: threading.Event, n: int):
        """Mark ``n`` queue items done, refresh the drain signal, and wake a
        trainer blocked on the lag bound."""
        for _ in range(n):
            q.task_done()
        with q.mutex:
            if q.unfinished_tasks == 0:
                drained.set()
        if self.max_lag_steps is not None:
            cv = self._lag_cvs[node_id]
            with cv:
                cv.notify_all()

    @staticmethod
    def _pending(q: queue.Queue) -> int:
        with q.mutex:
            return q.unfinished_tasks

    def _lag_gate(self, node_id: int, q: queue.Queue):
        """Block the trainer's ingest while ``node_id``'s backlog is at the
        lag bound: the shadow trails by at most ``max_lag_steps`` steps."""
        limit = self.max_lag_steps
        if self._pending(q) < limit or node_id in self.dead_nodes:
            return
        t0 = time.perf_counter()
        cv = self._lag_cvs[node_id]
        with cv:
            # timed wait, so a node killed mid-wait cannot strand the
            # trainer: the dead check runs again at each wakeup
            while (self._pending(q) >= limit
                   and node_id not in self.dead_nodes):
                cv.wait(0.05)
        dt = time.perf_counter() - t0
        self.lag_waits += 1
        self.lag_wait_s_total += dt
        _obs.get().metrics.counter(
            "shadow_lag_wait_seconds_total",
            "Trainer wait for a backlogged shadow applier "
            "(the apply-lag stall stage)").inc(dt, node=node_id)

    def _wait_drained(self, deadline: float) -> list[int]:
        """Wait for every live node's queue to drain; returns the nodes
        still behind at the deadline."""
        for i, (q, ev) in enumerate(zip(self._queues, self._drained)):
            while self._pending(q) and i not in self.dead_nodes:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not ev.wait(remaining):
                    break
                if self._pending(q):
                    ev.clear()                  # stale signal: re-arm
        return [i for i, q in enumerate(self._queues)
                if i not in self.dead_nodes and self._pending(q)]

    # -- API -------------------------------------------------------------------
    def bootstrap(self, params, mu, nu, step: int = 0):
        """Install the full replica (also the resync path: revives lost
        nodes). A full-state install supersedes still-queued deliveries:
        they are dropped, and an apply in flight finishes on the old state
        first."""
        for q in self._queues:
            try:
                while True:
                    item = q.get_nowait()
                    if item is None:      # never eat a shutdown sentinel
                        q.put(None)       # (task_done below pairs our get
                    q.task_done()         # with the re-put's increment)
                    if item is None:
                        break
            except queue.Empty:
                pass
            while self._pending(q):
                time.sleep(0.001)
        self.dead_nodes.clear()
        self.errors.clear()
        for node in self.nodes:
            node.bootstrap(params, mu, nu, step)
        self.train_step_seen = int(step)
        if self.durability is not None:
            # a full restore point from the moment the replica is seeded
            self.durability.on_bootstrap(int(step))

    def kill_node(self, node_id: int):
        """Shadow-node death: the node's partition (params and both
        moments) is gone, and its queued work is dropped. A later
        `bootstrap` re-seeds a replacement."""
        if node_id in self.dead_nodes:
            return
        if not 0 <= node_id < self.n_nodes:
            raise ValueError(f"no shadow node {node_id} "
                             f"(cluster has {self.n_nodes})")
        self.dead_nodes.add(node_id)
        node = self.nodes[node_id]
        if self.async_mode:
            q, ev = self._queues[node_id], self._drained[node_id]
            try:
                while True:
                    q.get_nowait()
                    q.task_done()
            except queue.Empty:
                pass
            with q.mutex:
                if q.unfinished_tasks == 0:
                    ev.set()
            if self.max_lag_steps is not None:
                cv = self._lag_cvs[node_id]
                with cv:          # wake a trainer blocked on the dead node
                    cv.notify_all()
        with node.state_lock:     # an apply in flight finishes first
            node._pf, node._mf, node._vf = {}, {}, {}
            node.params, node.mu, node.nu = {}, {}, {}
        _obs.get().metrics.counter(
            "shadow_node_deaths_total",
            "Shadow nodes lost (partition dropped)").inc(1, node=node_id)

    def on_delivery(self, delivery: Delivery, nodes: Optional[set] = None):
        """Consume one channel delivery (the only gradient ingress).

        Each node is handed only its own buckets of ``delivery.flats``: a
        sharded transport's partial delivery lacks the other owners'.
        ``nodes`` restricts the apply to those node ids (the sharded
        transport's per-owner gate, ``Delivery.node_complete``); every one
        of them must be complete. Without ``nodes`` the delivery must be
        complete as a whole. A refused delivery raises ValueError.
        """
        if nodes is not None:
            nc = delivery.node_complete
            bad = sorted(n for n in nodes
                         if not (delivery.complete if nc is None
                                 else nc.get(n, False)))
            if bad:
                raise ValueError(
                    f"refusing sharded delivery for step {delivery.step}: "
                    f"capture incomplete for nodes {bad}")
        elif not delivery.complete:
            raise ValueError(
                f"refusing gated delivery for step {delivery.step}: "
                f"capture incomplete ({delivery.missing_captures} missing)")
        if delivery.flats is None:
            raise ValueError(f"delivery for step {delivery.step} carries no "
                             f"flats")
        step, flats = delivery.step, delivery.flats
        self.train_step_seen = step
        targets = [n for n in self.nodes
                   if n.node_id not in self.dead_nodes
                   and (nodes is None or n.node_id in nodes)]
        for node in targets:
            item = (step, delivery.lr,
                    {bid: flats[bid] for bid in node.bucket_ids},
                    delivery.grad_scale)
            if not self.async_mode:
                node.apply(*item)
                continue
            q = self._queues[node.node_id]
            if self.max_lag_steps is not None:
                self._lag_gate(node.node_id, q)
            self._drained[node.node_id].clear()
            q.put(item)
            depth = self._pending(q)
            self.max_queue_depth = max(self.max_queue_depth, depth)
            if self.max_lag_steps is not None:
                _obs.get().metrics.gauge(
                    "shadow_lag_steps",
                    "Shadow applier backlog at ingest (bounded by "
                    "max_lag_steps)").set(depth, node=node.node_id)
        if self.durability is not None:
            self.durability.notify(step)          # queue puts only

    def consolidate(self, timeout: Optional[float] = None) -> dict:
        """Gather a full checkpoint from the nodes' partitions, waiting up
        to ``timeout`` seconds (default 60) for queued applies.

        Raises `ConsolidationTimeout` if a live node is still behind at the
        deadline and `ShadowNodeLoss` if any node was lost.
        """
        with _obs.get().tracer.span("shadow.consolidate", track="shadow"):
            if self.async_mode:
                lagging = self._wait_drained(
                    time.monotonic() + (60.0 if timeout is None else timeout))
                if lagging:
                    raise ConsolidationTimeout(
                        lagging, self._gather(),
                        lagging_buckets={i: tuple(self.nodes[i].bucket_ids)
                                         for i in lagging})
            if self.dead_nodes:
                dead = sorted(self.dead_nodes)
                _obs.get().metrics.counter(
                    "shadow_consolidate_missing_buckets_total",
                    "Buckets unreachable at consolidate (dead owners)").inc(
                    sum(len(self.nodes[n].bucket_ids) for n in dead))
                err = next((self.errors[n] for n in dead
                            if n in self.errors), None)
                raise ShadowNodeLoss(
                    dead, {n: tuple(self.nodes[n].bucket_ids) for n in dead},
                    self._gather(), total=len(dead) == self.n_nodes,
                    durable_hint=(self.durability.newest_durable()
                                  if self.durability is not None
                                  else None)) from err
            return self._gather()

    def _gather(self) -> dict:
        params: dict = {}
        mu: dict = {}
        nu: dict = {}
        steps = []
        for node in self.nodes:
            if node.node_id in self.dead_nodes:
                continue
            p, m, v, step = node.snapshot()
            params.update(p)
            mu.update(m)
            nu.update(v)
            steps.append(step)
        return {"params": params, "mu": mu, "nu": nu,
                "step": min(steps, default=0)}

    def stats(self) -> ShadowStats:
        count = sum(n.apply_count for n in self.nodes)
        total = sum(n.apply_total_s for n in self.nodes)
        live = [n.step for n in self.nodes if n.node_id not in self.dead_nodes]
        applied = min(live, default=0)
        return ShadowStats(
            steps_applied=applied,
            lag=self.train_step_seen - applied,
            max_queue_depth=self.max_queue_depth,
            mean_apply_s=total / count if count else 0.0,
            max_apply_s=max((n.apply_max_s for n in self.nodes), default=0.0),
            per_node_apply_s=[n.apply_total_s / n.apply_count
                              if n.apply_count else 0.0 for n in self.nodes],
            lag_waits=self.lag_waits,
            lag_wait_s=self.lag_wait_s_total,
            batched_applies=self.batched_applies,
            max_batch=self.max_batch)

    def shutdown(self):
        if self.durability is not None:
            self.durability.close()
        if self.async_mode:
            for q in self._queues:
                q.put(None)
            for t in self._workers:
                t.join(timeout=30)
            self._queues, self._workers, self._drained = [], [], []
            self._lag_cvs = []
            self.async_mode = False


def plan_shadow_nodes(layout: BucketLayout, opt: OptimizerConfig,
                      iter_time_s: float, trial_tree: dict,
                      max_nodes: int = 16, device=None) -> tuple[int, float]:
    """Paper §4.2.4: 'Before starting training, Checkmate profiles shadow
    nodes and configures the system for optimal performance.'

    Measures one full-tree apply on one node on ``device`` (a gradient
    delivered through an `InProcessChannel`, as the main path delivers
    one) and returns the least node count whose per-node apply fits in an
    iteration, with the measured single-node apply seconds.
    """
    from repro_torch.core.channel import InProcessChannel, StepEvent
    cluster = ShadowCluster(layout, opt, n_nodes=1, device=device)
    dev = cluster.device
    zeros = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
             for k, v in trial_tree.items()}
    cluster.bootstrap(zeros, zeros, zeros, 0)
    del zeros
    grads = {k: torch.ones(v.shape, dtype=torch.float32, device=dev)
             for k, v in trial_tree.items()}
    chan = InProcessChannel()
    chan.open(layout)

    def deliver(step):
        chan.send(StepEvent(step=step, grads=grads, lr=1e-3))
        for d in chan.poll():
            cluster.on_delivery(d)

    deliver(1)                                # warm-up
    t0 = time.perf_counter()
    deliver(2)
    t1 = time.perf_counter() - t0
    cluster.shutdown()
    need = max(1, math.ceil(t1 / max(iter_time_s, 1e-9)))
    return min(need, max_nodes), t1
