"""Shadow cluster (paper §4.2): replicas that turn captured gradients into
per-iteration checkpoints — the port of ``repro.core.shadow``, flat path.

Each node owns a byte-balanced set of gradient buckets (§4.2.4) and keeps
params, mu and nu for exactly those buckets as per-bucket flat buffers on
its ``device``, in the layout deliveries arrive in. An apply is one fused
AdamW launch per bucket, updating the node's buffers in place under
``state_lock`` (the JAX package donates them to a jit instead), with the
same host-computed f32 scalars as the trainer, so the two states are
bit-identical.

On the card every node runs on a CUDA stream of its own, so its applies
overlap the trainer's kernels; a delivery's host flats are copied in with
``non_blocking=True`` from pinned memory. Async mode runs one worker
thread per node. A worker whose apply raises loses its node: consolidation
then raises `ShadowNodeLoss` naming exactly that node's buckets.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.buckets import (BucketLayout, alloc_flat, bucket_dtype,
                                      pack_bucket_into, unpack_bucket)
from repro_torch.core.channel import Delivery
from repro_torch.core.multicast import assign_buckets
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.optim.functional import OptimizerConfig


class ConsolidationTimeout(RuntimeError):
    """Consolidation hit its deadline with shadow nodes still applying.
    ``partial`` is apply-atomic per node, at the slowest node's step."""

    def __init__(self, lagging_nodes: list[int], partial: dict):
        super().__init__(f"shadow consolidation timed out; lagging nodes: "
                         f"{lagging_nodes} (partial checkpoint at step "
                         f"{partial.get('step')})")
        self.lagging_nodes = lagging_nodes
        self.partial = partial


class ShadowNodeLoss(RuntimeError):
    """Consolidation found lost shadow nodes: their partitions are gone.
    ``missing_buckets`` is exactly the lost nodes' bucket ids."""

    def __init__(self, dead_nodes: list[int], missing_buckets: dict,
                 partial: dict):
        super().__init__(f"shadow node(s) {dead_nodes} lost; missing "
                         f"buckets: {missing_buckets} (partial checkpoint at "
                         f"step {partial.get('step')})")
        self.dead_nodes = list(dead_nodes)
        self.missing_buckets = dict(missing_buckets)
        self.partial = partial


def _as_tensor(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t.to(device).contiguous()


class ShadowNode:
    """One shadow node: its buckets' state as flat buffers + fused AdamW."""

    def __init__(self, node_id: int, opt: OptimizerConfig,
                 layout: BucketLayout, bucket_ids: list[int],
                 device: torch.device):
        self.node_id = node_id
        self.opt = opt
        self.layout = layout
        self.device = device
        self.bucket_ids = sorted(bucket_ids)
        self._by_id = {b.bucket_id: b for b in layout.buckets}
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._pf: dict[int, torch.Tensor] = {}
        self._mf: dict[int, torch.Tensor] = {}
        self._vf: dict[int, torch.Tensor] = {}
        self.step = 0
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

    def bootstrap(self, params, mu, nu, step: int):
        """Install the replica: leaf trees -> this node's flat buffers."""
        self._after_caller()
        pf, mf, vf = {}, {}, {}
        with self._on_stream():
            for bid in self.bucket_ids:
                b = self._by_id[bid]
                names = [s.name for s in b.slots]
                for src, dst, dt in ((params, pf, bucket_dtype(b)),
                                     (mu, mf, "float32"), (nu, vf, "float32")):
                    leaves = {n: _as_tensor(src[n], self.device)
                              for n in names}
                    dst[bid] = pack_bucket_into(
                        b, leaves, alloc_flat(b.size, dt, self.device))
            self._sync()
        with self.state_lock:
            self._pf, self._mf, self._vf = pf, mf, vf
            self.step = int(step)

    def snapshot(self) -> tuple[dict, dict, dict, int]:
        """Apply-atomic (params, mu, nu, step) host leaf trees."""
        with self.state_lock, self._on_stream():
            pf = {bid: t.to("cpu") for bid, t in self._pf.items()}
            mf = {bid: t.to("cpu") for bid, t in self._mf.items()}
            vf = {bid: t.to("cpu") for bid, t in self._vf.items()}
            step = self.step
        params, mu, nu = {}, {}, {}
        for bid in self.bucket_ids:
            b = self._by_id[bid]
            params.update(unpack_bucket(b, pf[bid]))
            mu.update(unpack_bucket(b, mf[bid]))
            nu.update(unpack_bucket(b, vf[bid]))
        return params, mu, nu, step

    def apply(self, step: int, lr: float, flats: dict,
              grad_scale: float = 1.0):
        """One iteration's gradients for this node's buckets: one fused
        AdamW launch per bucket, in place."""
        t0 = time.perf_counter()
        s = self.opt.scalars(step, lr)
        if any(flats[bid].device.type == "cuda" for bid in self.bucket_ids):
            self._after_caller()
        with self.state_lock, self._on_stream():
            for bid in self.bucket_ids:
                g = flats[bid].to(self.device, non_blocking=True)
                ops.fused_adamw_(self._pf[bid], g, self._mf[bid],
                                 self._vf[bid], s, grad_scale)
            # the pinned host flats must outlive their copies: wait here
            self._sync()
            self.step = step
        dt = time.perf_counter() - t0
        self.apply_count += 1
        self.apply_total_s += dt
        self.apply_max_s = max(self.apply_max_s, dt)


@dataclass
class ShadowStats:
    steps_applied: int
    lag: int                       # training step - shadow step
    max_queue_depth: int
    mean_apply_s: float
    max_apply_s: float
    per_node_apply_s: list[float]


class ShadowCluster:
    """Checkmate's shadow plane: N nodes x partitioned fused AdamW."""

    def __init__(self, layout: BucketLayout, opt: OptimizerConfig,
                 n_nodes: int = 1, async_mode: bool = False, device=None):
        self.device = resolve(device)
        if opt.name != "adamw":
            raise NotImplementedError(f"optimizer {opt.name!r} is not "
                                      "ported; only adamw")
        self.layout = layout
        self.opt = opt
        self.n_nodes = n_nodes
        self.assignment = assign_buckets(layout, n_nodes)
        self.nodes = [
            ShadowNode(i, opt, layout,
                       [b for b, n in self.assignment.items() if n == i],
                       self.device)
            for i in range(n_nodes)]
        self.async_mode = async_mode
        self.train_step_seen = 0
        self.max_queue_depth = 0
        self.dead_nodes: set[int] = set()
        self.errors: dict[int, BaseException] = {}
        self._queues: list[queue.Queue] = []
        self._drained: list[threading.Event] = []
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
                self._workers.append(t)

    # -- async plumbing --------------------------------------------------------
    def _worker(self, node: ShadowNode, q: queue.Queue,
                drained: threading.Event):
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                drained.set()
                return
            try:
                if node.node_id not in self.dead_nodes:
                    node.apply(*item)
            except Exception as e:      # the node is lost; keep draining
                self.errors[node.node_id] = e
                self.dead_nodes.add(node.node_id)
            finally:
                q.task_done()
                with q.mutex:
                    if q.unfinished_tasks == 0:
                        drained.set()

    @staticmethod
    def _pending(q: queue.Queue) -> int:
        with q.mutex:
            return q.unfinished_tasks

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
        nodes). Queued applies finish first; the install supersedes them."""
        if self.async_mode:
            self._wait_drained(time.monotonic() + 60.0)
        self.dead_nodes.clear()
        self.errors.clear()
        for node in self.nodes:
            node.bootstrap(params, mu, nu, step)
        self.train_step_seen = int(step)

    def on_delivery(self, delivery: Delivery):
        """Consume one complete channel delivery (the only gradient
        ingress); a gated one is refused."""
        if not delivery.complete or delivery.flats is None:
            raise ValueError(f"refusing gated delivery for step "
                             f"{delivery.step}: capture incomplete")
        step, flats = delivery.step, delivery.flats
        self.train_step_seen = step
        live = [n for n in self.nodes if n.node_id not in self.dead_nodes]
        for node in live:
            sub = {bid: flats[bid] for bid in node.bucket_ids}
            item = (step, delivery.lr, sub, delivery.grad_scale)
            if not self.async_mode:
                node.apply(*item)
                continue
            q = self._queues[node.node_id]
            self._drained[node.node_id].clear()
            q.put(item)
            self.max_queue_depth = max(self.max_queue_depth,
                                       self._pending(q))

    def consolidate(self, timeout: Optional[float] = None) -> dict:
        """Gather a full checkpoint from the nodes' partitions, waiting up
        to ``timeout`` seconds (default 60) for queued applies.

        Raises `ConsolidationTimeout` if a live node is still behind at the
        deadline and `ShadowNodeLoss` if any node was lost.
        """
        if self.async_mode:
            lagging = self._wait_drained(
                time.monotonic() + (60.0 if timeout is None else timeout))
            if lagging:
                raise ConsolidationTimeout(lagging, self._gather())
        if self.dead_nodes:
            dead = sorted(self.dead_nodes)
            err = next((self.errors[n] for n in dead if n in self.errors),
                       None)
            raise ShadowNodeLoss(
                dead, {n: tuple(self.nodes[n].bucket_ids) for n in dead},
                self._gather()) from err
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
                              if n.apply_count else 0.0 for n in self.nodes])

    def shutdown(self):
        if self.async_mode:
            for q in self._queues:
                q.put(None)
            for t in self._workers:
                t.join(timeout=30)
            self._queues, self._workers, self._drained = [], [], []
            self.async_mode = False
